"""Bucketed EF communication layer (in-process EF world)."""
