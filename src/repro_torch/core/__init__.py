"""Compressors, the optimizer substrate and aggregation state."""
