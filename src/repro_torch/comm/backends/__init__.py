"""Transports of the payload exchange."""
