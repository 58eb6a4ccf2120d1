"""Model configuration and the dense decoder."""
