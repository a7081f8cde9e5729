"""Attention for the port: the plain path and the flash-attention kernel."""
