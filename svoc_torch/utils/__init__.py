"""Utilities of the port (mirrors :mod:`svoc_tpu.utils`)."""
