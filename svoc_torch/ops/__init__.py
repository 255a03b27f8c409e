"""Operators and kernel wrappers of the port (mirrors :mod:`svoc_tpu.ops`)."""
