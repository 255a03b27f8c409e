"""Encoder, packing and sentiment head of the port (mirrors :mod:`svoc_tpu.models`)."""
