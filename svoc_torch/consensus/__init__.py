"""Consensus math of the port (mirrors :mod:`svoc_tpu.consensus`)."""
