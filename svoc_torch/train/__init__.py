"""Fine-tuning of the port's encoder (mirrors :mod:`svoc_tpu.train`)."""
