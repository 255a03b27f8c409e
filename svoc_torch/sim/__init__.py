"""Oracle fleet model of the port (mirrors :mod:`svoc_tpu.sim`)."""
