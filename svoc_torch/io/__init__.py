"""Comment sources of the port (mirrors :mod:`svoc_tpu.io`)."""
