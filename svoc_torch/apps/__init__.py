"""Application layer (the port's counterpart of :mod:`svoc_tpu.apps`)."""
