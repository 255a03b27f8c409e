"""The serving tier (the port's counterpart of :mod:`svoc_tpu.serving`)."""
