"""The port's tools: the on-card probes and the smoke gates (twins of the
JAX package's ``tools/``)."""
