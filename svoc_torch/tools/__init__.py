"""The port's on-card probe tools (the JAX package's live in ``tools/``)."""
