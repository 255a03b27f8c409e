"""The compile plane (the port's counterpart of :mod:`svoc_tpu.compile`):
so far the dispatch keys of :mod:`svoc_torch.compile.universe`; the
universe's enumeration, the prewarm worker and the kernel cache wait for
ROADMAP A10b."""
