"""Parallel forms of the encoder (mirrors :mod:`svoc_tpu.parallel`).

Only :mod:`svoc_torch.parallel.encoder_math` is ported, the functional
encoder math that the W8A8 forward runs on; the mesh, the sharded
consensus, serving, ring attention, the sequence-parallel encoder and
the pipeline wait for ROADMAP A12e.  Nothing is imported here.
"""
