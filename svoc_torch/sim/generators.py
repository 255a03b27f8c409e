"""Seeds for the multi-claim fabric.

Mirrors :func:`svoc_tpu.sim.generators.claim_seed`
(``generators.py:26-45``), bit for bit.  The beta, Kumaraswamy and
Gaussian fleet generators of that module are not ported yet: they wait
for the threefry port (ROADMAP A item 2).
"""

from __future__ import annotations

import zlib


def claim_seed(base_seed: int, claim_id) -> int:
    """Per-claim seed: ``zlib.crc32(repr(claim_id))`` (not ``hash()``,
    which Python randomizes per process) mixed with the base seed by a
    polynomial and folded to 32 bits.  A pure function of ``(base_seed,
    claim_id)``, so N claims sharing one base seed get independent,
    replayable oracle streams."""
    crc = zlib.crc32(repr(claim_id).encode())
    mixed = (int(base_seed) * 1_000_003 + crc) & 0xFFFFFFFFFFFFFFFF
    return ((mixed >> 32) ^ mixed) & 0xFFFFFFFF
