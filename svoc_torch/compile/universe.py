"""The identity of one claim-cube dispatch.

Mirrors the key half of :mod:`svoc_tpu.compile.universe`
(``universe.py:35-112``: ``KINDS``, ``CompileKey``, ``dispatch_key``).  A
dispatch is keyed on its claim bucket, its ``(n_oracles, dimension,
consensus config)`` group, its kind, the donate twin, the impl and the
mesh; everything else the router varies a cycle is data.  The router's
warmth accounting (``consensus_dispatch{warmth=}``) and the cost
ledger's cells both key on it.  The enumeration of the reachable keys
(``registry_groups``, the universe) and the prewarm worker that walks it
wait for ROADMAP A10b.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from svoc_torch.consensus.kernel import ConsensusConfig

#: The dispatch kinds: ``gated`` is the pull-mode router's dispatch (the
#: host gate's verdicts on the device), ``sanitized`` the serving tier's
#: gate and consensus in one pass; the ``sharded_*`` twins run in the
#: claim mesh (ROADMAP A12).
KINDS = ("gated", "sanitized", "sharded_gated", "sharded_sanitized")


@dataclasses.dataclass(frozen=True)
class CompileKey:
    """One dispatch's identity, as the router dispatches it.  The
    sanitize bounds of a ``sanitized`` key are not part of it: they are a
    function of ``cfg.constrained``."""

    kind: str
    bucket: int
    n_oracles: int
    dimension: int
    cfg: ConsensusConfig
    donate: bool = False
    impl: str = "xla"
    mesh: Optional[str] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind {self.kind!r} is not one of {KINDS}")
        if self.bucket < 1:
            raise ValueError("bucket must be >= 1")

    def group(self) -> Tuple[int, int, ConsensusConfig]:
        """The router's (N, M, cfg) dispatch-group key."""
        return (self.n_oracles, self.dimension, self.cfg)

    def label(self) -> str:
        """Compact metrics label: ``gated:c8n7m6[+donate][@mesh]``."""
        suffix = "+donate" if self.donate else ""
        mesh = f"@{self.mesh}" if self.mesh else ""
        return f"{self.kind}:c{self.bucket}n{self.n_oracles}m{self.dimension}{suffix}{mesh}"


def dispatch_key(
    *,
    sanitized: bool,
    sharded: bool,
    bucket: int,
    n_oracles: int,
    dimension: int,
    cfg: ConsensusConfig,
    donate: bool,
    impl: str,
    mesh: Optional[str],
) -> CompileKey:
    """The key of ONE router dispatch, from the router's own flags."""
    kind = ("sharded_" if sharded else "") + ("sanitized" if sanitized else "gated")
    return CompileKey(
        kind=kind,
        bucket=bucket,
        n_oracles=n_oracles,
        dimension=dimension,
        cfg=cfg,
        donate=donate,
        impl=impl,
        mesh=mesh if sharded else None,
    )
