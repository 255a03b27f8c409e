"""The identity of one claim-cube dispatch, and the universe of them.

Mirrors :mod:`svoc_tpu.compile.universe` (``universe.py:1-283``:
``KINDS``, ``CompileKey``, ``dispatch_key``, ``registry_groups``,
``bucket_ladder``, ``enumerate_universe``, ``pending_universe``,
``universe_summary``).  A dispatch is keyed on its claim bucket, its
``(n_oracles, dimension, consensus config)`` group, its kind, the donate
twin, the impl and the mesh; everything else the router varies a cycle
is data.  The router's warmth accounting
(``consensus_dispatch{warmth=}``), the cost ledger's cells and the
prewarm worker (:mod:`svoc_torch.compile.prewarm`) all key on it.

The enumeration derives the reachable keys from live configuration: the
groups from the registry's unpaused claims, the buckets from every power
of two up to the router's ``max_claims_per_batch``, the kind and impl
from the router's construction-pinned resolution.  Order is priority:
the bucket each group's current claim count dispatches first, then the
rest of the ladder ascending, then the twins, so that a budgeted walk
cuts from the tail.

The port's impl is the route (``"cuda"`` or ``"plain"``, the router's
``consensus_impl``).  Its twins are the reference's: the other gate
fusion (``gated`` beside ``sanitized``) and the donate flip.  In the
port ``donate=True`` keys the dispatch that reads a group's persistent
staging tensor (``ClaimRouter(device_resident=True)``,
:class:`svoc_torch.fabric.router._GroupStaging`).  Given the same
groups and flags, the two enumerations give the same keys in the same
order.  A router with a claim mesh dispatches the ``sharded_*`` kinds,
labelled ``@<claims>x<oracles>``, over a ladder of buckets padded to a
multiple of the mesh's claim axis; as in the reference they have no
twins (the sharded dispatch never donates, and warms no gate variant
its mesh was not built for).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from svoc_torch.consensus.batch import pow2_bucket
from svoc_torch.consensus.kernel import ConsensusConfig

#: The dispatch kinds: ``gated`` is the pull-mode router's dispatch (the
#: host gate's verdicts on the device), ``sanitized`` the serving tier's
#: gate and consensus in one pass; the ``sharded_*`` twins run in the
#: claim mesh (:mod:`svoc_torch.parallel.claim_shard`).
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


def registry_groups(registry) -> Dict[Tuple[int, int, ConsensusConfig], int]:
    """Live (N, M, cfg) dispatch groups → unpaused claim count, the
    grouping ``ClaimRouter._step_inner`` builds each cycle."""
    groups: Dict[Tuple[int, int, ConsensusConfig], int] = {}
    for state in registry.states():
        if state.paused:
            continue
        spec = state.spec
        key = (spec.n_oracles, spec.dimension, spec.consensus_config())
        groups[key] = groups.get(key, 0) + 1
    return groups


def bucket_ladder(cap: int, *, floor: int = 1, multiple_of: int = 1) -> List[int]:
    """Every bucket the router can dispatch for up to ``cap`` claims:
    power-of-two buckets ascending, deduplicated."""
    if cap < 1:
        raise ValueError("cap must be >= 1")
    out: List[int] = []
    n = 1
    while True:
        bucket = pow2_bucket(n, floor=floor, multiple_of=multiple_of)
        if bucket not in out:
            out.append(bucket)
        if n >= cap:
            break
        n *= 2
    return out


def enumerate_universe(
    groups: Dict[Tuple[int, int, ConsensusConfig], int],
    *,
    max_claims_per_batch: int,
    sanitized_dispatch: bool,
    impl: str,
    donate: bool = False,
    mesh: Optional[str] = None,
    mesh_claim_size: int = 1,
    include_twins: bool = True,
) -> List[CompileKey]:
    """The priority-ordered universe of one router's live configuration.
    ``groups`` is :func:`registry_groups`' output; the flags are the
    router's pinned resolution (``donate`` is its ``device_resident``,
    ``mesh`` its ``mesh_spec`` and ``mesh_claim_size`` the mesh's claim
    axis).  Phases: (1) per group, the bucket its current claim count
    dispatches; (2) the rest of the ladder; (3) with ``include_twins``
    and no mesh, at every bucket the other gate fusion, the donate flip,
    and both flipped (``universe.py:153-231``), so that a restart that
    flips ``sanitized_dispatch`` or ``device_resident`` restarts warm
    too."""
    sharded = mesh is not None
    multiple = mesh_claim_size if sharded else 1
    ordered = sorted(groups.items(), key=lambda kv: (kv[0][0], kv[0][1], repr(kv[0][2])))
    ladder = bucket_ladder(max_claims_per_batch, multiple_of=multiple)

    def key(group, bucket, sanitized, donate_flag) -> CompileKey:
        n, m, cfg = group
        return dispatch_key(sanitized=sanitized, sharded=sharded, bucket=bucket, n_oracles=n,
                            dimension=m, cfg=cfg, donate=donate_flag and not sharded, impl=impl, mesh=mesh)

    out: List[CompileKey] = []
    seen = set()

    def push(k: CompileKey) -> None:
        if k not in seen:
            seen.add(k)
            out.append(k)

    for group, count in ordered:
        push(key(group, pow2_bucket(max(1, min(count, max_claims_per_batch)), multiple_of=multiple),
                 sanitized_dispatch, donate))
    for group, _count in ordered:
        for bucket in ladder:
            push(key(group, bucket, sanitized_dispatch, donate))
    if include_twins and not sharded:
        for group, _count in ordered:
            for bucket in ladder:
                push(key(group, bucket, not sanitized_dispatch, donate))
                push(key(group, bucket, sanitized_dispatch, not donate))
                push(key(group, bucket, not sanitized_dispatch, not donate))
    return out


def pending_universe(
    specs,
    *,
    max_claims_per_batch: int,
    sanitized_dispatch: bool,
    impl: str,
    donate: bool = False,
    mesh: Optional[str] = None,
    mesh_claim_size: int = 1,
    include_twins: bool = False,
) -> List[CompileKey]:
    """The universe of a configuration that is not live yet: the groups
    come from ``specs`` (:class:`~svoc_torch.fabric.registry.ClaimSpec`)
    instead of a registry, the mesh is the pending one.  Twins default
    off: a transition warms the configuration it goes to."""
    groups: Dict[Tuple[int, int, ConsensusConfig], int] = {}
    for spec in specs:
        key = (spec.n_oracles, spec.dimension, spec.consensus_config())
        groups[key] = groups.get(key, 0) + 1
    return enumerate_universe(groups, max_claims_per_batch=max_claims_per_batch,
                              sanitized_dispatch=sanitized_dispatch, impl=impl,
                              donate=donate, mesh=mesh, mesh_claim_size=mesh_claim_size,
                              include_twins=include_twins)


def universe_summary(keys: Iterable[CompileKey]) -> Dict[str, object]:
    """JSON-safe digest of a universe: its size, keys a kind, buckets and groups."""
    keys = list(keys)
    kinds: Dict[str, int] = {}
    for k in keys:
        kinds[k.kind] = kinds.get(k.kind, 0) + 1
    return {
        "keys": len(keys),
        "kinds": kinds,
        "buckets": sorted({k.bucket for k in keys}),
        "groups": len({k.group() for k in keys}),
    }
