"""SVOC017 — shard-spec consistency: specs, collectives, and the mesh.

The sharding plane has exactly one source of truth for axis names: the
``*_AXIS`` string constants of ``parallel/mesh.py`` (``CLAIM_AXIS``,
``ORACLE_AXIS``, ``DATA_AXIS``, ``MODEL_AXIS``, ``REPLICA_AXIS``).  A
``PartitionSpec`` or collective naming any other axis shards nothing —
jax raises at dispatch time, on hardware, long after the review that
should have caught the typo (the premise of Automatic Cross-Replica
Sharding: partition consistency is STATICALLY checkable).  Three
checks:

- **spec axes** — every string axis in a ``P(...)`` /
  ``PartitionSpec(...)`` construction must be a known ``*_AXIS`` value.
  Bare-Name axes resolve through module constants and imports back to
  the mesh constants; unresolvable tokens are skipped
  (under-approximate — a variable axis is the caller's contract).
- **collective axes** — same check for the ``axis_name`` of
  ``jax.lax`` collectives (``psum``/``all_gather``/``axis_index``/…).
- **exact-parity bodies** — the claim-cube bodies of
  ``parallel/claim_shard.py`` (``_host_cube_body*``,
  ``_pallas_claims_body*``) are the repo's bit-exact-parity surface
  (docs/PARALLELISM.md §sharded-claims): each shard computes its
  claims independently and the outputs are compared ULP-for-ULP
  against the unsharded reference.  ANY collective inside them is an
  error — cross-shard communication inside the parity body is exactly
  the one-ulp-drift bug class, machine-pinned.

The port's copy of :mod:`svoc_tpu.analysis.shardspec`
(``shardspec.py:1-180``).  One table differs: a collective is a
``jax.lax`` one or one of the port's single-controller mesh,
``svoc_torch.parallel.sharded``'s ``axis_index``, ``axis_size``,
``all_gather``, ``psum`` and ``ppermute`` (``sharded.py:156-223``), named
through an import of that module or of the name itself.  The port's
``P`` (``parallel/mesh.py``) is a spec by its leaf, as ``jax``'s is.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from svoc_torch.analysis.callgraph import ModuleSummary, Program
from svoc_torch.analysis.findings import Finding

#: Function-qual prefixes of the exact-parity claim-cube bodies.
PARITY_BODY_PREFIXES = ("_host_cube_body", "_pallas_claims_body")
PARITY_MODULE_SUFFIX = "parallel/claim_shard.py"


def _axis_universe(program: Program) -> Dict[str, Tuple[str, str]]:
    """``axis value -> (defining module, constant name)`` over every
    module-level ``*_AXIS = "..."`` constant (canonical home:
    ``parallel/mesh.py``)."""
    universe: Dict[str, Tuple[str, str]] = {}
    for module in program.modules.values():
        for name, value in module.consts.items():
            if name.endswith("_AXIS"):
                universe.setdefault(value, (module.path, name))
    return universe


def _resolve_axis_token(
    kind: str, value: str, module: ModuleSummary, program: Program
) -> Optional[str]:
    """Axis-name string for one ``[kind, value]`` token, or None when
    unresolvable (skipped)."""
    if kind == "lit":
        return value
    if kind != "name":
        return None
    if value in module.consts:
        return module.consts[value]
    target = module.imports.get(value)
    if target and "." in target:
        mod_dotted, _, leaf = target.rpartition(".")
        mpath = program.by_dotted.get(mod_dotted)
        if mpath is not None:
            return program.modules[mpath].consts.get(leaf)
    return None


def _is_partition_spec(func_name: str, module: ModuleSummary) -> bool:
    if func_name.endswith("PartitionSpec"):
        return True
    return module.imports.get(func_name, "").endswith("PartitionSpec")


#: The port's mesh collectives: the module and the leaves it defines.
PORT_COLLECTIVE_MODULE = "svoc_torch.parallel.sharded"
PORT_COLLECTIVE_LEAVES = {"axis_index", "axis_size", "all_gather", "psum", "ppermute"}


def _is_port_collective(name: str, leaf: str, module: ModuleSummary) -> bool:
    """``psum(...)`` imported from the port's ``parallel/sharded.py``, or
    ``sharded.psum(...)`` through an alias of that module."""
    if leaf not in PORT_COLLECTIVE_LEAVES:
        return False
    head, _, tail = name.partition(".")
    target = module.imports.get(head, "")
    if tail:
        return tail == leaf and target == PORT_COLLECTIVE_MODULE
    return target == f"{PORT_COLLECTIVE_MODULE}.{leaf}"


def _is_lax_collective(name: str, leaf: str, module: ModuleSummary) -> bool:
    if _is_port_collective(name, leaf, module):
        return True
    if name.startswith("lax.") or ".lax." in f".{name}":
        head = name.split(".", 1)[0]
        target = module.imports.get(head, head)
        return target in ("jax", "jax.lax") or target.startswith("jax.")
    return module.imports.get(name or leaf, "").startswith("jax.lax.")


def rule_svoc017(program: Program, ctx) -> List[Finding]:
    universe = _axis_universe(program)
    if not universe:
        # No *_AXIS constants in the analyzed set (a subset run without
        # parallel/mesh.py): an empty universe proves nothing — skip
        # rather than flag every axis in sight.
        return []
    out: List[Finding] = []
    known = ", ".join(sorted(universe))
    for module in program.modules.values():
        parity_module = module.path.endswith(PARITY_MODULE_SUFFIX)
        for fs in module.functions:
            for spec in fs.specs:
                if not _is_partition_spec(spec.get("func", ""), module):
                    continue
                for kind, value in spec.get("axes", ()):
                    axis = _resolve_axis_token(kind, value, module, program)
                    if axis is None or axis in universe:
                        continue
                    out.append(
                        ctx.finding(
                            "SVOC017",
                            module.path,
                            int(spec["line"]),
                            f"PartitionSpec in `{fs.qual}` names axis "
                            f"`{axis}`, which no mesh factory defines "
                            f"(known axes: {known}) — the spec shards "
                            "nothing and jax raises at dispatch time",
                            "use the *_AXIS constants from "
                            "parallel/mesh.py (never string literals "
                            "that can drift from the mesh)",
                            trace=(
                                f"{module.path}::{fs.qual}:{spec['line']} "
                                f"spec axis `{axis}`",
                                "axis universe: parallel/mesh.py *_AXIS "
                                f"constants = {{{known}}}",
                            ),
                        )
                    )
            for coll in fs.collectives:
                if not _is_lax_collective(
                    coll.get("name", ""), coll.get("leaf", ""), module
                ):
                    continue
                line = int(coll["line"])
                leaf = coll.get("leaf", "")
                if parity_module and any(
                    fs.qual.startswith(p) for p in PARITY_BODY_PREFIXES
                ):
                    out.append(
                        ctx.finding(
                            "SVOC017",
                            module.path,
                            line,
                            f"collective `{leaf}` inside exact-parity "
                            f"claim-cube body `{fs.qual}` — the parity "
                            "contract is per-shard independence "
                            "(docs/PARALLELISM.md §sharded-claims); "
                            "cross-shard communication here is the "
                            "one-ulp-drift bug class",
                            "move the collective to the fleet cube "
                            "(`_fleet_cube_body`) or outside the "
                            "shard_map; the claim cube must stay "
                            "communication-free",
                            trace=(
                                f"{module.path}::{fs.qual}:{line} "
                                f"`{leaf}` in a parity body",
                            ),
                        )
                    )
                    continue
                for kind, value in coll.get("axes", ()):
                    axis = _resolve_axis_token(kind, value, module, program)
                    if axis is None or axis in universe:
                        continue
                    out.append(
                        ctx.finding(
                            "SVOC017",
                            module.path,
                            line,
                            f"collective `{leaf}` in `{fs.qual}` names "
                            f"axis `{axis}`, which no mesh factory "
                            f"defines (known axes: {known})",
                            "use the *_AXIS constants from "
                            "parallel/mesh.py",
                            trace=(
                                f"{module.path}::{fs.qual}:{line} "
                                f"`{leaf}` over axis `{axis}`",
                                "axis universe: parallel/mesh.py *_AXIS "
                                f"constants = {{{known}}}",
                            ),
                        )
                    )
    return out
