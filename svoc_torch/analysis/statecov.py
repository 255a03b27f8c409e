"""SVOC013 — snapshot-coverage: replay-relevant state the serializers miss.

The durability contract (docs/RESILIENCE.md §durability) is that a
kill + recover round-trip loses NOTHING the fabric needs to continue:
``utils/checkpoint.py`` serializes it, ``durability/recovery.py``
restores it.  That plane was built by hand-enumerating every field —
which means every later PR that adds a mutable field to a
replay-relevant class silently re-opens the gap until a review notices.

This rule closes the loop mechanically:

- **replay-relevant classes** — the fixed set the snapshot plane
  covers (:data:`REPLAY_CLASSES`): ``Session``, ``ClaimRouter``,
  ``ServingTier``, ``ServingFrontend``, ``FleetHealthSupervisor``,
  ``CircuitBreaker``, ``CostLedger``.
- **mutation** — a ``self.<attr> = ...`` (or augmented) assignment in
  any method OTHER than ``__init__``: state that changes over the
  process lifetime, so a restore that drops it rewinds the fabric.
- **coverage** — the union of attribute names touched by any function
  in the serializer modules (:data:`SERIALIZER_SUFFIXES`) or any
  function BFS-reachable from them through the resolved call graph
  (``tier.serving_state_dict()`` / ``plane.save_ledger()`` pull the
  class-owned snapshot methods into the walk).  Name-level matching is
  deliberately coarse: over-approximate coverage, under-approximate
  findings — the merge-gate polarity.
- **volatile annotation** — ``# svoc: volatile(<reason>)`` on a
  mutation line marks the field deliberately transient.  Annotations
  are AUDITED like baseline entries: one that no longer sits on an
  uncovered replay-class mutation (the field got serialized, renamed,
  or deleted) is itself a finding — stale claims rot into lies.

The rule only runs when at least one serializer module is in the
analyzed set (a ``--changed`` subset run must not flag every field of
a lone ``session.py`` just because the coverage walk has no roots).

The port's copy of :mod:`svoc_tpu.analysis.statecov` (``statecov.py:1-158``),
unchanged but for the package's name.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from svoc_torch.analysis.callgraph import Program
from svoc_torch.analysis.findings import Finding

#: The snapshot plane's entry modules (path suffixes, root-relative).
SERIALIZER_SUFFIXES = ("utils/checkpoint.py", "durability/recovery.py")

#: Classes whose instances the snapshot plane claims to cover
#: (docs/RESILIENCE.md §durability names each one's serialized fields).
REPLAY_CLASSES = {
    "Session",
    "ClaimRouter",
    "ServingTier",
    "ServingFrontend",
    "FleetHealthSupervisor",
    "CircuitBreaker",
    "CostLedger",
}


def _serializer_coverage(program: Program) -> Tuple[Set[str], List[str]]:
    """``(attribute-name universe, serializer root paths)`` — every
    attribute name touched by the serializer modules' functions or by
    anything reachable from them."""
    roots = sorted(
        m.path
        for m in program.modules.values()
        if m.path.endswith(SERIALIZER_SUFFIXES)
    )
    coverage: Set[str] = set()
    visited: Set[str] = set()
    queue: List[str] = []
    for path in roots:
        for fs in program.modules[path].functions:
            fid = f"{path}::{fs.qual}"
            if fid not in visited:
                visited.add(fid)
                queue.append(fid)
    while queue:
        fid = queue.pop()
        fs = program.funcs[fid]
        module = program.modules[program.module_of(fid)]
        coverage.update(fs.attrs)
        for call in fs.calls:
            target = program.resolve(module, call, fs)
            if target is not None and target not in visited:
                visited.add(target)
                queue.append(target)
    return coverage, roots


def rule_svoc013(program: Program, ctx) -> List[Finding]:
    coverage, roots = _serializer_coverage(program)
    if not roots:
        return []
    root_desc = ", ".join(roots)
    out: List[Finding] = []
    for module in program.modules.values():
        #: mutation sites per (class, attr), __init__ excluded
        mutations: Dict[Tuple[str, str], List[int]] = {}
        for fs in module.functions:
            if fs.cls not in REPLAY_CLASSES or fs.name == "__init__":
                continue
            for attr, line in fs.self_sets:
                mutations.setdefault((fs.cls, attr), []).append(int(line))
        consumed: Set[int] = set()
        for (cls_name, attr), sites in sorted(mutations.items()):
            if attr in coverage:
                continue
            annotated = [s for s in sites if s in module.volatile]
            if annotated:
                consumed.update(annotated)
                continue
            anchor = min(sites)
            site_list = ", ".join(str(s) for s in sorted(sites))
            out.append(
                ctx.finding(
                    "SVOC013",
                    module.path,
                    anchor,
                    f"mutable `self.{attr}` on replay-relevant "
                    f"`{cls_name}` is never read by the durable "
                    "serializers — a crash + recover silently resets it "
                    f"(assigned at line {site_list})",
                    "serialize + restore the field through the snapshot "
                    "plane (utils/checkpoint.py), or mark ONE mutation "
                    "site `# svoc: volatile(<why replay survives without "
                    "it>)`",
                    trace=(
                        f"{module.path}::{cls_name}.{attr} mutated at "
                        f"line {site_list}",
                        f"coverage roots: {root_desc}",
                        "attribute name unreached from any serializer "
                        "function",
                    ),
                )
            )
        for line, reason in sorted(module.volatile.items()):
            if line in consumed:
                continue
            out.append(
                ctx.finding(
                    "SVOC013",
                    module.path,
                    line,
                    "stale `# svoc: volatile(...)` annotation: line "
                    f"{line} is not an uncovered replay-class mutation "
                    "any more (field serialized, renamed, or moved) — "
                    f"recorded reason: {reason!r}",
                    "delete the annotation (stale claims fail like stale "
                    "baseline entries), or move it to the live mutation "
                    "site",
                    trace=(
                        f"{module.path}:{line} annotation without a "
                        "matching uncovered mutation",
                    ),
                )
            )
    return out
