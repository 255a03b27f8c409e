"""svoclint, the port's own lint gate over ``svoc_torch``.

The port of :mod:`svoc_tpu.analysis` (14 modules), run as
``python -m svoc_torch.tools.svoclint``.  The dispatch paths of the port
stay fast only while their launch loops stay free of host syncs, their
replays deterministic and their durable writes ordered; these rules
check that before merge, as the reference's check its JAX paths.  The
port keeps the reference's 17 rules and SVOC000, with the same IDs,
severities, docs, messages and suppression syntax; only three tables
know the port's spellings of the same hazards: SVOC001's host syncs
(``.cpu()``, ``.numpy()``, ``.tolist()``, ``.synchronize()``), SVOC017's
collectives (``svoc_torch.parallel.sharded``'s), and the traced bodies,
whose ``shard_map`` table already matches the port's.

Pure ``ast`` + ``tokenize`` — analyzing the package imports neither JAX
nor torch (nor anything from the analyzed modules), so the lint runs on
a CPU-only box in seconds.

Rules (docs/STATIC_ANALYSIS.md has bad/good examples for each):

- **SVOC001 host-sync-in-hot-path** — ``.item()`` / ``float()`` /
  ``np.asarray`` / ``jax.device_get`` / ``block_until_ready`` inside a
  jit body or a dispatch-path ``stage_span(...)`` body.
- **SVOC002 impure-jit-body** — print / logging / metrics-registry
  observation / ``global`` / ``self`` mutation inside a traced body.
- **SVOC003 recompile-hazard** — ``jax.jit`` built inside a loop,
  f-string / dict-literal args to jitted callees, shape-derived Python
  scalars at non-static positions.
- **SVOC004 donation-reuse** — an argument used after being passed
  through ``donate_argnums``.
- **SVOC005 fixed-point-contract** — float literals / ``astype(float)``
  / true division / foreign Q-scales inside wsad integer paths.
- **SVOC006 unlocked-shared-state** — module-level mutable state
  mutated without a lock in the thread-entry modules.
- **SVOC007 event-in-traced-body** — flight-recorder emission
  (``emit_event`` / ``journal.emit``) inside a jit-traced body; events
  are host-side only (``svoc_torch/utils/events.py``).

Interprocedural rules (``callgraph.py`` resolves module-qualified
defs/calls package-wide, ``concurrency.py`` models lock acquisition;
``interrules.py`` holds the rules; findings carry a ``path_trace``
naming the call chain that justifies them):

- **SVOC008 wall-clock-in-fingerprinted-path** — ``time.time()`` &
  friends reachable from journal-emit data or fingerprint derivation.
- **SVOC009 process-randomized-draw** — ``hash()`` / unseeded
  ``random.*`` / set iteration in seed/key/fingerprint paths.
- **SVOC010 emit-under-lock** — ``journal.emit`` reachable while a
  non-journal lock is held (the leaf-lock contract), plus
  lock-acquisition cycles.
- **SVOC011 unpinned-replay-knob** — env/PERF_DECISIONS knob reads
  reachable from step/dispatch/fetch bodies instead of ``__init__``.
- **SVOC012 durability-ordering** — rename without directory fsync;
  durability-path writes without fsync.

Contract-plane rules (``statecov.py``, ``emissions.py``, ``taint.py``,
``shardspec.py``, plus SVOC014 in ``interrules.py``; each joins the
code against an operator-facing promise, in both directions where one
exists):

- **SVOC013 snapshot-coverage** — mutable replay-class ``self.*``
  state the durable serializers never read; deliberate transients
  carry audited ``# svoc: volatile(<reason>)`` annotations, and a
  stale annotation is itself a finding.
- **SVOC014 silent-fallback** — except/degrade handlers reachable
  from step/commit/serving entries that neither re-raise, read the
  exception, bump a metric, nor emit an event.
- **SVOC015 emission-taxonomy-sync** — two-way join of emitted event
  types / metric families against docs/OBSERVABILITY.md's tables.
- **SVOC016 fingerprint-taint** — intraprocedural dataflow from
  nondeterminism sources into journal-emit data or fingerprint
  returns (the two-line form SVOC008's reachability misses).
- **SVOC017 shard-spec-consistency** — PartitionSpec / collective
  axis names no ``*_AXIS`` constant defines, and any collective
  inside the exact-parity claim-cube bodies.

Entry points: :func:`svoc_torch.analysis.engine.analyze_paths` (the CLI
``svoc_torch/tools/svoclint.py`` wraps it, with a
``.svoclint_torch_cache.json`` content-hash cache so warm runs never
re-parse unchanged files) and
:func:`svoc_torch.analysis.engine.analyze_source` (what the tests feed
fixture snippets through).
"""

from svoc_torch.analysis.findings import Baseline, Finding, suggest_rebase
from svoc_torch.analysis.engine import (
    AnalysisReport,
    analyze_paths,
    analyze_source,
    iter_python_files,
)
from svoc_torch.analysis.rules import ALL_RULES, RULE_DOCS

__all__ = [
    "ALL_RULES",
    "AnalysisReport",
    "Baseline",
    "Finding",
    "RULE_DOCS",
    "analyze_paths",
    "analyze_source",
    "iter_python_files",
    "suggest_rebase",
]
