"""SVOC008–SVOC015 + SVOC017: the interprocedural contract rules.

Package rules run AFTER the per-module pass, over the whole-program
view (:class:`svoc_torch.analysis.callgraph.Program`).  Each one encodes
a contract the repo states in prose and previously enforced only by
review:

- **SVOC008 wall-clock-in-fingerprinted-path** — ``time.time()`` &
  friends reachable from an ``emit(...)`` data argument or from a
  ``fingerprint*`` function.  Journal fingerprints must digest
  replay-stable payloads (``utils/events.py``: ``ts`` is *excluded*
  for exactly this reason); a clock smuggled in through a helper makes
  two seeded replays disagree byte-for-byte.
- **SVOC009 process-randomized-draw** — ``hash()``, unseeded
  ``random.*`` draws, or string-set iteration in seed/key/fingerprint
  derivation paths.  The repo's discipline is ``zlib.crc32`` +
  explicit PRNG keys (``sim/generators.claim_seed``); ``hash()`` is
  per-process randomized and set order follows it.
- **SVOC010 emit-under-lock / lock-order** — the journal-lock-is-a-
  LEAF contract: no path may reach ``journal.emit`` (whose
  subscribers run on the emitting thread) while a non-journal lock is
  held, and the acquisition-order graph must stay acyclic.
- **SVOC011 unpinned-replay-knob** — ``resolve_consensus_impl`` /
  ``resolve_claim_mesh`` / ``env_int`` / literal ``SVOC_*`` env reads
  reachable from step/dispatch/fetch bodies.  Replay config is pinned
  at construction (docs/FABRIC.md §replay); a per-step read lets the
  environment drift mid-run and the replay diverge.
- **SVOC012 durability-ordering** — ``os.replace``/``os.rename``
  with no reachable ``fsync``/``fsync_dir`` (the rename is metadata:
  until the directory entry is durable a crash resurrects the
  pre-rename layout), and durability-path file writes with no fsync
  (a WAL record is NO record until its bytes are on the platter).
- **SVOC014 silent-fallback** — defined here; an ``except``/degrade
  branch reachable from a dispatch/commit/serving/recovery entry that
  neither re-raises, increments a counter, nor emits a typed event.
  The fleet's fallback contract (``consensus_pallas_fallback``,
  ``claim_shard_fallback``, ``commit_batch_fallback``) is "counted,
  never silent": a degrade nobody can see on a dashboard is an outage
  with extra steps.

The rest of the contract plane lives in sibling modules and registers
here: **SVOC013** snapshot-coverage (``statecov.py``), **SVOC015**
emission-taxonomy sync (``emissions.py``), **SVOC017** shard-spec
consistency (``shardspec.py``).  SVOC016 fingerprint-taint is
intraprocedural and rides ``ALL_RULES`` (``taint.py``).

Every interprocedural finding carries a ``path_trace`` naming the call
chain that justifies it — a finding nobody can replay from the source
is a finding nobody fixes.  Findings anchor at the *decision point*
(the emit callsite, the knob read, the call made under the lock), so
one inline suppression at the deliberate site silences exactly that
path family and nothing else.

The port's copy of :mod:`svoc_tpu.analysis.interrules` (``interrules.py:1-841``),
unchanged but for the package's name.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from svoc_torch.analysis.callgraph import (
    _EVENT_TYPE_RE,
    CallSite,
    FuncSummary,
    ModuleSummary,
    Program,
    find_hazard,
    is_emit_callsite,
)
from svoc_torch.analysis.concurrency import LockModel, is_journal_lock
from svoc_torch.analysis.emissions import METRIC_LEAVES, rule_svoc015
from svoc_torch.analysis.findings import Finding
from svoc_torch.analysis.shardspec import rule_svoc017
from svoc_torch.analysis.statecov import rule_svoc013

# RULE_DOCS for 008–012 live in rules.py next to 001–007 (one table,
# one --list-rules); imported lazily to avoid a cycle.


def _severity(rule: str) -> str:
    from svoc_torch.analysis.rules import RULE_DOCS

    return RULE_DOCS[rule]["severity"]


class PackageContext:
    """What package rules need beyond the Program: source lines for
    snippet/context (the baseline key parts) and a Finding factory."""

    def __init__(
        self,
        lines_by_path: Dict[str, List[str]],
        docs_path: Optional[str] = None,
    ):
        self._lines = lines_by_path
        #: Root-relative path of docs/OBSERVABILITY.md when the engine
        #: found it (None in doc-less runs — SVOC015 then skips).
        self.docs_path = docs_path

    def lines(self, path: str) -> List[str]:
        return self._lines.get(path, [])

    def _line(self, path: str, line: int) -> str:
        lines = self._lines.get(path, [])
        if 1 <= line <= len(lines):
            return lines[line - 1].strip()
        return ""

    def _context(self, path: str, line: int) -> str:
        lines = self._lines.get(path, [])
        for nxt in range(line + 1, min(line + 4, len(lines) + 1)):
            text = lines[nxt - 1].strip()
            if text:
                return text
        return ""

    def finding(
        self,
        rule: str,
        path: str,
        line: int,
        message: str,
        hint: str,
        trace: Sequence[str] = (),
        col: int = 0,
    ) -> Finding:
        return Finding(
            rule=rule,
            severity=_severity(rule),
            path=path,
            line=line,
            col=col,
            message=message,
            hint=hint,
            snippet=self._line(path, line),
            context=self._context(path, line),
            path_trace=tuple(trace),
        )


# ---------------------------------------------------------------------------
# SVOC008 — wall-clock-in-fingerprinted-path
# ---------------------------------------------------------------------------

_WALL_CLOCK_DOTTED = {
    "time.time",
    "time.monotonic",
    "time.perf_counter",
    "time.time_ns",
    "time.monotonic_ns",
    "time.perf_counter_ns",
    "datetime.now",
    "datetime.utcnow",
    "datetime.today",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
}
#: bare-imported forms (`from time import time`): callsite name alone
#: is ambiguous (`metrics.timer().time()` is a span) — the import map
#: disambiguates.
_WALL_CLOCK_BARE = {"time", "monotonic", "perf_counter", "time_ns"}


def _is_wall_clock(call: CallSite, module: ModuleSummary) -> Optional[str]:
    if call.name in _WALL_CLOCK_DOTTED:
        return f"wall-clock `{call.name}()`"
    if call.name in _WALL_CLOCK_BARE:
        target = module.imports.get(call.name, "")
        if target == f"time.{call.name}":
            return f"wall-clock `{call.name}()`"
    return None


def rule_svoc008(program: Program, ctx: PackageContext) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()

    def flag(module: ModuleSummary, anchor_line: int, what: str, trace):
        key = (module.path, anchor_line)
        if key in seen:
            return
        seen.add(key)
        out.append(
            ctx.finding(
                "SVOC008",
                module.path,
                anchor_line,
                f"wall-clock reaches fingerprinted journal data: {what} "
                "— seeded replays of this event stream will not digest "
                "identically",
                "pass a virtual/seeded clock (or drop the field): journal "
                "fingerprints must digest replay-stable data only "
                "(docs/OBSERVABILITY.md §events); EventRecord.ts is the "
                "one sanctioned wall-clock field and it is excluded "
                "from fingerprints",
                trace,
            )
        )

    for module in program.modules.values():
        for fs in module.functions:
            # (a) emit-argument roots: any call in the DATA of an emit
            for call in fs.calls:
                if not call.emit_arg_of:
                    continue
                direct = _is_wall_clock(call, module)
                if direct is not None:
                    flag(
                        module,
                        call.emit_arg_of,
                        f"{direct} inline in the emit data",
                        (
                            f"{module.path}::{fs.qual} emit at line "
                            f"{call.emit_arg_of}",
                            f"{direct} at {module.path}:{call.line}",
                        ),
                    )
                    continue
                hit = find_hazard(
                    program,
                    module,
                    [call],
                    _is_wall_clock,
                    root_func=fs,
                    root_label=(
                        f"{module.path}::{fs.qual} emit at line "
                        f"{call.emit_arg_of}"
                    ),
                )
                if hit is not None:
                    hpath, hline, trace = hit
                    flag(
                        module,
                        call.emit_arg_of,
                        f"`{call.name or call.leaf}()` reaches a "
                        f"wall-clock call ({hpath}:{hline})",
                        trace,
                    )
            # (b) fingerprint derivation bodies
            if "fingerprint" in fs.name.lower():
                hit = find_hazard(
                    program,
                    module,
                    fs.calls,
                    _is_wall_clock,
                    root_func=fs,
                    root_label=f"{module.path}::{fs.qual}",
                )
                if hit is not None:
                    hpath, hline, trace = hit
                    flag(
                        module,
                        fs.line,
                        f"fingerprint path `{fs.qual}` reaches a "
                        f"wall-clock call ({hpath}:{hline})",
                        trace,
                    )
    return out


# ---------------------------------------------------------------------------
# SVOC009 — process-randomized-draw
# ---------------------------------------------------------------------------

_SEEDPATH_RE = re.compile(r"(seed|fingerprint)", re.IGNORECASE)
_SEEDED_RANDOM_LEAVES = {"Random", "SystemRandom", "seed", "getstate", "setstate"}


def _is_seed_path(fs: FuncSummary) -> bool:
    name = fs.name
    return bool(
        _SEEDPATH_RE.search(name)
        or name.endswith("_key")
        or name.endswith("_keys")
        or name == "mint_lineage"
    )


def _is_process_random(call: CallSite, module: ModuleSummary) -> Optional[str]:
    if call.name == "hash":
        return "`hash()` (per-process randomized for str/bytes)"
    if (
        call.root == "random"
        and call.name.startswith("random.")
        and call.leaf not in _SEEDED_RANDOM_LEAVES
    ):
        return f"unseeded `{call.name}()` module-level draw"
    if call.name in ("uuid.uuid4", "uuid.uuid1"):
        return f"`{call.name}()`"
    if not call.name.count(".") and call.name:
        target = module.imports.get(call.name, "")
        if target.startswith("random.") and call.leaf not in _SEEDED_RANDOM_LEAVES:
            return f"unseeded `{target}()` module-level draw"
    return None


def _set_iter_fact(fs: FuncSummary, module: ModuleSummary):
    if fs.set_iters:
        return (
            "iteration over a set (hash-randomized order for strings)",
            fs.set_iters[0],
        )
    return None


def rule_svoc009(program: Program, ctx: PackageContext) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()

    def flag(path: str, line: int, what: str, via: str, trace):
        key = (path, line)
        if key in seen:
            return
        seen.add(key)
        out.append(
            ctx.finding(
                "SVOC009",
                path,
                line,
                f"process-randomized draw in seed/key derivation path "
                f"{via}: {what} — two processes (or two runs) derive "
                "different streams from one seed",
                "derive with zlib.crc32 over a stable encoding + explicit "
                "PRNG keys (sim/generators.claim_seed is the model); "
                "sort set-typed collections before iterating",
                trace,
            )
        )

    for module in program.modules.values():
        for fs in module.functions:
            if not _is_seed_path(fs):
                continue
            via = f"`{module.path}::{fs.qual}`"
            # the root function's own facts first (find_hazard only
            # applies func_pred to traversed callees)
            fact = _set_iter_fact(fs, module)
            if fact is not None:
                what, line = fact
                flag(module.path, line, what, via, (via,))
            for call in fs.calls:
                direct = _is_process_random(call, module)
                if direct is not None:
                    flag(module.path, call.line, direct, via, (via,))
            hit = find_hazard(
                program,
                module,
                fs.calls,
                _is_process_random,
                func_pred=_set_iter_fact,
                root_func=fs,
                root_label=via,
            )
            if hit is not None:
                hpath, hline, trace = hit
                flag(hpath, hline, "reachable draw (see path)", via, trace)
    return out


# ---------------------------------------------------------------------------
# SVOC010 — emit-under-lock / lock-order
# ---------------------------------------------------------------------------


def _is_emit(call: CallSite, module: ModuleSummary) -> Optional[str]:
    if is_emit_callsite(call.leaf, call.root, call.name, call.arg0):
        return f"journal emit `{call.name or call.leaf}()`"
    return None


def _reachable_funcs(
    program: Program,
    module: ModuleSummary,
    call: CallSite,
    root_func: Optional[FuncSummary],
    max_depth: int = 16,
):
    """Every function id reachable from one callsite, with its trace."""
    start = program.resolve(module, call, root_func)
    if start is None:
        return
    queue = [(start, 1, (f"{module.path}:{call.line} {call.name or call.leaf}()",))]
    visited = {start}
    while queue:
        fid, depth, trace = queue.pop(0)
        yield fid, trace
        if depth >= max_depth:
            continue
        fs = program.funcs[fid]
        mod = program.modules[program.module_of(fid)]
        for c in fs.calls:
            nxt = program.resolve(mod, c, fs)
            if nxt is not None and nxt not in visited:
                visited.add(nxt)
                queue.append(
                    (nxt, depth + 1,
                     trace + (f"{mod.path}:{c.line} {c.name or c.leaf}()",))
                )


def rule_svoc010(program: Program, ctx: PackageContext) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    model = LockModel()

    def flag_emit(module, line, lock_ids, what, trace):
        key = (module.path, line)
        if key in seen:
            return
        seen.add(key)
        locks = ", ".join(f"`{l.split('::', 1)[1]}`" for l in sorted(lock_ids))
        out.append(
            ctx.finding(
                "SVOC010",
                module.path,
                line,
                f"path can reach journal emit while holding {locks}: "
                f"{what} — the journal lock is a LEAF; subscribers run "
                "on the emitting thread and may re-enter the held lock",
                "emit after releasing the lock (queue-and-flush like "
                "resilience/breaker.py _flush_events), or suppress with "
                "a reason if no subscriber can re-enter this lock "
                "(docs/OBSERVABILITY.md §events)",
                trace,
            )
        )

    for module in program.modules.values():
        for fs in module.functions:
            # lexical acquisition-order edges
            for acq in fs.locks:
                for held in acq.held:
                    if not is_journal_lock(held) and not is_journal_lock(acq.lock_id):
                        model.add_edge(
                            held, acq.lock_id, module.path, acq.line,
                            (f"{module.path}::{fs.qual}:{acq.line}",),
                        )
            for call in fs.calls:
                user_locks = tuple(
                    l for l in call.locks if not is_journal_lock(l)
                )
                if not user_locks:
                    continue
                direct = _is_emit(call, module)
                if direct is not None:
                    flag_emit(
                        module, call.line, user_locks, direct,
                        (f"{module.path}::{fs.qual} holds "
                         f"{user_locks[-1].split('::', 1)[1]}",
                         f"{direct} at {module.path}:{call.line}"),
                    )
                    continue
                # interprocedural: what does this locked call reach?
                for fid, trace in _reachable_funcs(
                    program, module, call, fs
                ):
                    callee = program.funcs[fid]
                    callee_mod = program.modules[program.module_of(fid)]
                    for acq in callee.locks:
                        if not is_journal_lock(acq.lock_id):
                            for held in user_locks:
                                model.add_edge(
                                    held, acq.lock_id, module.path,
                                    call.line, trace,
                                )
                    for c in callee.calls:
                        emit = _is_emit(c, callee_mod)
                        if emit is not None:
                            flag_emit(
                                module, call.line, user_locks,
                                f"`{call.name or call.leaf}()` reaches "
                                f"{emit} at {callee_mod.path}:{c.line}",
                                (f"{module.path}::{fs.qual} holds "
                                 f"{user_locks[-1].split('::', 1)[1]}",)
                                + trace
                                + (f"emit at {callee_mod.path}:{c.line}",),
                            )
                            break

    for cycle in model.cycles():
        witness = model.edges.get(
            (cycle[0], cycle[1 % len(cycle)])
        ) or next(iter(model.edges.values()))
        wpath, wline, wtrace = witness
        names = " -> ".join(l.split("::", 1)[1] for l in cycle + [cycle[0]])
        key = (wpath, wline)
        if key in seen:
            continue
        seen.add(key)
        out.append(
            ctx.finding(
                "SVOC010",
                wpath,
                wline,
                f"lock-acquisition cycle: {names} — two threads entering "
                "from opposite ends deadlock (ABBA)",
                "impose a global acquisition order (acquire in one fixed "
                "order everywhere), or narrow one side to not hold its "
                "lock across the call",
                wtrace,
            )
        )
    return out


# ---------------------------------------------------------------------------
# SVOC011 — unpinned-replay-knob
# ---------------------------------------------------------------------------

_ENTRY_RE = re.compile(r"^_?(step|serving_step|submit|fetch|drain|tick)$|^_?dispatch")

#: Construction-time bodies EXEMPT from the per-step entry heuristic:
#: the compile plane's prewarm/warmup workers deliberately name their
#: unit-of-work ``step()`` (``PrewarmWorker.step`` walks one compile
#: key), but warming is ahead-of-traffic construction work — it runs
#: the same knob-resolution and jit paths a dispatch does, BEFORE any
#: dispatch exists, so flagging it would force suppressions on every
#: warmup body.  Matched against the QUALIFIED name: any function whose
#: class or name says prewarm/warmup is construction-time by contract
#: (docs/PARALLELISM.md §compile-plane).
_CONSTRUCTION_RE = re.compile(r"(?i)prewarm|warmup")

_KNOB_LEAVES = {
    "resolve_consensus_impl",
    "resolve_claim_mesh",
    "pallas_interpret_opt_in",
    "env_int",
    "env_float",
    "pallas_max_oracles",
}
_ENV_READS = {"os.getenv", "os.environ.get", "environ.get"}


def _is_replay_knob(call: CallSite, module: ModuleSummary) -> Optional[str]:
    if call.leaf in _KNOB_LEAVES:
        return f"replay-knob resolution `{call.name or call.leaf}()`"
    if call.name in _ENV_READS and call.arg0 and call.arg0.startswith("SVOC_"):
        # (os.environ[...] subscripts don't surface as calls; the repo
        # convention is .get(), which does)
        return f"env read `{call.name}({call.arg0!r})`"
    return None


def rule_svoc011(program: Program, ctx: PackageContext) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for module in program.modules.values():
        for fs in module.functions:
            if not _ENTRY_RE.match(fs.name):
                continue
            if _CONSTRUCTION_RE.search(fs.qual):
                continue
            entry = f"{module.path}::{fs.qual}"
            # collect EVERY knob read reachable from this entry (not
            # just the first): each distinct read site is its own
            # pinning decision
            direct = [
                (call, _is_replay_knob(call, module))
                for call in fs.calls
            ]
            for call, label in direct:
                if label is None:
                    continue
                key = (module.path, call.line)
                if key in seen:
                    continue
                seen.add(key)
                out.append(
                    ctx.finding(
                        "SVOC011",
                        module.path,
                        call.line,
                        f"{label} inside per-step body `{fs.qual}` — "
                        "replay config must be pinned at construction, "
                        "not re-read per step (env drift mid-run breaks "
                        "seeded replay identity)",
                        "resolve once in __init__ (the ClaimRouter "
                        "pattern: env > PERF_DECISIONS.json > default, "
                        "stored on the instance) and read the pinned "
                        "attribute here",
                        (entry, f"{label} at {module.path}:{call.line}"),
                    )
                )
            # interprocedural: repeatedly BFS, masking seen anchors so
            # several distinct knob sites behind one entry all surface
            masked: Set[Tuple[str, int]] = set()

            def pred(call: CallSite, mod: ModuleSummary) -> Optional[str]:
                label = _is_replay_knob(call, mod)
                if label is None:
                    return None
                if (mod.path, call.line) in masked or (mod.path, call.line) in seen:
                    return None
                return label

            while True:
                hit = find_hazard(
                    program, module, fs.calls, pred,
                    root_func=fs, root_label=entry,
                )
                if hit is None:
                    break
                hpath, hline, trace = hit
                masked.add((hpath, hline))
                if (hpath, hline) in seen:
                    continue
                seen.add((hpath, hline))
                out.append(
                    ctx.finding(
                        "SVOC011",
                        hpath,
                        hline,
                        f"replay knob read at {hpath}:{hline} is reachable "
                        f"from per-step entry `{entry}` — config resolved "
                        "per dispatch instead of pinned at construction",
                        "pin the resolution at __init__ time and thread "
                        "the value through (docs/FABRIC.md §replay); if "
                        "the per-call read is deliberate (a parity/test "
                        "opt-in), suppress here with the reason",
                        trace,
                    )
                )
    return out


# ---------------------------------------------------------------------------
# SVOC012 — durability-ordering
# ---------------------------------------------------------------------------


def _is_fsync(call: CallSite, module: ModuleSummary) -> Optional[str]:
    if call.leaf in ("fsync", "fsync_dir"):
        return "fsync"
    return None


def _fsync_reachable(
    program: Program, module: ModuleSummary, fs: FuncSummary
) -> bool:
    if any(_is_fsync(c, module) for c in fs.calls):
        return True
    return (
        find_hazard(
            program, module, fs.calls, _is_fsync, root_func=fs, max_depth=3
        )
        is not None
    )


_DURABILITY_WRITE_ROOT_SKIP = {"sys", "stdout", "stderr", "print"}


def rule_svoc012(program: Program, ctx: PackageContext) -> List[Finding]:
    out: List[Finding] = []
    for module in program.modules.values():
        durability_scope = (
            "/durability/" in f"/{module.path}"
            or "durability-path" in module.tags
        )
        for fs in module.functions:
            replaces = [
                c for c in fs.calls if c.name in ("os.replace", "os.rename")
            ]
            writes = [
                c
                for c in fs.calls
                if durability_scope
                and c.leaf == "write"
                and c.name != "write"
                and c.root not in _DURABILITY_WRITE_ROOT_SKIP
            ]
            if not replaces and not writes:
                continue
            if _fsync_reachable(program, module, fs):
                continue
            for c in replaces:
                out.append(
                    ctx.finding(
                        "SVOC012",
                        module.path,
                        c.line,
                        f"`{c.name}()` in `{fs.qual}` with no reachable "
                        "fsync — the rename is directory metadata; after "
                        "a crash the pre-rename layout can resurrect and "
                        "recovery walks a stale file",
                        "fsync the written file before the rename and "
                        "fsync_dir(path) after it (the save_snapshot "
                        "pattern in utils/checkpoint.py)",
                        (f"{module.path}::{fs.qual}:{c.line}",),
                    )
                )
            for c in writes:
                out.append(
                    ctx.finding(
                        "SVOC012",
                        module.path,
                        c.line,
                        f"durability-path file write in `{fs.qual}` with "
                        "no reachable fsync — a WAL/chain-log record is "
                        "NO record until its bytes are durable; a crash "
                        "after this write silently loses the entry",
                        "flush + os.fsync(fileno) after the append (the "
                        "CommitIntentWAL._append pattern), or move the "
                        "write out of the durability path",
                        (f"{module.path}::{fs.qual}:{c.line}",),
                    )
                )
                break  # one write finding per function is enough signal
    return out


# ---------------------------------------------------------------------------
# SVOC014 — silent-fallback
# ---------------------------------------------------------------------------

#: Entry bodies whose reachable except-handlers must be accounted:
#: the per-step dispatch/serving surfaces of SVOC011 plus the commit
#: and recovery planes (a silent degrade during recovery is the worst
#: one — it "succeeds" into a wrong state).
_FALLBACK_ENTRY_RE = re.compile(
    r"^_?(step|serving_step|submit|fetch|drain|tick|recover|commit)$"
    r"|^_?(dispatch|commit_)"
)


def _accounts_call(call: CallSite, module: ModuleSummary) -> Optional[str]:
    """Does this callsite make a degrade VISIBLE — a metric-family
    registration/increment or a typed-event emission?"""
    arg0 = call.arg0
    if arg0 is None and call.arg0_name:
        arg0 = module.consts.get(call.arg0_name) or call.arg0_name
    if call.leaf in METRIC_LEAVES:
        # any metric touch counts, even with a computed family name —
        # visibility is the contract, not which family
        return f"metric family `{arg0 or call.name}`"
    if is_emit_callsite(call.leaf, call.root, call.name, call.arg0):
        return f"typed event emit `{call.name or call.leaf}()`"
    if "emit" in call.leaf and arg0 and _EVENT_TYPE_RE.match(arg0):
        return f"typed event `{arg0}`"
    return None


def _handler_accounted(
    program: Program, module: ModuleSummary, fs: FuncSummary, handler: Dict
) -> bool:
    if handler.get("raises"):
        return True
    if handler.get("uses_exc"):
        # the bound exception is read inside the handler — captured into
        # a log line, a verdict/bundle field, or a helper's argument, so
        # the degrade leaves a trace; "silent" means dropped on the floor
        return True
    lo, hi = int(handler["line"]), int(handler["end"])
    in_range = [c for c in fs.calls if lo <= c.line <= hi]
    if any(_accounts_call(c, module) is not None for c in in_range):
        return True
    # a helper called from the handler may do the accounting (or
    # re-raise) on the handler's behalf — shallow walk, both count
    return (
        find_hazard(
            program,
            module,
            in_range,
            _accounts_call,
            func_pred=lambda f, m: ("re-raises", f.line) if f.raises else None,
            root_func=fs,
            max_depth=4,
        )
        is not None
    )


def rule_svoc014(program: Program, ctx: PackageContext) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    memo: Dict[Tuple[str, int], bool] = {}

    def check_func(fid: str, entry: str, trace_prefix: Tuple[str, ...]):
        fs = program.funcs[fid]
        module = program.modules[program.module_of(fid)]
        for handler in fs.excepts:
            hkey = (fid, int(handler["line"]))
            if hkey not in memo:
                memo[hkey] = _handler_accounted(program, module, fs, handler)
            if memo[hkey]:
                continue
            key = (module.path, int(handler["line"]))
            if key in seen:
                continue
            seen.add(key)
            out.append(
                ctx.finding(
                    "SVOC014",
                    module.path,
                    int(handler["line"]),
                    f"silent fallback: except handler in `{fs.qual}` "
                    f"(reachable from entry `{entry}`) neither re-raises, "
                    "increments a counter, nor emits a typed event — a "
                    "degrade nobody can see on a dashboard is an outage "
                    "with extra steps",
                    "count it (the consensus_pallas_fallback contract: "
                    "fallbacks are counted, never silent) or emit a typed "
                    "event; re-raise if the degrade is not deliberate; "
                    "suppress with a reason only for handlers whose "
                    "outcome is already accounted upstream",
                    trace_prefix
                    + (
                        f"{module.path}::{fs.qual}:{handler['line']} "
                        "silent handler",
                    ),
                )
            )

    for module in program.modules.values():
        for fs in module.functions:
            if not _FALLBACK_ENTRY_RE.match(fs.name):
                continue
            if _CONSTRUCTION_RE.search(fs.qual):
                continue
            entry = f"{module.path}::{fs.qual}"
            fid = f"{module.path}::{fs.qual}"
            check_func(fid, entry, (entry,))
            for call in fs.calls:
                for reached, trace in _reachable_funcs(
                    program, module, call, fs, max_depth=6
                ):
                    check_func(reached, entry, (entry,) + trace)
    return out


PACKAGE_RULES: Sequence[Callable[[Program, PackageContext], List[Finding]]] = (
    rule_svoc008,
    rule_svoc009,
    rule_svoc010,
    rule_svoc011,
    rule_svoc012,
    rule_svoc013,
    rule_svoc014,
    rule_svoc015,
    rule_svoc017,
)
