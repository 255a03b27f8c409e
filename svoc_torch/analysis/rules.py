"""The SVOC001–SVOC006 hazard rules.

Each rule is a function ``(unit: ModuleUnit) -> List[Finding]`` over one
parsed module; ``ALL_RULES`` is what the engine iterates.  Rules are
deliberately lexical and module-local (see the jitmap docstring): they
trade soundness for zero-import, sub-second whole-repo runs, and every
heuristic here exists because a probe round (DISPATCH_PROBE*,
FLASH_PROBE) or a PR review caught the corresponding hazard by hand at
least once.

Rule design contract (tests/test_svoclint.py holds one positive and one
negative fixture per rule, and tests/test_torch_svoclint_parity.py runs
each through this copy too):

- a finding must name the hazard AND the fix (``hint``),
- no rule may import or execute analyzed code,
- false-positive escape hatches are inline suppressions / the baseline,
  both visible in review — never silent rule-side special cases.

The port's copy of :mod:`svoc_tpu.analysis.rules` (``rules.py:1-1035``),
with the same rules, ``RULE_DOCS`` and messages.  One table differs:
SVOC001's host syncs also know the port's spellings, ``.cpu()``,
``.numpy()``, ``.tolist()`` and ``.synchronize()`` (``torch.cuda``'s, an
event's, a stream's).  SVOC003 and SVOC004 stay and find nothing in the
port, which builds no jit and donates nothing.
"""

from __future__ import annotations

import ast
import re
from typing import Callable, Dict, List, Optional, Sequence, Set

from svoc_torch.analysis.findings import Finding
from svoc_torch.analysis.jitmap import (
    JIT_CALLABLES,
    JitInfo,
    JitMap,
    dotted_name,
)

#: Stage spans that wrap jit dispatch on the serving/fetch hot path
#: (utils/metrics.py stage-name conventions).  Host-side stages
#: (tokenize/pack/scrape/commit/fetch) legitimately touch numpy.
DISPATCH_STAGES = {"serving_step", "fleet", "consensus", "forward", "h2d"}

#: Host-sync call forms (SVOC001).
_SYNC_DOTTED = {
    "jax.device_get",
    "device_get",
    "np.asarray",
    "np.array",
    "numpy.asarray",
    "numpy.array",
    "onp.asarray",
    "onp.array",
}
#: The JAX leaves, then the port's: a tensor's copy to the host
#: (``.cpu()``/``.numpy()``/``.tolist()``) and a wait on the card
#: (``torch.cuda.synchronize()``, an event's or a stream's
#: ``.synchronize()``).
_SYNC_METHOD_LEAVES = {
    "item", "block_until_ready", "cpu", "numpy", "tolist", "synchronize",
}

#: Q-scale constants that are NOT this repo's wsad 1e6 (SVOC005).
WSAD_SCALE = 10**6
FOREIGN_SCALES = {10**k for k in (7, 8, 9, 12, 15, 18)}

#: Mutating method names on shared containers (SVOC006).
_MUTATORS = {
    "append",
    "add",
    "update",
    "pop",
    "popleft",
    "popitem",
    "extend",
    "insert",
    "remove",
    "discard",
    "clear",
    "setdefault",
    "appendleft",
}

RULE_DOCS: Dict[str, Dict[str, str]] = {
    "SVOC001": {
        "name": "host-sync-in-hot-path",
        "severity": "error",
        "summary": (
            "host synchronization (.item()/float()/np.asarray/"
            "jax.device_get/block_until_ready) inside a jit body or a "
            "dispatch-path stage_span"
        ),
    },
    "SVOC002": {
        "name": "impure-jit-body",
        "severity": "error",
        "summary": (
            "side effects inside a traced body: print/logging/"
            "metrics-registry observation/global or self mutation"
        ),
    },
    "SVOC003": {
        "name": "recompile-hazard",
        "severity": "warning",
        "summary": (
            "jit built inside a loop; f-string/dict static args; "
            "shape-derived Python scalars at non-static positions"
        ),
    },
    "SVOC004": {
        "name": "donation-reuse",
        "severity": "error",
        "summary": "argument used after being passed through donate_argnums",
    },
    "SVOC005": {
        "name": "fixed-point-contract",
        "severity": "error",
        "summary": (
            "float literals / astype(float) / true division / foreign "
            "Q-scale constants inside wsad integer paths"
        ),
    },
    "SVOC006": {
        "name": "unlocked-shared-state",
        "severity": "warning",
        "summary": (
            "module-level mutable state mutated without a lock in a "
            "thread-entry module"
        ),
    },
    "SVOC007": {
        "name": "event-in-traced-body",
        "severity": "error",
        "summary": (
            "event-journal emission (emit_event / journal.emit) inside "
            "a jit-traced body — fires at trace time only, never per "
            "execution"
        ),
    },
    # -- interprocedural rules (svoc_torch/analysis/interrules.py) ----------
    "SVOC008": {
        "name": "wall-clock-in-fingerprinted-path",
        "severity": "error",
        "summary": (
            "time.time/monotonic/perf_counter/datetime.now reachable "
            "from journal-emit data or a fingerprint derivation — "
            "seeded replays stop digesting identically"
        ),
    },
    "SVOC009": {
        "name": "process-randomized-draw",
        "severity": "error",
        "summary": (
            "hash() / unseeded random.* / set iteration in seed, key, "
            "or fingerprint derivation paths — the crc32+explicit-key "
            "discipline, enforced"
        ),
    },
    "SVOC010": {
        "name": "emit-under-lock",
        "severity": "warning",
        "summary": (
            "a call path reaches journal.emit (subscribers run on the "
            "emitting thread) while a non-journal lock is held; also "
            "lock-acquisition cycles (ABBA)"
        ),
    },
    "SVOC011": {
        "name": "unpinned-replay-knob",
        "severity": "warning",
        "summary": (
            "os.environ / resolve_consensus_impl / resolve_claim_mesh / "
            "SVOC_* reads reachable from step/dispatch/fetch bodies "
            "instead of __init__-time pinning"
        ),
    },
    "SVOC012": {
        "name": "durability-ordering",
        "severity": "error",
        "summary": (
            "os.replace/rename with no reachable fsync_dir, or a "
            "durability-path file write with no fsync before returning"
        ),
    },
    "SVOC013": {
        "name": "snapshot-coverage",
        "severity": "error",
        "summary": (
            "mutable self.* state on a replay-relevant class that the "
            "durable serializers (utils/checkpoint.py, "
            "durability/recovery.py) never read — a crash + recover "
            "silently resets it; `# svoc: volatile(<reason>)` marks "
            "deliberately transient fields and is audited for staleness"
        ),
    },
    "SVOC014": {
        "name": "silent-fallback",
        "severity": "warning",
        "summary": (
            "an except/degrade branch reachable from a dispatch/commit/"
            "serving/recovery entry that neither re-raises, increments "
            "a counter, nor emits a typed event — fallbacks are "
            "counted, never silent"
        ),
    },
    "SVOC015": {
        "name": "emission-taxonomy-sync",
        "severity": "error",
        "summary": (
            "two-way join of emitted event types + registered metric "
            "families against docs/OBSERVABILITY.md's taxonomy tables: "
            "emitted-but-undocumented AND documented-but-never-emitted "
            "both fail"
        ),
    },
    "SVOC016": {
        "name": "fingerprint-taint",
        "severity": "error",
        "summary": (
            "intraprocedural taint flow (assignments, f-strings, "
            "containers) from nondeterministic sources (wall clocks, "
            "id(), hash(), os.urandom, set iteration) into journal-emit "
            "data or fingerprint* return values"
        ),
    },
    "SVOC017": {
        "name": "shard-spec-consistency",
        "severity": "error",
        "summary": (
            "PartitionSpec / collective axis names must exist among the "
            "parallel/mesh.py *_AXIS constants; any collective inside "
            "the exact-parity claim-cube bodies is an error"
        ),
    },
}


def _snippet(unit, line: int) -> str:
    if 1 <= line <= len(unit.lines):
        return unit.lines[line - 1].strip()
    return ""


def _context(unit, line: int) -> str:
    """The next non-empty stripped line — the baseline key's tiebreak."""
    for nxt in range(line + 1, min(line + 4, len(unit.lines) + 1)):
        text = unit.lines[nxt - 1].strip()
        if text:
            return text
    return ""


def _finding(unit, rule: str, node: ast.AST, message: str, hint: str) -> Finding:
    line = getattr(node, "lineno", 1)
    return Finding(
        rule=rule,
        severity=RULE_DOCS[rule]["severity"],
        path=unit.path,
        line=line,
        col=getattr(node, "col_offset", 0),
        message=message,
        hint=hint,
        snippet=_snippet(unit, line),
        context=_context(unit, line),
    )


def _walk_scope(root: ast.AST):
    """``ast.walk`` over the statements of one traced/span scope."""
    yield from ast.walk(root)


def _walk_executed(root: ast.AST):
    """Walk only code that EXECUTES in this scope: nested def/lambda
    bodies are skipped — a ``def`` inside a span block only defines its
    body, it doesn't run it there.  (Traced jit bodies are different:
    nested defs inside them DO run at trace time, so jit scans use
    :func:`_walk_scope`.)"""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue  # the def statement executes; its body doesn't
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# SVOC001 — host-sync-in-hot-path
# ---------------------------------------------------------------------------


def _sync_call_kind(call: ast.Call) -> Optional[str]:
    fname = dotted_name(call.func)
    if fname in _SYNC_DOTTED:
        return fname
    if fname == "float" and call.args:
        return "float()"
    if isinstance(call.func, ast.Attribute) and call.func.attr in _SYNC_METHOD_LEAVES:
        return f".{call.func.attr}()"
    return None


def rule_svoc001(unit) -> List[Finding]:
    out: List[Finding] = []
    jm: JitMap = unit.jitmap

    def scan(root: ast.AST, where: str, hint: str, walk=_walk_scope) -> None:
        for node in walk(root):
            if not isinstance(node, ast.Call):
                continue
            kind = _sync_call_kind(node)
            if kind is None:
                continue
            out.append(
                _finding(
                    unit,
                    "SVOC001",
                    node,
                    f"host sync `{kind}` {where}",
                    hint,
                )
            )

    for fn, info in jm.traced_roots():
        scan(
            fn,
            f"inside jit-traced `{info.name or '<lambda>'}`",
            "move the host conversion outside the traced body; traced "
            "code must stay on-device (use jnp, or return the value and "
            "convert at the call site)",
        )
    for span in jm.spans:
        if span.stage not in DISPATCH_STAGES:
            continue
        # The span node's subtree includes its own header: scan the body
        # only, and only code that EXECUTES there (a def inside the span
        # defines its body for later — _walk_executed skips it).
        for stmt in span.node.body:
            scan(
                stmt,
                f'inside dispatch-path span "{span.stage}"',
                "dispatch spans must time host dispatch only — hoist the "
                "sync out of the span, or suppress with a comment if the "
                "fetch is the span's documented purpose",
                walk=_walk_executed,
            )
    return out


# ---------------------------------------------------------------------------
# SVOC002 — impure-jit-body
# ---------------------------------------------------------------------------

_LOG_ROOTS = {"logging", "log", "logger"}
_METRIC_ROOTS = {"metrics", "registry", "tracer"}


def _call_root(call: ast.Call) -> Optional[str]:
    node = call.func
    while isinstance(node, ast.Attribute):
        node = node.value
    while isinstance(node, ast.Call):  # chained: metrics.counter(...).add(...)
        node = node.func
        while isinstance(node, ast.Attribute):
            node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def rule_svoc002(unit) -> List[Finding]:
    out: List[Finding] = []
    jm: JitMap = unit.jitmap
    for fn, info in jm.traced_roots():
        label = info.name or "<lambda>"
        for node in _walk_scope(fn):
            if isinstance(node, ast.Call):
                fname = dotted_name(node.func) or ""
                root = _call_root(node)
                # A bare call named `log`/`logger` is math (jnp.log
                # imported bare), not logging — only method calls on
                # those roots (log.info, logger.warning) or anything on
                # the logging module itself count.
                is_logging = root == "logging" or (
                    root in _LOG_ROOTS and isinstance(node.func, ast.Attribute)
                )
                if fname == "print":
                    out.append(
                        _finding(
                            unit,
                            "SVOC002",
                            node,
                            f"print() inside jit-traced `{label}` runs at "
                            "trace time only (or forces a callback)",
                            "use jax.debug.print for traced values, or log "
                            "outside the traced body",
                        )
                    )
                elif is_logging:
                    out.append(
                        _finding(
                            unit,
                            "SVOC002",
                            node,
                            f"logging call inside jit-traced `{label}` "
                            "executes at trace time, silently skipped on "
                            "cached executions",
                            "log around the dispatch, not inside the "
                            "traced body",
                        )
                    )
                elif root in _METRIC_ROOTS or fname.endswith("stage_span"):
                    out.append(
                        _finding(
                            unit,
                            "SVOC002",
                            node,
                            f"metrics/tracer observation inside jit-traced "
                            f"`{label}` records trace-time, not run-time",
                            "observe around the jitted call (the "
                            "_traced_dispatch pattern in parallel/"
                            "serving.py)",
                        )
                    )
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                out.append(
                    _finding(
                        unit,
                        "SVOC002",
                        node,
                        f"`{type(node).__name__.lower()}` inside jit-traced "
                        f"`{label}` mutates Python state at trace time only",
                        "thread state through arguments/returns; traced "
                        "bodies must be pure",
                    )
                )
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign) else [node.target]
                )
                for tgt in targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        out.append(
                            _finding(
                                unit,
                                "SVOC002",
                                node,
                                f"`self.{tgt.attr}` mutation inside "
                                f"jit-traced `{label}` happens at trace "
                                "time only — cached executions never see it",
                                "return the value instead of storing it on "
                                "the instance",
                            )
                        )
    return out


# ---------------------------------------------------------------------------
# SVOC003 — recompile-hazard
# ---------------------------------------------------------------------------


def _is_shape_scalar(node: ast.AST) -> bool:
    """len(x), x.shape[i], x.ndim, x.size — Python scalars derived from
    array shapes, the classic per-shape recompile feeder."""
    if isinstance(node, ast.Call) and dotted_name(node.func) == "len":
        return True
    if isinstance(node, ast.Subscript):
        base = node.value
        if isinstance(base, ast.Attribute) and base.attr == "shape":
            return True
    if isinstance(node, ast.Attribute) and node.attr in {"ndim", "size"}:
        return True
    return False


def rule_svoc003(unit) -> List[Finding]:
    out: List[Finding] = []
    jm: JitMap = unit.jitmap

    for node in jm.nodes:
        if not isinstance(node, ast.Call):
            continue
        fname = dotted_name(node.func)
        if fname in JIT_CALLABLES:
            if jm.inside_loop(node):
                out.append(
                    _finding(
                        unit,
                        "SVOC003",
                        node,
                        "jax.jit constructed inside a loop — every "
                        "iteration builds a fresh callable and "
                        "compile-cache entry",
                        "hoist the jit (or the jitted factory call) out of "
                        "the loop and reuse one callable",
                    )
                )
                continue
            # Per-request construction: `jax.jit(f)(x)` built AND
            # invoked in one expression inside a function — every call
            # of that function rebuilds the callable.  The factory
            # pattern (build once, return/assign the callable) is the
            # legitimate form and is not an immediate invocation.
            parent = jm.parents.get(node)
            if (
                isinstance(parent, ast.Call)
                and parent.func is node
                and jm.enclosing_function(node) is not None
            ):
                out.append(
                    _finding(
                        unit,
                        "SVOC003",
                        node,
                        "jax.jit constructed and invoked in one expression "
                        "inside a function — every call of the enclosing "
                        "function rebuilds the callable (per-request "
                        "compile-cache churn)",
                        "build the jitted callable once (module level, or "
                        "a factory that returns it) and reuse it across "
                        "calls",
                    )
                )
                continue
        # Call-site contract checks against module-known jitted callables.
        if not isinstance(node.func, ast.Name):
            continue
        info: Optional[JitInfo] = jm.by_name.get(node.func.id)
        if info is None:
            continue

        def check_arg(arg: ast.AST, static: bool, where: str) -> None:
            if isinstance(arg, ast.JoinedStr):
                out.append(
                    _finding(
                        unit,
                        "SVOC003",
                        arg,
                        f"f-string {where} of jitted `{info.name}` — a "
                        "distinct string per call means a distinct compile "
                        "cache entry per call (or a trace error if dynamic)",
                        "pass a stable interned string, or restructure so "
                        "the string is not a jit argument",
                    )
                )
            elif isinstance(arg, ast.Dict) and static:
                out.append(
                    _finding(
                        unit,
                        "SVOC003",
                        arg,
                        f"dict literal {where} of jitted `{info.name}` at a "
                        "static position — dicts are unhashable as static "
                        "args and rebuild identity per call",
                        "use a frozen dataclass / NamedTuple / tuple of "
                        "pairs for static configuration",
                    )
                )
            elif not static and _is_shape_scalar(arg):
                out.append(
                    _finding(
                        unit,
                        "SVOC003",
                        arg,
                        f"shape-derived Python scalar {where} of jitted "
                        f"`{info.name}` at a NON-static position — each "
                        "distinct shape retraces",
                        "declare the parameter in static_argnums/"
                        "static_argnames (shape-like ints are static by "
                        "nature), or derive the value inside the traced "
                        "body",
                    )
                )

        for i, arg in enumerate(node.args):
            check_arg(arg, info.is_static_position(i), f"argument {i}")
        for kw in node.keywords:
            if kw.arg is None:
                continue
            static = kw.arg in info.static_argnames or (
                kw.arg in info.params
                and info.params.index(kw.arg) in info.static_argnums
            )
            check_arg(kw.value, static, f"argument `{kw.arg}`")
    return out


# ---------------------------------------------------------------------------
# SVOC004 — donation-reuse
# ---------------------------------------------------------------------------


def _assigned_names(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for tgt in ast.walk(node):
        if isinstance(tgt, ast.Name) and isinstance(tgt.ctx, ast.Store):
            out.add(tgt.id)
    return out


def rule_svoc004(unit) -> List[Finding]:
    out: List[Finding] = []
    jm: JitMap = unit.jitmap
    for node in jm.nodes:
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)):
            continue
        info = jm.by_name.get(node.func.id)
        if info is None:
            continue
        donated = info.donated_positions()
        donated_names = set(info.donate_argnames)
        if not donated and not donated_names:
            continue
        donated_args: List[ast.Name] = []
        for i, arg in enumerate(node.args):
            if i in donated and isinstance(arg, ast.Name):
                donated_args.append(arg)
        for kw in node.keywords:
            if kw.arg is None or not isinstance(kw.value, ast.Name):
                continue
            if kw.arg in donated_names or (
                kw.arg in info.params and info.params.index(kw.arg) in donated
            ):
                donated_args.append(kw.value)
        if not donated_args:
            continue
        scope = jm.enclosing_function(node) or unit.tree
        call_names = {
            n for n in ast.walk(node) if isinstance(n, ast.Name)
        }
        # Is the call's result rebound onto the donated name (x = f(x))?
        parent = jm.parents.get(node)
        rebound_at_call: Set[str] = set()
        if isinstance(parent, ast.Assign):
            rebound_at_call = {
                t.id
                for tgt in parent.targets
                for t in ast.walk(tgt)
                if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store)
            }
        for arg in donated_args:
            name = arg.id
            if name in rebound_at_call:
                continue  # `x = f(x)` immediately rebinds — safe
            # collect rebind lines after the call inside the scope
            rebinds = sorted(
                t.lineno
                for t in ast.walk(scope)
                if isinstance(t, ast.Name)
                and isinstance(t.ctx, ast.Store)
                and t.id == name
                and t.lineno > node.lineno
            )
            for use in ast.walk(scope):
                if (
                    isinstance(use, ast.Name)
                    and isinstance(use.ctx, ast.Load)
                    and use.id == name
                    # same-line uses count too (`step(x, d) + x`); the
                    # call's own argument loads are in call_names
                    and use.lineno >= node.lineno
                    and use not in call_names
                    # a rebind protects only lines strictly AFTER it:
                    # `x = x + 1` loads the donated buffer on the
                    # rebind line itself — the classic reuse
                    and not any(r < use.lineno for r in rebinds)
                ):
                    out.append(
                        _finding(
                            unit,
                            "SVOC004",
                            use,
                            f"`{name}` used after being DONATED to "
                            f"`{info.name}` (donate_argnums) on line "
                            f"{node.lineno} — its buffer may already be "
                            "aliased/invalidated",
                            "rebind the result over the donated name "
                            "(`x = f(x)`), copy before donating, or drop "
                            "the donation",
                        )
                    )
                    break  # one finding per donated name per call
            else:
                # No later lexical use; if the call sits in a loop and
                # nothing rebinds the name inside it, iteration 2 reuses
                # the donated buffer.
                loop = None
                for anc in jm.ancestors(node):
                    if isinstance(anc, (ast.For, ast.While)):
                        loop = anc
                        break
                    if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        break
                if loop is not None and name not in _assigned_names(loop):
                    out.append(
                        _finding(
                            unit,
                            "SVOC004",
                            node,
                            f"`{name}` donated to `{info.name}` inside a "
                            "loop without rebinding — the next iteration "
                            "passes an invalidated buffer",
                            "rebind the result over the donated name each "
                            "iteration, or drop the donation",
                        )
                    )
    return out


# ---------------------------------------------------------------------------
# SVOC005 — fixed-point-contract
# ---------------------------------------------------------------------------

#: Modules the Q-format contract covers even without an explicit tag.
FIXEDPOINT_PATHS = ("ops/fixedpoint.py", "consensus/wsad_engine.py")


def _returns_int(fn: ast.FunctionDef) -> bool:
    ret = fn.returns
    if isinstance(ret, ast.Name) and ret.id == "int":
        return True
    if isinstance(ret, ast.Subscript):  # list[int] / List[int]
        base = dotted_name(ret.value) or ""
        if base.rsplit(".", 1)[-1].lower() == "list":
            inner = ret.slice
            return isinstance(inner, ast.Name) and inner.id == "int"
    return False


def _mentions_float(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "float" in sub.id:
            return True
        if isinstance(sub, ast.Attribute) and "float" in sub.attr:
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if "float" in sub.value:
                return True
    return False


def rule_svoc005(unit) -> List[Finding]:
    applies = unit.path.endswith(FIXEDPOINT_PATHS) or "fixedpoint-path" in unit.tags
    if not applies:
        return []
    out: List[Finding] = []
    for fn in unit.jitmap.nodes:
        if not isinstance(fn, ast.FunctionDef):
            continue
        qpath = (
            fn.name.startswith("wsad_")
            or fn.name == "div_trunc"
            or _returns_int(fn)
        )
        if not qpath:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Constant) and isinstance(node.value, float):
                out.append(
                    _finding(
                        unit,
                        "SVOC005",
                        node,
                        f"float literal `{node.value!r}` inside Q-format "
                        f"integer path `{fn.name}`",
                        "express the constant in wsad ints (WSAD/"
                        "HALF_WSAD) or move the float math to an untagged "
                        "boundary function",
                    )
                )
            elif (
                isinstance(node, ast.Constant)
                and isinstance(node.value, int)
                and not isinstance(node.value, bool)
                and node.value in FOREIGN_SCALES
            ):
                out.append(
                    _finding(
                        unit,
                        "SVOC005",
                        node,
                        f"foreign Q-scale constant `{node.value}` inside "
                        f"`{fn.name}` — this repo's wsad scale is 1e6",
                        "use the WSAD constant (svoc_torch.ops.fixedpoint) "
                        "so every Q-path shares one scale",
                    )
                )
            elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                out.append(
                    _finding(
                        unit,
                        "SVOC005",
                        node,
                        f"true division `/` inside Q-format integer path "
                        f"`{fn.name}` produces a float",
                        "use div_trunc (Cairo's truncate-toward-zero) or "
                        "`//` where flooring is proven equivalent",
                    )
                )
            elif isinstance(node, ast.Call):
                fname = dotted_name(node.func) or ""
                if fname.endswith(".astype") or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "astype"
                ):
                    if any(_mentions_float(a) for a in node.args) or any(
                        _mentions_float(k.value) for k in node.keywords
                    ):
                        out.append(
                            _finding(
                                unit,
                                "SVOC005",
                                node,
                                f"astype(float…) inside Q-format integer "
                                f"path `{fn.name}`",
                                "keep Q-paths integral; convert at the "
                                "boundary codec instead",
                            )
                        )
                else:
                    for kw in node.keywords:
                        if kw.arg == "dtype" and _mentions_float(kw.value):
                            out.append(
                                _finding(
                                    unit,
                                    "SVOC005",
                                    node,
                                    f"float dtype inside Q-format integer "
                                    f"path `{fn.name}`",
                                    "keep Q-paths integral; convert at the "
                                    "boundary codec instead",
                                )
                            )
    return out


# ---------------------------------------------------------------------------
# SVOC006 — unlocked-shared-state
# ---------------------------------------------------------------------------

#: Modules whose functions run on server/daemon threads.
THREAD_ENTRY_PATHS = ("apps/web.py", "parallel/serving.py")

_MUTABLE_FACTORIES = {
    "dict",
    "list",
    "set",
    "deque",
    "defaultdict",
    "OrderedDict",
    "Counter",
    "collections.deque",
    "collections.defaultdict",
    "collections.OrderedDict",
    "collections.Counter",
}


def _module_level_mutables(tree: ast.Module) -> Set[str]:
    names: Set[str] = set()
    for stmt in tree.body:
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            continue
        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        value = stmt.value
        if value is None:
            continue
        mutable = isinstance(
            value,
            (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp, ast.SetComp),
        ) or (
            isinstance(value, ast.Call)
            and (dotted_name(value.func) or "") in _MUTABLE_FACTORIES
        )
        if not mutable:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                names.add(tgt.id)
    return names


_LOCK_ID_RE = re.compile(r"(?:^|_)r?locks?(?:$|_)")


def _names_lock_like(expr: ast.AST) -> bool:
    """True when an identifier in the with-context names a lock:
    ``lock`` / ``Lock()`` / ``RLock`` / ``_lock`` / ``sse_lock`` — as a
    word segment, so ``block`` / ``blocker`` don't count."""
    for sub in ast.walk(expr):
        ident = None
        if isinstance(sub, ast.Name):
            ident = sub.id
        elif isinstance(sub, ast.Attribute):
            ident = sub.attr
        if ident and _LOCK_ID_RE.search(ident.lower()):
            return True
    return False


def _under_lock(jm: JitMap, node: ast.AST) -> bool:
    for anc in jm.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                if _names_lock_like(item.context_expr):
                    return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # keep climbing: a helper called under a lock can't be seen
            # lexically, but a with-block in an OUTER def doesn't guard
            # this one either — stop at the first function boundary.
            return False
    return False


def rule_svoc006(unit) -> List[Finding]:
    applies = unit.path.endswith(THREAD_ENTRY_PATHS) or "thread-entry" in unit.tags
    if not applies:
        return []
    shared = _module_level_mutables(unit.tree)
    if not shared:
        return []
    jm: JitMap = unit.jitmap
    out: List[Finding] = []

    def flag(node: ast.AST, name: str, how: str) -> None:
        if _under_lock(jm, node):
            return
        if jm.enclosing_function(node) is None:
            return  # module-level init is single-threaded import time
        out.append(
            _finding(
                unit,
                "SVOC006",
                node,
                f"module-level mutable `{name}` {how} without a lock in a "
                "thread-entry module",
                "guard the mutation with a threading.Lock (see "
                "_monitoring_lock in utils/metrics.py), or move the state "
                "onto a per-instance object",
            )
        )

    for node in jm.nodes:
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for tgt in targets:
                if (
                    isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id in shared
                ):
                    flag(node, tgt.value.id, "item-assigned")
                elif (
                    isinstance(node, ast.AugAssign)
                    and isinstance(tgt, ast.Name)
                    and tgt.id in shared
                ):
                    flag(node, tgt.id, "aug-assigned")
        elif isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr in _MUTATORS
                and isinstance(func.value, ast.Name)
                and func.value.id in shared
            ):
                flag(node, func.value.id, f"mutated via .{func.attr}()")
        elif isinstance(node, ast.Global):
            for name in node.names:
                if name in shared:
                    flag(node, name, "rebound via `global`")
    return out


# ---------------------------------------------------------------------------
# SVOC007 — event-in-traced-body
# ---------------------------------------------------------------------------

#: Identifiers that name the event journal at callsites (the default
#: instance, scenario-local instances, and the conventional aliases).
_EVENT_ROOTS = {"journal", "event_journal", "events", "_journal", "_events"}


def rule_svoc007(unit) -> List[Finding]:
    """Event emission / journal writes are HOST-side only (same
    detection plumbing as SVOC002's metrics scan): inside a jit-traced
    body an ``emit_event``/``journal.emit`` call runs once at trace
    time — the flight recorder would record one phantom event per
    compile instead of one per execution, and its lock/file I/O has no
    business in a traced computation."""
    out: List[Finding] = []
    jm: JitMap = unit.jitmap
    for fn, info in jm.traced_roots():
        label = info.name or "<lambda>"
        for node in _walk_scope(fn):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func) or ""
            root = _call_root(node)
            is_emit = (
                fname == "emit_event"
                or fname.endswith(".emit_event")
                or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in {"emit", "subscribe", "set_trace_file"}
                    and root in _EVENT_ROOTS
                )
            )
            if is_emit:
                out.append(
                    _finding(
                        unit,
                        "SVOC007",
                        node,
                        f"event-journal call inside jit-traced `{label}` "
                        "records at trace time only (cached executions "
                        "emit nothing) and drags lock/file I/O into the "
                        "traced body",
                        "emit around the dispatch on the host — events "
                        "are host-side only (docs/OBSERVABILITY.md "
                        "§events)",
                    )
                )
    return out


from svoc_torch.analysis.taint import rule_svoc016  # noqa: E402  (needs RULE_DOCS above)

ALL_RULES: Sequence[Callable] = (
    rule_svoc001,
    rule_svoc002,
    rule_svoc003,
    rule_svoc004,
    rule_svoc005,
    rule_svoc006,
    rule_svoc007,
    rule_svoc016,
)
