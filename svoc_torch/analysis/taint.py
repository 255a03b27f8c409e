"""SVOC016 — fingerprint-taint: nondeterminism flowing through variables.

SVOC008/009 catch a wall clock or a randomized draw that a call chain
REACHES; they are blind to the two-line version every review has to
squint for::

    started = time.perf_counter()
    ...
    journal.emit("serving.step", took=time.perf_counter() - started)

The draw happens outside the emit expression, so call-reachability
never connects them — but the emitted payload is just as
replay-unstable.  This rule upgrades the check to an intraprocedural
DATAFLOW pass: per function, statements in order, a set of tainted
local names.

- **sources** — wall clocks (``time.time/monotonic/perf_counter/…``,
  ``datetime.now/utcnow``), ``id()``, ``hash()``, ``os.urandom``,
  ``uuid.uuid4/uuid1``, unseeded ``random.*`` draws, and iteration
  over a set-typed expression (hash-randomized order for strings).
- **propagation** — assignments, augmented assignments, f-strings,
  container displays, arithmetic, and arbitrary calls that take a
  tainted name as input (a conservative "functions of tainted data are
  tainted").  ``sorted(...)`` SANITIZES: its output order is
  deterministic, which is exactly the repo's prescribed fix for set
  iteration.
- **sinks** — a *tainted name* in the data arguments of a journal
  emission, or in the return expression of a ``fingerprint*``
  function.  Direct source calls at the sink are deliberately NOT
  flagged here — SVOC008/009 own those — so one hazard never produces
  two findings under two rule ids.

Per-module and cache-friendly, so it rides ``ALL_RULES`` rather than
the package phase; the findings carry a ``path_trace`` naming the
source line, the tainted name, and the sink.

The port's copy of :mod:`svoc_tpu.analysis.taint` (``taint.py:1-281``),
unchanged but for the package's name.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from svoc_torch.analysis.callgraph import (
    _call_leaf_root,
    _dotted,
    _iter_is_setish,
    is_emit_callsite,
)
from svoc_torch.analysis.findings import Finding

_WALL_CLOCK = {
    "time.time", "time.monotonic", "time.perf_counter", "time.time_ns",
    "time.monotonic_ns", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today",
}
_OTHER_SOURCES = {
    "id": "`id()` (an address, different every process)",
    "hash": "`hash()` (per-process randomized for str/bytes)",
    "os.urandom": "`os.urandom()`",
    "uuid.uuid4": "`uuid.uuid4()`",
    "uuid.uuid1": "`uuid.uuid1()`",
}
_SEEDED_RANDOM_LEAVES = {"Random", "SystemRandom", "seed", "getstate", "setstate"}

#: Taint source description + line, tracked per tainted name.
_Taint = Tuple[str, int]


def _finding(unit, rule: str, line: int, message: str, hint: str, trace) -> Finding:
    from svoc_torch.analysis.rules import RULE_DOCS, _context, _snippet

    return Finding(
        rule=rule,
        severity=RULE_DOCS[rule]["severity"],
        path=unit.path,
        line=line,
        col=0,
        message=message,
        hint=hint,
        snippet=_snippet(unit, line),
        context=_context(unit, line),
        path_trace=tuple(trace),
    )


def _source_of(node: ast.Call) -> Optional[str]:
    name = _dotted(node.func) or ""
    if name in _WALL_CLOCK:
        return f"wall-clock `{name}()`"
    if name in _OTHER_SOURCES:
        return _OTHER_SOURCES[name]
    if (
        name.startswith("random.")
        and name.split(".")[-1] not in _SEEDED_RANDOM_LEAVES
    ):
        return f"unseeded `{name}()` draw"
    return None


class _FuncTaint:
    """One function body's sequential taint pass."""

    def __init__(self, unit, fn: ast.AST):
        self.unit = unit
        self.fn = fn
        self.tainted: Dict[str, _Taint] = {}
        self.findings: List[Finding] = []
        self.is_fingerprint = "fingerprint" in fn.name.lower()

    # -- expression taint ----------------------------------------------------

    def _expr_taint(self, node: ast.AST) -> Optional[_Taint]:
        """First taint found in an expression, sanitizers respected."""
        if node is None:
            return None
        if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
            return None
        if isinstance(node, ast.Call):
            name = _dotted(node.func) or ""
            if name == "sorted":
                return None  # deterministic order: the sanctioned fix
            src = _source_of(node)
            if src is not None:
                return (src, node.lineno)
        if isinstance(node, ast.Name) and node.id in self.tainted:
            return self.tainted[node.id]
        for child in ast.iter_child_nodes(node):
            hit = self._expr_taint(child)
            if hit is not None:
                return hit
        return None

    def _tainted_name_in(self, node: ast.AST) -> Optional[Tuple[str, _Taint]]:
        """A TAINTED NAME inside an expression (direct sources excluded
        — those are SVOC008/009's findings)."""
        if node is None or isinstance(
            node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            return None
        if isinstance(node, ast.Call) and (_dotted(node.func) or "") == "sorted":
            return None
        if isinstance(node, ast.Name) and node.id in self.tainted:
            return (node.id, self.tainted[node.id])
        for child in ast.iter_child_nodes(node):
            hit = self._tainted_name_in(child)
            if hit is not None:
                return hit
        return None

    # -- statement walk ------------------------------------------------------

    def _assign_names(self, target: ast.AST) -> List[str]:
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, (ast.Tuple, ast.List)):
            out: List[str] = []
            for elt in target.elts:
                out.extend(self._assign_names(elt))
            return out
        return []

    def _check_sinks(self, stmt: ast.AST) -> None:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not isinstance(node, ast.Call):
                continue
            leaf, root = _call_leaf_root(node.func)
            name = _dotted(node.func) or ""
            arg0 = None
            if node.args and isinstance(node.args[0], ast.Constant):
                if isinstance(node.args[0].value, str):
                    arg0 = node.args[0].value
            if not is_emit_callsite(leaf, root, name, arg0):
                continue
            data_nodes = list(node.args[1:]) + [kw.value for kw in node.keywords]
            for data in data_nodes:
                hit = self._tainted_name_in(data)
                if hit is None:
                    continue
                var, (src, src_line) = hit
                self.findings.append(
                    _finding(
                        self.unit,
                        "SVOC016",
                        node.lineno,
                        f"nondeterministic value `{var}` (tainted by "
                        f"{src} at line {src_line}) flows into journal-"
                        "emit data — seeded replays of this event "
                        "stream stop digesting identically",
                        "derive the field from replay-stable inputs, or "
                        "drop it from the payload (EventRecord.ts is "
                        "the one sanctioned wall-clock field; it is "
                        "excluded from fingerprints)",
                        (
                            f"{self.unit.path}:{src_line} source: {src}",
                            f"`{var}` carries the taint",
                            f"{self.unit.path}:{node.lineno} sink: "
                            "journal emit data",
                        ),
                    )
                )
                return  # one finding per emit call is enough signal

    def _visit_stmt(self, stmt: ast.AST) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs get their own pass
        if isinstance(stmt, ast.Assign):
            taint = self._expr_taint(stmt.value)
            for name in [n for t in stmt.targets for n in self._assign_names(t)]:
                if taint is not None:
                    self.tainted[name] = taint
                else:
                    self.tainted.pop(name, None)
        elif isinstance(stmt, ast.AugAssign):
            taint = self._expr_taint(stmt.value)
            if taint is not None:
                for name in self._assign_names(stmt.target):
                    self.tainted[name] = taint
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            taint = self._expr_taint(stmt.value)
            for name in self._assign_names(stmt.target):
                if taint is not None:
                    self.tainted[name] = taint
                else:
                    self.tainted.pop(name, None)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            if _iter_is_setish(stmt.iter):
                taint: Optional[_Taint] = (
                    "iteration over a set (hash-randomized order)",
                    stmt.iter.lineno,
                )
            else:
                taint = self._expr_taint(stmt.iter)
            if taint is not None:
                for name in self._assign_names(stmt.target):
                    self.tainted[name] = taint
        elif isinstance(stmt, ast.Return):
            if self.is_fingerprint and stmt.value is not None:
                hit = self._tainted_name_in(stmt.value)
                if hit is not None:
                    var, (src, src_line) = hit
                    self.findings.append(
                        _finding(
                            self.unit,
                            "SVOC016",
                            stmt.lineno,
                            f"fingerprint function `{self.fn.name}` "
                            f"returns `{var}`, tainted by {src} at line "
                            f"{src_line} — two replays derive different "
                            "digests from identical history",
                            "fingerprints must digest replay-stable "
                            "encodings only (sort collections, drop "
                            "clocks/ids)",
                            (
                                f"{self.unit.path}:{src_line} source: {src}",
                                f"`{var}` carries the taint",
                                f"{self.unit.path}:{stmt.lineno} sink: "
                                f"return of `{self.fn.name}`",
                            ),
                        )
                    )
        self._check_sinks(stmt)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, (ast.stmt,)):
                self._visit_stmt(child)

    def run(self) -> List[Finding]:
        for stmt in self.fn.body:
            self._visit_stmt(stmt)
        return self.findings


def rule_svoc016(unit) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(unit.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.extend(_FuncTaint(unit, node).run())
    return out
