"""Module-qualified call-graph extraction and resolution.

The per-file rules (SVOC001–007) are deliberately module-local; the
hazards that actually bit the reference were *interprocedural*: wall-clock
reaching a fingerprinted journal path three calls down, an env knob
read per dispatch through two module boundaries, a lock held across a
helper that eventually emits.  This module gives the SVOC008–017 rules
the missing whole-package view while keeping every discipline of the
analysis package: pure ``ast``, no JAX, no imports of analyzed code,
and a summary representation cheap enough that the whole repo
extracts in well under the 10 s lint budget.

Shape
-----

- :func:`summarize_module` reduces one parsed module to a
  :class:`ModuleSummary`: its import aliases, classes, and one
  :class:`FuncSummary` per function — each function's calls
  (:class:`CallSite`: dotted name, leaf, root, first literal arg),
  annotated with the **locks held** at the callsite
  (:mod:`svoc_torch.analysis.concurrency`), the enclosing **emit-call
  argument** context (SVOC008's data-flow roots), and set-iteration
  lines (SVOC009).  Summaries are plain JSON-serializable dicts — the
  findings cache stores them so a warm run never re-parses.
- :class:`Program` indexes the summaries package-wide and resolves
  callsites to function ids (``path::Class.method``): local defs,
  ``self.`` methods, imported names, dotted module aliases, and — for
  otherwise-unresolvable method calls — a unique-method fallback
  (resolve ``x.dispatch_gated()`` when exactly one class in the whole
  program defines ``dispatch_gated``; common verbs are blacklisted so
  ``x.get()`` never cross-wires).
- :func:`find_hazard` is the shared BFS: from root callsites, walk the
  resolved graph up to a depth bound, and return the first callsite
  (or function-level fact) matching a predicate, with the **call chain
  that justifies it** — the ``path_trace`` every interprocedural
  finding must carry.

Precision stance: resolution is best-effort and UNDER-approximate
(an unresolvable call ends the walk silently).  That is the right
polarity for a merge gate — missed paths cost a finding, never a
false alarm — and mirrors the jitmap's accepted single-module trade,
now widened to the package instead of the file.

The port's copy of :mod:`svoc_tpu.analysis.callgraph` (``callgraph.py:1-755``),
unchanged but for the package's name.
"""

from __future__ import annotations

import ast
import dataclasses
import re
import tokenize
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from svoc_torch.analysis.concurrency import lock_identity

#: Method names too generic for the unique-method fallback: resolving
#: ``x.get()`` to the one class that happens to define ``get`` would
#: cross-wire unrelated objects.  (``emit`` is here because journal
#: emission is pattern-matched, never resolved.)
_COMMON_METHODS = {
    "get", "set", "add", "put", "pop", "run", "read", "write", "open",
    "close", "flush", "send", "next", "join", "split", "strip", "items",
    "keys", "values", "copy", "clear", "update", "append", "extend",
    "remove", "insert", "count", "index", "sort", "emit", "time",
    "start", "stop", "wait", "result", "done", "name", "observe",
    "acquire", "release", "encode", "decode", "render", "format",
    # DB-API / stdlib collisions: `conn.commit()` must never resolve to
    # a Session.commit across the package
    "commit", "rollback", "execute", "fetchall", "fetchone", "connect",
}

#: Event-type literals look like ``commit.sent`` / ``serving.shed`` —
#: the shape that marks an ``.emit(...)`` on an unresolvable root
#: (``self._resolve_journal().emit("durability.drain", ...)``) as a
#: journal emission.
_EVENT_TYPE_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")

#: Callsite roots that name the event journal (superset of SVOC007's:
#: the resilience helpers locally bind ``j = self._journal or journal``).
EVENT_ROOTS = {"journal", "event_journal", "events", "_journal", "_events", "j"}

#: The ``svoc: volatile(<reason>)`` comment annotation (SVOC013),
#: marking a replay-class field as deliberately transient
#: (recomputable, or meaningless across a restart).  Parsed from
#: comment tokens at summary time so the annotation set rides the
#: findings cache like everything else.
_VOLATILE_RE = re.compile(r"#\s*svoc:\s*volatile\(([^)]*)\)")

#: PartitionSpec constructors, as written (``P`` is the conventional
#: alias; the import map disambiguates at rule time).
_SPEC_LEAVES = {"P", "PartitionSpec"}

#: ``jax.lax`` collective leaves and the position of their axis-name
#: argument (keyword ``axis_name`` always wins).
_COLLECTIVE_LEAVES = {
    "psum", "pmean", "pmax", "pmin", "all_gather", "all_to_all",
    "ppermute", "pshuffle", "psum_scatter", "axis_index", "axis_size",
    "pbroadcast",
}
_COLLECTIVE_AXIS_ARG0 = {"axis_index", "axis_size"}


@dataclasses.dataclass(frozen=True)
class CallSite:
    """One call expression, as much of it as the rules pattern-match."""

    name: str  # dotted form as written ("self._step_inner", "time.time"); "" when unnameable
    leaf: str  # last attribute / function segment ("emit", "step")
    root: Optional[str]  # ultimate Name under the chain ("self", "time", "j")
    line: int
    col: int
    arg0: Optional[str]  # first positional argument when a str constant
    locks: Tuple[str, ...]  # lock ids held at this callsite (lexical)
    emit_arg_of: int  # line of the enclosing emit call when this call
    #                   sits in its ARGUMENTS; 0 otherwise
    arg0_name: Optional[str] = None  # first positional arg when a bare
    #                                  Name (resolved against module
    #                                  constants by SVOC015/017)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CallSite":
        return cls(
            name=d["name"], leaf=d["leaf"], root=d.get("root"),
            line=int(d["line"]), col=int(d.get("col", 0)),
            arg0=d.get("arg0"), locks=tuple(d.get("locks", ())),
            emit_arg_of=int(d.get("emit_arg_of", 0)),
            arg0_name=d.get("arg0_name"),
        )


@dataclasses.dataclass(frozen=True)
class LockAcq:
    """One lock acquisition (a lock-like ``with`` item)."""

    lock_id: str
    line: int
    held: Tuple[str, ...]  # locks already held when this one is taken

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LockAcq":
        return cls(
            lock_id=d["lock_id"], line=int(d["line"]),
            held=tuple(d.get("held", ())),
        )


@dataclasses.dataclass
class FuncSummary:
    """One function's interprocedural surface."""

    qual: str  # "func" | "Class.method" | "outer.inner"
    name: str  # leaf name
    cls: Optional[str]
    line: int
    calls: List[CallSite]
    locks: List[LockAcq]
    set_iters: List[int]  # lines iterating a set-typed expression
    #: every attribute NAME this function touches, any context —
    #: SVOC013's serializer-coverage universe (``session._fetch_claim``
    #: read in a to_dict counts the field as snapshotted)
    attrs: List[str] = dataclasses.field(default_factory=list)
    #: ``self.<attr> = ...`` assignment sites: ``[attr, line]`` pairs
    self_sets: List[List[Any]] = dataclasses.field(default_factory=list)
    #: except-handler facts for SVOC014: {"line", "end", "raises"}
    excepts: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    #: does the body (nested defs excluded) contain a ``raise``?
    raises: bool = False
    #: PartitionSpec constructions: {"line", "func", "axes": [[kind, val]]}
    specs: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    #: lax collectives: {"line", "leaf", "name", "axes": [[kind, val]]}
    collectives: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "qual": self.qual, "name": self.name, "cls": self.cls,
            "line": self.line,
            "calls": [c.to_dict() for c in self.calls],
            "locks": [a.to_dict() for a in self.locks],
            "set_iters": list(self.set_iters),
            "attrs": list(self.attrs),
            "self_sets": [list(s) for s in self.self_sets],
            "excepts": [dict(e) for e in self.excepts],
            "raises": self.raises,
            "specs": [dict(s) for s in self.specs],
            "collectives": [dict(c) for c in self.collectives],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FuncSummary":
        return cls(
            qual=d["qual"], name=d["name"], cls=d.get("cls"),
            line=int(d.get("line", 0)),
            calls=[CallSite.from_dict(c) for c in d.get("calls", ())],
            locks=[LockAcq.from_dict(a) for a in d.get("locks", ())],
            set_iters=[int(x) for x in d.get("set_iters", ())],
            attrs=[str(a) for a in d.get("attrs", ())],
            self_sets=[[str(s[0]), int(s[1])] for s in d.get("self_sets", ())],
            excepts=[dict(e) for e in d.get("excepts", ())],
            raises=bool(d.get("raises", False)),
            specs=[dict(s) for s in d.get("specs", ())],
            collectives=[dict(c) for c in d.get("collectives", ())],
        )


@dataclasses.dataclass
class ModuleSummary:
    """One module's contribution to the program view."""

    path: str  # root-relative posix path
    imports: Dict[str, str]  # local alias -> dotted target
    classes: Dict[str, List[str]]  # class name -> method names
    functions: List[FuncSummary]
    tags: List[str]
    #: module-level ``NAME = "literal"`` string constants — SVOC015
    #: resolves event types / metric families passed by constant, and
    #: SVOC017 resolves ``*_AXIS`` names through them
    consts: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: ``svoc: volatile(<reason>)`` comment annotations: line -> reason
    volatile: Dict[int, str] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "path": self.path, "imports": dict(self.imports),
            "classes": {k: list(v) for k, v in self.classes.items()},
            "functions": [f.to_dict() for f in self.functions],
            "tags": sorted(self.tags),
            "consts": dict(self.consts),
            "volatile": {str(k): v for k, v in self.volatile.items()},
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModuleSummary":
        return cls(
            path=d["path"], imports=dict(d.get("imports", {})),
            classes={k: list(v) for k, v in d.get("classes", {}).items()},
            functions=[FuncSummary.from_dict(f) for f in d.get("functions", ())],
            tags=list(d.get("tags", ())),
            consts={str(k): str(v) for k, v in d.get("consts", {}).items()},
            volatile={
                int(k): str(v) for k, v in d.get("volatile", {}).items()
            },
        )


def module_dotted(path: str) -> str:
    """``svoc_torch/utils/events.py`` -> ``svoc_torch.utils.events``."""
    name = path[:-3] if path.endswith(".py") else path
    if name.endswith("/__init__"):
        name = name[: -len("/__init__")]
    return name.replace("/", ".")


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_leaf_root(func: ast.AST) -> Tuple[str, Optional[str]]:
    """``(leaf, root)`` tolerating chained calls in the receiver
    (``self._resolve_journal().emit`` -> ("emit", "self"))."""
    leaf = ""
    if isinstance(func, ast.Attribute):
        leaf = func.attr
        node: ast.AST = func.value
    elif isinstance(func, ast.Name):
        return func.id, func.id
    else:
        node = func
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            break
    root = node.id if isinstance(node, ast.Name) else None
    return leaf, root


def is_emit_callsite(leaf: str, root: Optional[str], name: str, arg0) -> bool:
    """Journal emission, by shape: ``emit_event(...)``, ``.emit(...)``
    on a journal-named root, or ``.emit(...)`` whose first argument is
    an event-type literal (``"durability.drain"``) — the chained-
    receiver form."""
    if name == "emit_event" or name.endswith(".emit_event"):
        return True
    if leaf != "emit":
        return False
    if root in EVENT_ROOTS:
        return True
    if name.startswith("self.") and any(
        seg in ("journal", "_journal", "events", "_events")
        for seg in name.split(".")
    ):
        return True
    return bool(arg0 and isinstance(arg0, str) and _EVENT_TYPE_RE.match(arg0))


_SET_FACTORIES = {"set", "frozenset"}


def _iter_is_setish(expr: ast.AST) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call):
        return (_dotted(expr.func) or "") in _SET_FACTORIES
    return False


def _axis_tokens(nodes: Iterable[ast.AST]) -> List[List[str]]:
    """Axis-name tokens of a PartitionSpec/collective argument list:
    ``[kind, value]`` with kind ``lit`` (string literal), ``name``
    (bare Name, resolved at rule time), or ``expr`` (opaque — skipped
    by the rules, the under-approximation polarity)."""
    out: List[List[str]] = []
    for arg in nodes:
        elts = list(arg.elts) if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
        for node in elts:
            if isinstance(node, ast.Constant):
                if isinstance(node.value, str):
                    out.append(["lit", node.value])
                # None (replicated dim) and other constants: no axis
            elif isinstance(node, ast.Name):
                out.append(["name", node.id])
            else:
                out.append(["expr", ""])
    return out


def _collective_axis_args(node: ast.Call, leaf: str) -> List[ast.AST]:
    for kw in node.keywords:
        if kw.arg == "axis_name":
            return [kw.value]
    pos = 0 if leaf in _COLLECTIVE_AXIS_ARG0 else 1
    if len(node.args) > pos:
        return [node.args[pos]]
    return []


def _walk_executed_nodes(root: ast.AST) -> Iterable[ast.AST]:
    """Walk ``root`` skipping nested def/lambda bodies (their code does
    not execute where it is defined)."""
    stack: List[ast.AST] = [root]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class _FuncScan:
    """One function body's walk: calls, lock regions, emit-arg context,
    set iterations.  Nested def/lambda bodies are skipped — they get
    their own FuncSummary and their calls run under whatever locks hold
    at CALL time, not definition time."""

    def __init__(self, module_path: str, cls: Optional[str]):
        self.module_path = module_path
        self.cls = cls
        self.calls: List[CallSite] = []
        self.locks: List[LockAcq] = []
        self.set_iters: List[int] = []
        self.attrs: Set[str] = set()
        self.self_sets: List[List[Any]] = []
        self.excepts: List[Dict[str, Any]] = []
        self.raises = False
        self.specs: List[Dict[str, Any]] = []
        self.collectives: List[Dict[str, Any]] = []

    def scan(self, fn: ast.AST) -> None:
        for stmt in fn.body:
            self._visit(stmt, (), 0)

    def _visit(self, node: ast.AST, held: Tuple[str, ...], emit_line: int) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = list(held)
            for item in node.items:
                self._visit(item.context_expr, tuple(acquired), emit_line)
                lock = lock_identity(item.context_expr, self.module_path, self.cls)
                if lock is not None:
                    self.locks.append(
                        LockAcq(lock_id=lock, line=node.lineno, held=tuple(acquired))
                    )
                    acquired.append(lock)
            inner = tuple(acquired)
            for stmt in node.body:
                self._visit(stmt, inner, emit_line)
            return
        if isinstance(node, ast.Raise):
            self.raises = True
        elif isinstance(node, ast.Try):
            for handler in node.handlers:
                end = getattr(handler, "end_lineno", None) or handler.lineno
                self.excepts.append(
                    {
                        "line": handler.lineno,
                        "end": int(end),
                        "raises": any(
                            isinstance(n, ast.Raise)
                            for n in _walk_executed_nodes(handler)
                        ),
                        # `except X as e` with `e` read in the body: the
                        # error is CAPTURED (into a log, a verdict field,
                        # a bundle payload) rather than dropped — not a
                        # silent degrade under SVOC014
                        "uses_exc": bool(handler.name)
                        and any(
                            isinstance(n, ast.Name)
                            and n.id == handler.name
                            and isinstance(n.ctx, ast.Load)
                            for n in _walk_executed_nodes(handler)
                        ),
                    }
                )
        elif isinstance(node, ast.Attribute):
            self.attrs.add(node.attr)
            if (
                isinstance(node.ctx, ast.Store)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                self.self_sets.append([node.attr, node.lineno])
        if isinstance(node, ast.Call):
            name = _dotted(node.func) or ""
            leaf, root = _call_leaf_root(node.func)
            arg0 = None
            arg0_name = None
            if node.args:
                if isinstance(node.args[0], ast.Constant):
                    if isinstance(node.args[0].value, str):
                        arg0 = node.args[0].value
                elif isinstance(node.args[0], ast.Name):
                    arg0_name = node.args[0].id
            if leaf in _SPEC_LEAVES:
                self.specs.append(
                    {
                        "line": node.lineno,
                        "func": name or leaf,
                        "axes": _axis_tokens(node.args),
                    }
                )
            elif leaf in _COLLECTIVE_LEAVES:
                self.collectives.append(
                    {
                        "line": node.lineno,
                        "leaf": leaf,
                        "name": name,
                        "axes": _axis_tokens(_collective_axis_args(node, leaf)),
                    }
                )
            self.calls.append(
                CallSite(
                    name=name, leaf=leaf, root=root,
                    line=node.lineno, col=node.col_offset,
                    arg0=arg0, locks=held, emit_arg_of=emit_line,
                    arg0_name=arg0_name,
                )
            )
            child_emit = (
                node.lineno
                if is_emit_callsite(leaf, root, name, arg0)
                else emit_line
            )
            self._visit(node.func, held, emit_line)
            for arg in node.args:
                self._visit(arg, held, child_emit)
            for kw in node.keywords:
                self._visit(kw.value, held, child_emit)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            if _iter_is_setish(node.iter):
                self.set_iters.append(node.iter.lineno)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            for gen in node.generators:
                if _iter_is_setish(gen.iter):
                    self.set_iters.append(gen.iter.lineno)
        for child in ast.iter_child_nodes(node):
            self._visit(child, held, emit_line)


def _import_map(tree: ast.Module, mod_dotted: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    pkg_parts = mod_dotted.split(".")[:-1] if mod_dotted else []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    out[alias.name.split(".")[0]] = alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                # relative import: climb from this module's package
                up = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                base = ".".join(up + ([base] if base else []))
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                out[local] = f"{base}.{alias.name}" if base else alias.name
    return out


def summarize_module(
    path: str,
    tree: ast.Module,
    tags: Iterable[str] = (),
    source_lines: Optional[List[str]] = None,
) -> ModuleSummary:
    """Reduce one parsed module to its interprocedural summary.

    ``source_lines`` (when the caller has them) feeds the
    ``# svoc: volatile(...)`` annotation scan — comments are invisible
    to the AST."""
    imports = _import_map(tree, module_dotted(path))
    classes: Dict[str, List[str]] = {}
    functions: List[FuncSummary] = []
    consts: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if (
                isinstance(target, ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                consts[target.id] = node.value.value
    volatile: Dict[int, str] = {}
    if source_lines:
        # tokenize, not a per-line regex: a docstring or a hint string
        # DESCRIBING the annotation grammar must not register as one
        # (the analysis package documents it, and would otherwise flag
        # itself stale).
        reader = iter([line + "\n" for line in source_lines]).__next__
        try:
            for tok in tokenize.generate_tokens(reader):
                if tok.type != tokenize.COMMENT:
                    continue
                m = _VOLATILE_RE.search(tok.string)
                if m:
                    volatile[tok.start[0]] = m.group(1).strip()
        except (tokenize.TokenizeError, IndentationError, SyntaxError):
            pass  # the file parsed via ast, so this is belt-and-braces

    def walk_defs(node: ast.AST, cls: Optional[str], prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                classes.setdefault(child.name, [])
                walk_defs(child, child.name, prefix)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = (
                    f"{cls}.{child.name}"
                    if cls
                    else (f"{prefix}.{child.name}" if prefix else child.name)
                )
                if cls:
                    classes.setdefault(cls, []).append(child.name)
                scan = _FuncScan(path, cls)
                scan.scan(child)
                functions.append(
                    FuncSummary(
                        qual=qual, name=child.name, cls=cls, line=child.lineno,
                        calls=scan.calls, locks=scan.locks,
                        set_iters=scan.set_iters,
                        attrs=sorted(scan.attrs),
                        self_sets=scan.self_sets,
                        excepts=scan.excepts,
                        raises=scan.raises,
                        specs=scan.specs,
                        collectives=scan.collectives,
                    )
                )
                # nested defs: scanned separately (locks don't leak in)
                walk_defs(child, cls, qual if not cls else f"{cls}.{child.name}")

    walk_defs(tree, None, "")
    return ModuleSummary(
        path=path, imports=imports, classes=classes,
        functions=functions, tags=list(tags),
        consts=consts, volatile=volatile,
    )


class Program:
    """The whole analyzed package, indexed for resolution."""

    def __init__(self, modules: Iterable[ModuleSummary]):
        self.modules: Dict[str, ModuleSummary] = {m.path: m for m in modules}
        self.by_dotted: Dict[str, str] = {
            module_dotted(p): p for p in self.modules
        }
        #: "path::qual" -> FuncSummary
        self.funcs: Dict[str, FuncSummary] = {}
        #: method leaf name -> [func ids] (class methods only)
        self._methods: Dict[str, List[str]] = {}
        #: per-module: top-level function name -> qual
        self._toplevel: Dict[str, Dict[str, str]] = {}
        for m in self.modules.values():
            tl: Dict[str, str] = {}
            for f in m.functions:
                fid = f"{m.path}::{f.qual}"
                self.funcs[fid] = f
                if f.cls:
                    self._methods.setdefault(f.name, []).append(fid)
                elif "." not in f.qual:
                    tl[f.name] = f.qual
            self._toplevel[m.path] = tl

    # -- resolution ---------------------------------------------------------

    def module_of(self, func_id: str) -> str:
        return func_id.split("::", 1)[0]

    def _resolve_in_module(self, mpath: str, rest: str) -> Optional[str]:
        m = self.modules.get(mpath)
        if m is None:
            return None
        parts = rest.split(".")
        if len(parts) == 1:
            if parts[0] in self._toplevel.get(mpath, {}):
                return f"{mpath}::{parts[0]}"
            if parts[0] in m.classes:  # constructor -> __init__
                if "__init__" in m.classes[parts[0]]:
                    return f"{mpath}::{parts[0]}.__init__"
            return None
        if len(parts) == 2 and parts[0] in m.classes:
            if parts[1] in m.classes[parts[0]]:
                return f"{mpath}::{parts[0]}.{parts[1]}"
        return None

    def _resolve_dotted(self, full: str) -> Optional[str]:
        """Longest module-prefix match, remainder inside that module."""
        parts = full.split(".")
        for k in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:k])
            mpath = self.by_dotted.get(mod)
            if mpath is not None:
                return self._resolve_in_module(mpath, ".".join(parts[k:]))
        return None

    def resolve(self, module: ModuleSummary, call: CallSite, caller: Optional[FuncSummary] = None) -> Optional[str]:
        """Best-effort callee id for one callsite, or None."""
        name = call.name
        if name:
            if name.startswith("self."):
                rest = name[5:]
                if "." not in rest and caller is not None and caller.cls:
                    if rest in module.classes.get(caller.cls, ()):
                        return f"{module.path}::{caller.cls}.{rest}"
                # self.a.b(...) falls through to the method fallback
            else:
                head, _, tail = name.partition(".")
                target = module.imports.get(head)
                if target is not None:
                    full = f"{target}.{tail}" if tail else target
                    resolved = self._resolve_dotted(full)
                    if resolved is None and not tail:
                        # `from m import f` where m itself is a module
                        mpath = self.by_dotted.get(target)
                        if mpath is None and "." in target:
                            mod, _, leaf = target.rpartition(".")
                            mpath = self.by_dotted.get(mod)
                            if mpath is not None:
                                return self._resolve_in_module(mpath, leaf)
                    if resolved is not None:
                        return resolved
                else:
                    local = self._resolve_in_module(module.path, name)
                    if local is not None:
                        return local
                    resolved = self._resolve_dotted(name)
                    if resolved is not None:
                        return resolved
        # unique-method fallback
        leaf = call.leaf
        if leaf and leaf not in _COMMON_METHODS and not leaf.startswith("__"):
            candidates = self._methods.get(leaf, ())
            if len(candidates) == 1:
                return candidates[0]
        return None


def find_hazard(
    program: Program,
    root_module: ModuleSummary,
    root_calls: List[CallSite],
    call_pred,
    func_pred=None,
    root_func: Optional[FuncSummary] = None,
    max_depth: int = 16,
    root_label: str = "",
) -> Optional[Tuple[str, int, Tuple[str, ...]]]:
    """BFS the resolved call graph from ``root_calls``.

    ``call_pred(call, module) -> Optional[str]`` labels a hazardous
    callsite; ``func_pred(func, module) -> Optional[Tuple[str, int]]``
    labels a function-level fact (e.g. a set-iteration line).  Returns
    ``(hazard_path, hazard_line, path_trace)`` for the first hazard
    found (shortest-first by construction), or None.
    """
    queue: List[Tuple[str, int, Tuple[str, ...]]] = []
    visited: Set[str] = set()
    for call in root_calls:
        label = call_pred(call, root_module)
        if label is not None:
            trace = (root_label or f"{root_module.path}:{call.line}",
                     f"{label} at {root_module.path}:{call.line}")
            return root_module.path, call.line, trace
        target = program.resolve(root_module, call, root_func)
        if target is not None and target not in visited:
            visited.add(target)
            hop = f"{root_module.path}:{call.line} {call.name or call.leaf}()"
            queue.append((target, 1, ((root_label,) if root_label else ()) + (hop,)))
    while queue:
        fid, depth, trace = queue.pop(0)
        fs = program.funcs[fid]
        mpath = program.module_of(fid)
        module = program.modules[mpath]
        here = trace + (f"-> {mpath}::{fs.qual}",)
        if func_pred is not None:
            fact = func_pred(fs, module)
            if fact is not None:
                label, line = fact
                return mpath, line, here + (f"{label} at {mpath}:{line}",)
        for call in fs.calls:
            label = call_pred(call, module)
            if label is not None:
                return (
                    mpath, call.line,
                    here + (f"{label} at {mpath}:{call.line}",),
                )
            if depth < max_depth:
                target = program.resolve(module, call, fs)
                if target is not None and target not in visited:
                    visited.add(target)
                    queue.append(
                        (target, depth + 1,
                         here + (f"{mpath}:{call.line} {call.name or call.leaf}()",))
                    )
    return None
