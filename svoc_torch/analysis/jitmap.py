"""Per-module AST pass locating traced bodies and jit call contracts.

Everything downstream (the SVOC rules) keys off what this pass finds:

- which function bodies are *traced* — decorated with ``@jax.jit`` /
  ``@pjit`` / ``@partial(jax.jit, ...)``, wrapped by a ``jax.jit(fn)``
  / ``shard_map(fn, ...)`` call, or passed as a jit'd lambda;
- each traced callable's **contract**: parameter names, declared
  ``static_argnums`` / ``static_argnames``, ``donate_argnums`` /
  ``donate_argnames`` — resolved to the wrapped function's signature
  when it is defined in the same module;
- ``stage_span("...")`` span bodies (the observability layer's dispatch
  wrappers) with their stage names.

Purely lexical: no imports of the analyzed module, no cross-module
resolution.  A jitted symbol imported from another module is invisible
here — an accepted precision trade (the rules are a merge gate, not a
soundness proof), noted in docs/STATIC_ANALYSIS.md.

The port's copy of :mod:`svoc_tpu.analysis.jitmap` (``jitmap.py:1-358``),
unchanged but for the package's name. ``SHARD_MAP_CALLABLES`` already matches the port's
``svoc_torch.parallel.sharded.shard_map`` (its leaf), so a body that
runs once a mesh slot counts as traced, as a ``shard_map`` body does in
the reference.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple, Union

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

#: Dotted names that construct a traced callable.
JIT_CALLABLES = {
    "jax.jit",
    "jit",
    "pjit",
    "jax.pjit",
    "pjit.pjit",
    "jax.experimental.pjit.pjit",
}
SHARD_MAP_CALLABLES = {
    "shard_map",
    "jax.shard_map",
    "jax.experimental.shard_map.shard_map",
}
PARTIAL_CALLABLES = {"partial", "functools.partial"}
#: Span context managers of the observability layer (utils/metrics.py).
SPAN_CALLABLES = {"stage_span"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_jit_name(name: Optional[str]) -> bool:
    return name in JIT_CALLABLES


def _is_shard_map_name(name: Optional[str]) -> bool:
    return name is not None and (
        name in SHARD_MAP_CALLABLES or name.endswith(".shard_map")
    )


def _const_ints(node: ast.AST) -> Set[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out: Set[int] = set()
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, int):
                out.add(elt.value)
        return out
    return set()


def _const_strs(node: ast.AST) -> Set[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out: Set[str] = set()
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.add(elt.value)
        return out
    return set()


@dataclasses.dataclass
class JitInfo:
    """One traced callable's contract, as far as the module shows it."""

    name: str  # best-known symbol name ("<lambda>" when anonymous)
    body: Optional[FunctionNode]  # the traced def, when module-local
    params: List[str] = dataclasses.field(default_factory=list)
    static_argnums: Set[int] = dataclasses.field(default_factory=set)
    static_argnames: Set[str] = dataclasses.field(default_factory=set)
    donate_argnums: Set[int] = dataclasses.field(default_factory=set)
    donate_argnames: Set[str] = dataclasses.field(default_factory=set)
    via: str = "decorator"  # decorator | wrapper-call | shard_map
    line: int = 0

    def is_static_position(self, index: int) -> bool:
        if index in self.static_argnums:
            return True
        if index < len(self.params):
            return self.params[index] in self.static_argnames
        return False

    def donated_positions(self) -> Set[int]:
        out = set(self.donate_argnums)
        for name in self.donate_argnames:
            if name in self.params:
                out.add(self.params.index(name))
        return out


@dataclasses.dataclass
class SpanBody:
    """One ``with stage_span("<stage>"):`` block."""

    stage: Optional[str]  # None when the name isn't a literal
    node: ast.With
    line: int


def _params_of(fn: FunctionNode) -> List[str]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs] + [a.arg for a in args.args]
    return names


def _jit_kwargs(call: ast.Call, info: JitInfo) -> None:
    for kw in call.keywords:
        if kw.arg == "static_argnums":
            info.static_argnums |= _const_ints(kw.value)
        elif kw.arg == "static_argnames":
            info.static_argnames |= _const_strs(kw.value)
        elif kw.arg == "donate_argnums":
            info.donate_argnums |= _const_ints(kw.value)
        elif kw.arg == "donate_argnames":
            info.donate_argnames |= _const_strs(kw.value)


class JitMap:
    """The module's traced bodies, callable contracts, and span blocks."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        #: every node, pre-order — rules iterate this instead of paying
        #: a fresh ``ast.walk`` generator per rule (the whole-repo run's
        #: dominant cost in profiling was repeated tree walks)
        self.nodes: List[ast.AST] = []
        #: traced function/lambda nodes -> JitInfo (deduped)
        self.traced: Dict[FunctionNode, JitInfo] = {}
        #: symbol name -> JitInfo, for call-site contract checks
        self.by_name: Dict[str, JitInfo] = {}
        #: every ``with stage_span(...)`` block
        self.spans: List[SpanBody] = []
        #: parent links for ancestry queries (loops, with-blocks, defs)
        self.parents: Dict[ast.AST, ast.AST] = {}
        #: module-local def name -> node (for resolving jax.jit(f))
        self._defs: Dict[str, FunctionNode] = {}
        self._collect()

    # -- collection ---------------------------------------------------------

    def _collect(self) -> None:
        # One pass builds nodes+parents+defs; defs must all be known
        # before call scanning (jax.jit(f) can precede f's def), so the
        # calls/withs scan runs over the collected list afterwards.
        stack = [self.tree]
        while stack:
            node = stack.pop()
            self.nodes.append(node)
            children = list(ast.iter_child_nodes(node))
            for child in children:
                self.parents[child] = node
            stack.extend(reversed(children))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # last definition wins, like runtime rebinding
                self._defs[node.name] = node
        for node in self.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_decorators(node)
            elif isinstance(node, ast.Call):
                self._scan_call(node)
            elif isinstance(node, ast.With):
                self._scan_with(node)

    def _scan_decorators(self, fn: ast.FunctionDef) -> None:
        for dec in fn.decorator_list:
            info = self._jit_info_from_expr(dec)
            if info is None:
                continue
            info.name = fn.name
            info.body = fn
            info.params = _params_of(fn)
            info.line = fn.lineno
            self._register(info)

    def _jit_info_from_expr(self, expr: ast.AST) -> Optional[JitInfo]:
        """JitInfo for ``jax.jit`` / ``jax.jit(...)`` / ``partial(jax.jit,
        ...)`` decorator expressions; None when not jit-ish."""
        name = dotted_name(expr)
        if _is_jit_name(name):
            return JitInfo(name="", body=None, via="decorator")
        if not isinstance(expr, ast.Call):
            return None
        fname = dotted_name(expr.func)
        if _is_jit_name(fname):
            info = JitInfo(name="", body=None, via="decorator")
            _jit_kwargs(expr, info)
            return info
        if fname in PARTIAL_CALLABLES and expr.args:
            inner = dotted_name(expr.args[0])
            if _is_jit_name(inner):
                info = JitInfo(name="", body=None, via="decorator")
                _jit_kwargs(expr, info)
                return info
        return None

    def _scan_call(self, call: ast.Call) -> None:
        fname = dotted_name(call.func)
        is_jit = _is_jit_name(fname)
        is_smap = _is_shard_map_name(fname)
        if not (is_jit or is_smap) or not call.args:
            return
        target = call.args[0]
        info = JitInfo(
            name="<expr>",
            body=None,
            via="shard_map" if is_smap else "wrapper-call",
            line=call.lineno,
        )
        _jit_kwargs(call, info)
        if isinstance(target, ast.Lambda):
            info.name = "<lambda>"
            info.body = target
            info.params = _params_of(target)
        elif isinstance(target, ast.Name):
            info.name = target.id
            body = self._defs.get(target.id)
            if body is not None:
                info.body = body
                info.params = _params_of(body)
        else:
            return  # jit of an attribute/call result: body unknowable here
        # The WRAPPED name must not inherit the contract: a plain
        # `step(x)` call of the undecorated function neither donates nor
        # dispatches through jit — only the ASSIGNED name does.
        self._register(info, bind_name=False)
        # `f = jax.jit(g, ...)` / `return jax.jit(g, ...)`: bind the
        # contract to the assigned name, so call sites of `f` check.
        # The bound copy carries the ASSIGNED name — findings must name
        # the callable the caller invoked (the set fields are shared,
        # so later contract merges stay visible).
        parent = self.parents.get(call)
        if isinstance(parent, ast.Assign):
            for tgt in parent.targets:
                if isinstance(tgt, ast.Name):
                    self.by_name[tgt.id] = dataclasses.replace(
                        info, name=tgt.id
                    )

    def _register(self, info: JitInfo, bind_name: bool = True) -> None:
        if info.body is not None:
            existing = self.traced.get(info.body)
            if existing is not None:
                # merge contracts (e.g. decorated AND re-wrapped)
                existing.static_argnums |= info.static_argnums
                existing.static_argnames |= info.static_argnames
                existing.donate_argnums |= info.donate_argnums
                existing.donate_argnames |= info.donate_argnames
                info = existing
            else:
                self.traced[info.body] = info
        if bind_name and info.name and not info.name.startswith("<"):
            self.by_name[info.name] = info

    def _scan_with(self, node: ast.With) -> None:
        for item in node.items:
            expr = item.context_expr
            if not isinstance(expr, ast.Call):
                continue
            fname = dotted_name(expr.func) or ""
            leaf = fname.rsplit(".", 1)[-1]
            if leaf in SPAN_CALLABLES or fname.endswith(".span"):
                stage = None
                if expr.args and isinstance(expr.args[0], ast.Constant):
                    if isinstance(expr.args[0].value, str):
                        stage = expr.args[0].value
                self.spans.append(SpanBody(stage=stage, node=node, line=node.lineno))

    # -- queries ------------------------------------------------------------

    def traced_roots(self) -> List[Tuple[FunctionNode, JitInfo]]:
        """Traced bodies whose enclosing function isn't itself traced —
        walking a root's subtree covers its nested traced defs, so rules
        visit each traced statement exactly once."""
        out = []
        for fn, info in self.traced.items():
            if not any(
                anc is not fn and anc in self.traced for anc in self.ancestors(fn)
            ):
                out.append((fn, info))
        return sorted(out, key=lambda pair: pair[0].lineno)

    def ancestors(self, node: ast.AST):
        seen = node
        while seen in self.parents:
            seen = self.parents[seen]
            yield seen

    def enclosing_function(
        self, node: ast.AST
    ) -> Optional[FunctionNode]:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return anc
        return None

    def in_traced_body(self, node: ast.AST) -> Optional[JitInfo]:
        """The innermost traced body containing ``node``, if any."""
        if node in self.traced:
            return self.traced[node]
        for anc in self.ancestors(node):
            if anc in self.traced:
                return self.traced[anc]
        return None

    def inside_loop(self, node: ast.AST) -> bool:
        """True when ``node`` executes per loop iteration: a For/While/
        comprehension ancestor with no function boundary in between (a
        def inside a loop only runs its *body* when called, not when
        defined)."""
        loops = (
            ast.For,
            ast.While,
            ast.AsyncFor,
            ast.ListComp,
            ast.SetComp,
            ast.DictComp,
            ast.GeneratorExp,
        )
        for anc in self.ancestors(node):
            if isinstance(anc, loops):
                return True
            if isinstance(
                anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                return False
        return False
