"""Lock-acquisition model for the interprocedural rules.

The flight recorder's deadlock contract (``utils/events.py`` docstring)
is *the journal lock is a leaf*: subscriber callbacks run on the
emitting thread, so an emitter holding its own lock across
``journal.emit`` deadlocks the moment a subscriber re-enters that lock.
Nothing enforced it — the contract lived in a docstring and in per-PR
review vigilance.  This module is the enforcement half: a purely
lexical model of

- **which expressions acquire a lock** — ``with self._lock:`` /
  ``with _log_lock:`` / ``with threading.Lock():`` — recognized by the
  same identifier-segment heuristic SVOC006 uses (``sse_lock`` is a
  lock, ``block`` is not), plus direct ``threading.Lock/RLock/…``
  constructions;
- **lock identity** — the attribute path, qualified by module and
  (for ``self.*`` locks) the enclosing class, so every method of
  ``CommitIntentWAL`` holding ``self._lock`` holds *the same* lock,
  while ``ClaimRouter.self._lock`` is a different one;
- **what runs while a lock is held** — the per-callsite ``locks``
  annotation :mod:`svoc_torch.analysis.callgraph` stamps during
  extraction, honoring the executes-here discipline (a ``def`` nested
  inside a ``with`` block only *defines* its body — calls inside it
  carry no lock).

:class:`LockModel` folds the per-module summaries into the global
acquisition-order graph (lock A → lock B when B can be acquired while
A is held, lexically or through a resolved call chain) and detects
cycles — the classic ABBA deadlock shape — for SVOC010's lock-order
half.

Like everything in ``svoc_torch.analysis``: pure ``ast``, no JAX, no
imports of analyzed code.  Acquisitions via ``lock.acquire()`` are out
of scope (the repo convention is ``with``-based locking; an
``.acquire()`` call would itself be worth a finding some day).

The port's copy of :mod:`svoc_tpu.analysis.concurrency` (``concurrency.py:1-187``),
unchanged but for the package's name.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

#: Identifier segments that name a lock (shared shape with SVOC006's
#: heuristic): ``lock`` / ``_lock`` / ``sse_lock`` / ``rlock`` —
#: matched per ``_``-separated segment so ``block``/``blocker`` don't.
_LOCK_SEG_RE = re.compile(r"(?:^|_)r?locks?(?:$|_)")

#: Constructors that ARE locks regardless of the bound name.
_LOCK_FACTORIES = {
    "threading.Lock",
    "threading.RLock",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
    "threading.Condition",
    "Lock",
    "RLock",
}

#: The journal-internal module: its locks implement the leaf contract
#: and are exempt from SVOC010 (the journal holding its OWN leaf lock
#: around the ring append is the design, not a hazard).
JOURNAL_MODULE_SUFFIX = "utils/events.py"


def dotted_path(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains (like jitmap.dotted_name)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _segments_lock_like(dotted: str) -> bool:
    return any(_LOCK_SEG_RE.search(part.lower()) for part in dotted.split("."))


def lock_identity(
    expr: ast.AST, module_path: str, cls: Optional[str]
) -> Optional[str]:
    """The lock id a ``with``-item acquires, or None when the context
    manager isn't a lock.

    Identity is the attribute path scoped by module (and by class for
    ``self.*`` attributes): ``svoc_torch/durability/wal.py::
    CommitIntentWAL.self._lock``.  Two methods of one class holding
    ``self._lock`` therefore hold ONE lock; the same attribute name in
    another class is a DIFFERENT lock.  That is exactly as precise as a
    lexical pass can be — aliasing a lock through a parameter defeats
    it, an accepted trade documented in docs/STATIC_ANALYSIS.md.
    """
    dotted = dotted_path(expr)
    if dotted is not None:
        if not _segments_lock_like(dotted):
            return None
        if dotted.startswith("self.") and cls:
            return f"{module_path}::{cls}.{dotted}"
        return f"{module_path}::{dotted}"
    if isinstance(expr, ast.Call):
        fname = dotted_path(expr.func)
        if fname in _LOCK_FACTORIES:
            # An inline `with threading.Lock():` guards nothing shared
            # but is still a lock acquisition; identity is positional.
            return f"{module_path}::<lock>@{expr.lineno}"
        # `with self._lock_for(key):` — a lock factory method; keep the
        # call path as identity (per-key locks collapse to one id).
        if fname is not None and _segments_lock_like(fname):
            suffix = f"{fname}()"
            if fname.startswith("self.") and cls:
                return f"{module_path}::{cls}.{suffix}"
            return f"{module_path}::{suffix}"
    return None


def is_journal_lock(lock_id: str) -> bool:
    """The leaf-lock exemption: locks inside the journal module (the
    event ring lock, the rotating-writer lock, the writer-pool lock)
    are the *documented leaves* — SVOC010 fires on every OTHER lock
    held on a path into ``emit``."""
    module = lock_id.split("::", 1)[0]
    return module.endswith(JOURNAL_MODULE_SUFFIX)


class LockModel:
    """The program-wide acquisition-order graph.

    Built by :func:`build_lock_model` from the extracted summaries:
    nodes are lock ids, an edge ``A -> B`` means some execution path
    acquires ``B`` while ``A`` is held — either lexically nested
    ``with`` blocks, or a call made under ``A`` that (transitively,
    through the resolved call graph) reaches a function acquiring
    ``B``.  ``cycles()`` reports the elementary cycles — each one an
    ABBA deadlock candidate.
    """

    def __init__(self) -> None:
        #: edge -> one witness (path, line, trace) for the finding
        self.edges: Dict[Tuple[str, str], Tuple[str, int, Tuple[str, ...]]] = {}

    def add_edge(
        self,
        held: str,
        acquired: str,
        path: str,
        line: int,
        trace: Tuple[str, ...] = (),
    ) -> None:
        if held == acquired:
            return  # re-entrant self-acquisition is SVOC010's A-part job
        self.edges.setdefault((held, acquired), (path, line, trace))

    def cycles(self) -> List[List[str]]:
        """Elementary cycles (as lock-id lists, each starting at its
        lexicographically smallest member so duplicates collapse)."""
        graph: Dict[str, Set[str]] = {}
        for a, b in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        seen_cycles: Set[Tuple[str, ...]] = set()
        out: List[List[str]] = []

        def dfs(start: str, node: str, stack: List[str], on_stack: Set[str]):
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    cycle = stack[:]
                    # canonical rotation: start at min element
                    k = cycle.index(min(cycle))
                    canon = tuple(cycle[k:] + cycle[:k])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(canon))
                elif nxt not in on_stack and nxt > start:
                    # only explore nodes > start: each cycle found once,
                    # rooted at its smallest member
                    stack.append(nxt)
                    on_stack.add(nxt)
                    dfs(start, nxt, stack, on_stack)
                    on_stack.discard(nxt)
                    stack.pop()

        for node in sorted(graph):
            dfs(node, node, [node], {node})
        return out
