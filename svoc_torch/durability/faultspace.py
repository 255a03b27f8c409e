"""Named fault points: the durable plane's fault surface, enumerated.

Mirrors :mod:`svoc_tpu.durability.faultspace` (``faultspace.py:1-586``):
the declaration registry (:class:`FaultPointSpec`, :func:`declare`,
:func:`surface`, ``SURFACE_MODULES``/:func:`load_surface` ``:151-165``,
naming the port's modules), the points declared here for owners that
cannot import this module at their own import (``serving.step.post``
``:177``, the chain adapter's two RPC boundaries, the snapshot's two
rename boundaries), :class:`FaultEvent` (``:338``),
:func:`torn_line_write` (``:383``), the armed :class:`FaultController`
(``:396``: schedules keyed on the Nth matching firing, the ``kill``,
``torn`` and ``error`` actions, the durable fired log), the process hook
(:func:`arm`, :func:`disarm`, :func:`armed`, :func:`fault_point`) and
:func:`read_fired_log` (``:565``), and the five cluster points
(``:229-270``, ``:326-334``: ``cluster.forward.pre_send``, the three
``cluster.migrate.*`` boundaries and ``replica.kill``), which
:mod:`svoc_torch.cluster` fires, and the five ``reconfig.*`` points
(``:271-325``), which the live reconfiguration plane
(:mod:`svoc_torch.cluster.reconfig`) fires.

Mechanics:

- Durable/RPC boundaries **declare themselves** at module import
  (:func:`declare`) with owner, threatened invariant, valid actions,
  reaching smoke(s), and stage.
- The same call sites **fire** :func:`fault_point` at runtime.  With no
  controller armed (production, every test) that is one global load and
  a ``None`` check.  With a controller armed (the crash harness), each
  firing is counted per point — schedules key on (point, Nth matching
  firing), never on wall time — and the scheduled :class:`FaultEvent`\\ s
  execute at their Nth matching firing:

  ========  ==============================================================
  action    semantics
  ========  ==============================================================
  kill      SIGKILL *now*.  Bytes already written are durable (process
            death does not empty the page cache) — this is the
            "kill between instructions" fault.
  torn      write *half* of the pending record (no newline), fsync it,
            then SIGKILL — the mid-append power-cut fault.  Valid only
            at points whose call site passes a ``torn=`` writer.
  error     raise :class:`svoc_torch.resilience.faults.InjectedFault` out
            of the boundary — the injected-RPC-fault lane, composing
            with the retry/resume/breaker machinery exactly like a
            :class:`~svoc_torch.resilience.faults.FaultInjectingBackend`.
  ========  ==============================================================

- Every firing is journaled to a **durable fired log** (first firing
  per point + every executed action, fsynced) so a SIGKILLed child
  still witnesses its coverage.

The controller deliberately does NOT emit journal events at fire time:
fault points fire under the WAL/adapter locks, and the journal lock is
a leaf — the ``chaos.*`` events are emitted by the *harness* at
arm/summary time, never mid-fire.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from svoc_torch.resilience.faults import InjectedFault

#: The harnesses a point may name as its witness (``smokes``).
SMOKE_FUZZ = "fuzz"    # svoc_torch/tools/chaos_fuzz.py — the light durable-plane harness
SMOKE_CRASH = "crash"  # svoc_torch/tools/crash_smoke.py — the kill/restart matrix
SMOKE_CLUSTER = "cluster"  # svoc_torch/tools/cluster_smoke.py — the multi-replica fleet
SMOKE_RECONFIG = "reconfig"  # svoc_torch/tools/reconfig_smoke.py — live reconfiguration

ACTIONS = ("kill", "torn", "error")
STAGES = ("run", "recovery")


@dataclasses.dataclass(frozen=True)
class FaultPointSpec:
    """One declared point of the fault surface (the inventory row)."""

    name: str
    owner: str           # owning module path, e.g. "svoc_torch/durability/wal.py"
    invariant: str       # the durability invariant a fault here threatens
    actions: Tuple[str, ...]      # valid FaultEvent actions at this point
    smokes: Tuple[str, ...]       # which harness(es) reach + assert it
    modes: Tuple[str, ...] = ("per_tx", "batched")  # commit modes reaching it
    stage: str = "run"   # "run" fires in the serving loop, "recovery" on restart

    def __post_init__(self):
        if not self.actions or any(a not in ACTIONS for a in self.actions):
            raise ValueError(f"{self.name}: invalid actions {self.actions}")
        if self.stage not in STAGES:
            raise ValueError(f"{self.name}: invalid stage {self.stage!r}")
        for s in self.smokes:
            if s not in (SMOKE_FUZZ, SMOKE_CRASH, SMOKE_CLUSTER, SMOKE_RECONFIG):
                raise ValueError(f"{self.name}: unknown smoke {s!r}")


_REGISTRY: Dict[str, FaultPointSpec] = {}
_REGISTRY_LOCK = threading.Lock()


def declare(
    name: str,
    *,
    owner: str,
    invariant: str,
    actions: Sequence[str],
    smokes: Sequence[str],
    modes: Sequence[str] = ("per_tx", "batched"),
    stage: str = "run",
) -> str:
    """Register one fault point; returns ``name`` so call sites can bind
    it to a module constant.  Idempotent for identical re-declaration
    (module reloads); a CONFLICTING re-declaration raises — two
    boundaries must never share a name."""
    spec = FaultPointSpec(
        name=name,
        owner=owner,
        invariant=invariant,
        actions=tuple(actions),
        smokes=tuple(smokes),
        modes=tuple(modes),
        stage=stage,
    )
    with _REGISTRY_LOCK:
        existing = _REGISTRY.get(name)
        if existing is not None and existing != spec:
            raise ValueError(
                f"fault point {name!r} re-declared with a different spec"
            )
        _REGISTRY[name] = spec
    return name


def surface() -> Dict[str, FaultPointSpec]:
    """The declared fault surface, name-sorted — import
    :data:`SURFACE_MODULES` first for the full inventory."""
    with _REGISTRY_LOCK:
        return {name: _REGISTRY[name] for name in sorted(_REGISTRY)}


#: Importing these modules declares the whole surface, and names every
#: module that fires a point.  The io/chain, utils/checkpoint and
#: cluster points are declared below in THIS module (circular-import
#: notes there); the cluster modules fire them.
SURFACE_MODULES = (
    "svoc_torch.durability.wal",
    "svoc_torch.durability.chainlog",
    "svoc_torch.durability.reconcile",
    "svoc_torch.durability.recovery",
    "svoc_torch.cluster.router",
    "svoc_torch.cluster.scenario",
)


def load_surface() -> Dict[str, FaultPointSpec]:
    """Import every surface-owning module, then return :func:`surface`."""
    import importlib

    for module in SURFACE_MODULES:
        importlib.import_module(module)
    return surface()


# -- points whose owners cannot import this module at their own import ----
# The serving scenario's step boundary (the ``pre_snapshot`` kill
# point) fires from ``durability/scenario.py``, which imports the full
# fabric/serving stack — declaring it here keeps surface enumeration
# light.  The chain adapter's RPC boundaries fire from
# ``svoc_torch/io/chain.py``, which ``durability/chainlog.py`` imports —
# a top-level import back into this package would be circular, so
# io/chain.py binds :func:`fault_point` lazily and the declarations
# live here.  Every OTHER point is declared by its owning module.
SERVING_STEP_POST = declare(
    "serving.step.post",
    owner="svoc_torch/durability/scenario.py",
    invariant="post-commit pre-snapshot state is recoverable from the "
    "journal tail + WAL alone",
    actions=("kill",),
    smokes=(SMOKE_CRASH,),
    stage="run",
)

CHAIN_TX_PRE_INVOKE = declare(
    "chain.tx.pre_invoke",
    owner="svoc_torch/io/chain.py",
    invariant="a tx that never went out (RPC fault / kill after the "
    "intent) must classify stranded and resend exactly once",
    actions=("kill", "error"),
    smokes=(SMOKE_FUZZ,),
    modes=("per_tx",),
)

CHAIN_BATCH_PRE_RPC = declare(
    "chain.batch.pre_rpc",
    owner="svoc_torch/io/chain.py",
    invariant="a batch intent with no RPC behind it must digest-"
    "classify every slot stranded; an RPC fault surfaces as a counted "
    "failure, never a silent partial",
    actions=("kill", "error"),
    smokes=(SMOKE_FUZZ,),
    modes=("batched",),
)

# ``utils/checkpoint.save_snapshot`` fires these (same circularity:
# ``durability/__init__`` → ``recovery`` → ``checkpoint``, so the
# declarations live here and checkpoint imports lazily at call time).
SNAPSHOT_PRE_RENAME = declare(
    "snapshot.pre_rename",
    owner="svoc_torch/utils/checkpoint.py",
    invariant="a kill before the rename leaves the previous snapshot "
    "authoritative — recovery rolls forward from it on the journal "
    "tail + WAL, never reads the .tmp",
    actions=("kill",),
    smokes=(SMOKE_FUZZ,),
)
SNAPSHOT_POST_RENAME = declare(
    "snapshot.post_rename",
    owner="svoc_torch/utils/checkpoint.py",
    invariant="a snapshot durable before its WAL rotation must not "
    "re-execute or double-dedup the cycles it covers",
    actions=("kill",),
    smokes=(SMOKE_FUZZ,),
)

# The cluster plane.  ``cluster/router.py`` imports the recovery stack
# (``durability/__init__`` → ``recovery`` → ``checkpoint``), so the
# declarations live here like the serving/snapshot points above.  They
# name ONLY the cluster smoke: the crash harness's point set is pinned
# exact, and the durable-plane fuzzer's coverage denominator must not
# grow points its single-process scenario can never reach.
CLUSTER_FORWARD_PRE_SEND = declare(
    "cluster.forward.pre_send",
    owner="svoc_torch/cluster/router.py",
    invariant="a forwarding fault surfaces as a retry, a breaker "
    "transition, or a counted cluster.unavailable shed — never a "
    "silently dropped admitted request",
    actions=("error", "kill"),
    smokes=(SMOKE_CLUSTER,),
)
CLUSTER_MIGRATE_PRE_DRAIN = declare(
    "cluster.migrate.pre_drain",
    owner="svoc_torch/cluster/router.py",
    invariant="a migration aborted before the drain leaves the claim "
    "fully owned and serving on the source — no half-moved state",
    actions=("error",),
    smokes=(SMOKE_CLUSTER,),
)
CLUSTER_MIGRATE_POST_SHIP = declare(
    "cluster.migrate.post_ship",
    owner="svoc_torch/cluster/router.py",
    invariant="a fault after the slice is shipped but before adoption "
    "must quarantine the slice (orphan path), never drop it or leave "
    "two live owners",
    actions=("error",),
    smokes=(SMOKE_CLUSTER,),
)
CLUSTER_MIGRATE_PRE_ADOPT = declare(
    "cluster.migrate.pre_adopt",
    owner="svoc_torch/cluster/router.py",
    invariant="adoption replays the shared chain log before restoring "
    "the slice — a fault here must not mint duplicate txs or rewind "
    "the lineage cursor",
    actions=("error",),
    smokes=(SMOKE_CLUSTER,),
)
# The live-reconfiguration plane.  Same circularity note as the cluster
# points: ``cluster/reconfig.py`` binds :func:`fault_point` at call time,
# the declarations live here.  Every point is an ABORT boundary: an
# ``error`` action injected at any of them must roll the transition back
# to a fleet fingerprint byte-identical to never having attempted it
# (the transaction's all-or-nothing witness, asserted by
# ``svoc_torch/tools/reconfig_smoke.py``).
RECONFIG_PREPARE = declare(
    "reconfig.prepare",
    owner="svoc_torch/cluster/reconfig.py",
    invariant="a fault during plan validation / pending-universe "
    "prewarm aborts before any replica is touched — the fleet "
    "fingerprint is byte-identical to never-attempted",
    actions=("error",),
    smokes=(SMOKE_RECONFIG,),
)
RECONFIG_POST_DRAIN = declare(
    "reconfig.post_drain",
    owner="svoc_torch/cluster/reconfig.py",
    invariant="a fault after a replica's drain (queues empty, new "
    "arrivals deferred at the router — never shed) releases the hold "
    "and replays every deferred request in order; no journal record "
    "of the attempt survives",
    actions=("error",),
    smokes=(SMOKE_RECONFIG,),
)
RECONFIG_POST_SHIP = declare(
    "reconfig.post_ship",
    owner="svoc_torch/cluster/reconfig.py",
    invariant="a fault after the claim slices are shipped re-adopts "
    "every slice onto the SAME source stack with lineage-cursor "
    "continuity — no half-moved state, no cursor rewind",
    actions=("error",),
    smokes=(SMOKE_RECONFIG,),
)
RECONFIG_PRE_REPIN = declare(
    "reconfig.pre_repin",
    owner="svoc_torch/cluster/reconfig.py",
    invariant="a fault before the re-pinned stack is constructed "
    "rolls back exactly like post_ship — the new fingerprint epoch "
    "was never minted, its journal files never referenced",
    actions=("error",),
    smokes=(SMOKE_RECONFIG,),
)
RECONFIG_PRE_RESUME = declare(
    "reconfig.pre_resume",
    owner="svoc_torch/cluster/reconfig.py",
    invariant="a fault after the new stacks are built but before the "
    "swap discards them (no epoch record was emitted, no cadence "
    "installed, no placement mutation) and re-adopts every slice onto "
    "the old stacks — abort is invisible to every fingerprint",
    actions=("error",),
    smokes=(SMOKE_RECONFIG,),
)
REPLICA_KILL = declare(
    "replica.kill",
    owner="svoc_torch/cluster/scenario.py",
    invariant="a replica death loses no admitted request: its durable "
    "dirs recover on the failover path and its claims re-serve on the "
    "survivors with exactly-once lineages and zero duplicate txs",
    actions=("kill",),
    smokes=(SMOKE_CLUSTER,),
)

@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: execute ``action`` at the ``nth`` firing of
    ``point`` whose payload contains ``match`` (subset test), during
    child ``phase`` (0 = the initial run, 1 = the first restart, …)."""

    point: str
    nth: int = 1
    action: str = "kill"
    match: Optional[Dict[str, Any]] = None
    phase: int = 0

    def __post_init__(self):
        if self.nth < 1:
            raise ValueError(f"nth must be >= 1, got {self.nth}")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown action {self.action!r}")
        if self.phase < 0:
            raise ValueError(f"phase must be >= 0, got {self.phase}")

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "point": self.point,
            "nth": self.nth,
            "action": self.action,
            "phase": self.phase,
        }
        if self.match is not None:
            d["match"] = dict(self.match)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultEvent":
        return cls(
            point=d["point"],
            nth=int(d.get("nth", 1)),
            action=d.get("action", "kill"),
            match=d.get("match"),
            phase=int(d.get("phase", 0)),
        )


def _default_die() -> None:  # pragma: no cover — harness children only
    os.kill(os.getpid(), signal.SIGKILL)


def torn_line_write(fileobj, record: Dict[str, Any]) -> None:
    """The ONE torn-write fault primitive (the ``torn`` action's
    writer): half of the record's JSONL line — no newline — flushed and
    fsynced, exactly what a mid-append power cut leaves for
    ``seal_jsonl`` to repair.  Shared by the WAL and the chain log so
    the two torn faults can never drift into simulating different
    power-cut shapes."""
    line = json.dumps(record, sort_keys=True)
    fileobj.write(line[: max(1, len(line) // 2)])
    fileobj.flush()
    os.fsync(fileobj.fileno())


class FaultController:
    """The armed half of the registry: counts firings, executes the
    scheduled events, and keeps the durable fired log.  One controller
    per harness child; production never constructs one."""

    def __init__(
        self,
        events: Sequence[FaultEvent] = (),
        *,
        log_path: Optional[str] = None,
        die: Callable[[], None] = _default_die,
    ):
        for ev in events:
            spec = _REGISTRY.get(ev.point)
            if spec is None:
                raise KeyError(f"fault event targets undeclared point "
                               f"{ev.point!r}")
            if ev.action not in spec.actions:
                raise ValueError(
                    f"action {ev.action!r} invalid at {ev.point!r} "
                    f"(allowed: {spec.actions})"
                )
        self.events = tuple(events)
        self.log_path = log_path
        self._die = die
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        #: per-event matching-firing counts / executed flags.
        self._event_counts: List[int] = [0] * len(self.events)
        self._executed: List[bool] = [False] * len(self.events)
        self._log_f = None

    # -- durable fired log ---------------------------------------------------

    def _log(self, record: Dict[str, Any]) -> None:
        if self.log_path is None:
            return
        if self._log_f is None:
            self._log_f = open(self.log_path, "a")
        self._log_f.write(json.dumps(record, sort_keys=True) + "\n")
        self._log_f.flush()
        os.fsync(self._log_f.fileno())

    def close(self) -> None:
        with self._lock:
            if self._log_f is not None:
                with contextlib.suppress(OSError):
                    self._log_f.close()
                self._log_f = None

    # -- firing --------------------------------------------------------------

    @staticmethod
    def _matches(match: Optional[Dict[str, Any]],
                 payload: Optional[Dict[str, Any]]) -> bool:
        if not match:
            return True
        if not payload:
            return False
        return all(payload.get(k) == v for k, v in match.items())

    def fire(
        self,
        name: str,
        *,
        payload: Optional[Dict[str, Any]] = None,
        torn: Optional[Callable[[], None]] = None,
    ) -> None:
        if name not in _REGISTRY:
            raise KeyError(f"undeclared fault point {name!r} fired")
        pending: Optional[FaultEvent] = None
        with self._lock:
            count = self._counts.get(name, 0) + 1
            self._counts[name] = count
            if count == 1:
                self._log({"kind": "fired", "point": name})
            for i, ev in enumerate(self.events):
                if ev.point != name or self._executed[i]:
                    continue
                if not self._matches(ev.match, payload):
                    continue
                self._event_counts[i] += 1
                # ``>=``: when two same-point events share an nth, the
                # loser of that firing executes at the NEXT eligible
                # firing instead of being silently lost (only one event
                # can act per firing — a kill ends the process).
                if self._event_counts[i] >= ev.nth and pending is None:
                    self._executed[i] = True
                    pending = ev
            if pending is not None:
                self._log(
                    {
                        "kind": "action",
                        "point": name,
                        "action": pending.action,
                        "n": count,
                    }
                )
        if pending is None:
            return
        if pending.action == "error":
            raise InjectedFault(f"chaos: injected fault at {name}")
        if pending.action == "torn":
            if torn is None:
                raise RuntimeError(
                    f"torn action scheduled at {name!r} but the call site "
                    f"provides no torn writer"
                )
            torn()
        self._die()

    # -- views ---------------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def fired_points(self) -> List[str]:
        with self._lock:
            return sorted(self._counts)

    def unfired_events(self) -> List[FaultEvent]:
        """Scheduled events whose nth firing never came (the run ended
        first) — recorded by the harness, never silently dropped."""
        with self._lock:
            return [
                ev for i, ev in enumerate(self.events) if not self._executed[i]
            ]


_CONTROLLER: Optional[FaultController] = None


def arm(controller: FaultController) -> FaultController:
    """Install ``controller`` as the process's fault controller.  Chaos
    harness children only; raises if one is already armed (two harnesses
    in one process would corrupt each other's schedules)."""
    global _CONTROLLER
    if _CONTROLLER is not None:
        raise RuntimeError("a fault controller is already armed")
    _CONTROLLER = controller
    return controller


def disarm() -> None:
    global _CONTROLLER
    if _CONTROLLER is not None:
        _CONTROLLER.close()
    _CONTROLLER = None


def armed() -> bool:
    return _CONTROLLER is not None


def fault_point(
    name: str,
    *,
    payload: Optional[Dict[str, Any]] = None,
    torn: Optional[Callable[[], None]] = None,
) -> None:
    """The boundary hook.  Near-zero cost unless a harness armed a
    controller; see the module docstring for action semantics."""
    ctl = _CONTROLLER
    if ctl is None:
        return
    ctl.fire(name, payload=payload, torn=torn)


def read_fired_log(path: str) -> Dict[str, Any]:
    """Parse a controller's durable fired log (torn-tail tolerant —
    the child usually died by SIGKILL): the set of points that fired
    and the executed actions, what the parent harness unions into its
    coverage table."""
    fired: List[str] = []
    actions: List[Dict[str, Any]] = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    continue  # torn tail — the firing before it counted
                if record.get("kind") == "fired":
                    fired.append(record["point"])
                elif record.get("kind") == "action":
                    actions.append(record)
    return {"fired": sorted(set(fired)), "actions": actions}
