"""Deterministic fault injection: seeded plans and the chaos backend.

Mirrors :mod:`svoc_tpu.resilience.faults` (``faults.py:1-283``):
:class:`InjectedFault`, :class:`InjectedTimeout`, :class:`FaultSpec`,
:func:`crc_key` and :func:`mix_key` (``:85-106``), the seeded
:class:`FaultPlan` (``:108``), :class:`FaultInjectingBackend` (``:214``)
and :func:`standard_fault_specs` (``:254``).  The plan's draws are the
reference's, bit for bit: the fired-fault schedule is part of every
chaos fingerprint.

A :class:`FaultPlan` is a seeded schedule of infrastructure faults (an
RPC that times out mid-fleet, a stalled signer), and
:class:`FaultInjectingBackend` applies it to any chain backend, so a
chaos run is a pure function of its seed: replaying the same seed over
the same call sequence reproduces the identical fault schedule.

Determinism mechanics: every injection decision is an independent draw
from a PRNG keyed by ``(plan seed, spec index, op, target, per-key
call count)`` — no shared stream — so interleaving across *different*
oracles (threads racing) cannot shift each other's schedules, and the
key hash uses ``zlib.crc32`` rather than ``hash()`` (which Python
randomizes per process and would silently break cross-process replay).
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry


class InjectedFault(RuntimeError):
    """A fault injected by a :class:`FaultPlan` (``kind="error"``)."""


class InjectedTimeout(InjectedFault):
    """An injected *timeout* — what a deadline expiry on the real RPC
    surfaces as.  Distinct so retry policies / tests can classify."""


@dataclass(frozen=True)
class FaultSpec:
    """One line of a fault schedule.

    ``op`` matches the operation name the injection point reports
    (``"invoke:update_prediction"``, ``"call:get_consensus_value"``,
    ``"scrape"``); a trailing ``*`` makes it a prefix match.  ``target``
    narrows to one caller/oracle address (``None`` = any).  A spec with
    ``probability=1.0`` is a *persistent* offender; fractional
    probabilities model transient flakiness.  ``after`` skips the first
    N matching calls (let a fleet bootstrap before chaos), ``max_fires``
    caps total injections, and ``stall_s`` is the sleep for
    ``kind="stall"``.
    """

    op: str
    kind: str = "error"  # "error" | "timeout" | "stall"
    target: Optional[Any] = None
    probability: float = 1.0
    after: int = 0
    max_fires: Optional[int] = None
    stall_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("error", "timeout", "stall"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability {self.probability} outside [0, 1]")

    def matches(self, op: str, target: Any) -> bool:
        if self.op.endswith("*"):
            if not op.startswith(self.op[:-1]):
                return False
        elif op != self.op:
            return False
        return self.target is None or self.target == target


def crc_key(value: Any) -> int:
    """Cross-process-stable key for an opaque value: ``repr()`` is
    stable for the address/name types that cross this boundary (ints,
    short strings); ``hash()`` is NOT (PYTHONHASHSEED).  The one keying
    primitive every seeded-draw subsystem shares (fault plans here, the
    fault-space fuzzer's schedule draws, ``sim.generators.claim_seed``'s
    sibling)."""
    return zlib.crc32(repr(value).encode())


def mix_key(*parts: int) -> int:
    """Fold integer key parts into one 64-bit draw seed (FNV-style)."""
    h = 0
    for p in parts:
        h = (h * 1_000_003 + (int(p) & 0xFFFFFFFFFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
    return h


class FaultPlan:
    """A seeded, exactly-replayable fault schedule.

    Thread-safe: the per-key call counters and the fired-fault log are
    guarded by one lock (injection points run on auto-loop daemon
    threads and web handlers concurrently).
    """

    def __init__(
        self,
        seed: int,
        specs: Sequence[FaultSpec],
        registry: Optional[MetricsRegistry] = None,
    ):
        self.seed = int(seed)
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self._registry = registry or _default_registry
        self._lock = threading.Lock()
        #: per-(spec index, target) matching-call counts — keyed per
        #: target so concurrent schedules for different oracles cannot
        #: perturb each other.
        self._counts: Dict[Tuple[int, Any], int] = {}
        self._fires: Dict[int, int] = {}
        self._log: List[Dict[str, Any]] = []

    def decide(self, op: str, target: Any = None) -> Optional[FaultSpec]:
        """Consume one decision for ``(op, target)``; the first firing
        spec wins (later matching specs still consume their counters so
        the schedule stays independent of which spec fired)."""
        with self._lock:
            fired: Optional[Tuple[int, FaultSpec]] = None
            for si, spec in enumerate(self.specs):
                if not spec.matches(op, target):
                    continue
                key = (si, target)
                count = self._counts.get(key, 0)
                self._counts[key] = count + 1
                if fired is not None:
                    continue
                if count < spec.after:
                    continue
                if (
                    spec.max_fires is not None
                    and self._fires.get(si, 0) >= spec.max_fires
                ):
                    continue
                if spec.probability < 1.0:
                    u = random.Random(
                        mix_key(self.seed, si, crc_key(op), crc_key(target), count)
                    ).random()
                    if u >= spec.probability:
                        continue
                fired = (si, spec)
            if fired is None:
                return None
            si, spec = fired
            self._fires[si] = self._fires.get(si, 0) + 1
            self._log.append(
                {
                    "n": len(self._log),
                    "op": op,
                    "target": repr(target),
                    "kind": spec.kind,
                    "spec": si,
                }
            )
            return spec

    def fire(
        self,
        op: str,
        target: Any = None,
        *,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        """Consult the schedule and *apply* the fault: raise
        :class:`InjectedFault`/:class:`InjectedTimeout`, or sleep for a
        stall.  No-op when the schedule says this call passes."""
        spec = self.decide(op, target)
        if spec is None:
            return
        self._registry.counter(
            "faults_injected", labels={"kind": spec.kind}
        ).add(1)
        if spec.kind == "stall":
            sleep(spec.stall_s)
            return
        if spec.kind == "timeout":
            raise InjectedTimeout(
                f"injected timeout: {op} target={target!r}"
            )
        raise InjectedFault(f"injected fault: {op} target={target!r}")

    def history(self) -> List[Dict[str, Any]]:
        """The fired-fault log, in firing order (chaos artifacts)."""
        with self._lock:
            return [dict(entry) for entry in self._log]

    def fingerprint(self) -> str:
        """Stable digest of the fired schedule — two replays of the same
        seed over the same call sequence must agree on this."""
        with self._lock:
            blob = json.dumps(self._log, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


class FaultInjectingBackend:
    """Chaos wrapper over any :class:`~svoc_torch.io.chain.ChainBackend`.

    Every read (``call``/``call_as``) and signed tx (``invoke``)
    consults the plan first — ``op`` is ``"call:<fn>"`` /
    ``"invoke:<fn>"`` and ``target`` the caller address — so a spec can
    fail one oracle's txs persistently while the rest of the fleet
    commits.

    Deliberately does NOT forward ``invoke_update_predictions_batch``:
    the adapter then falls back to the per-tx loop, where per-oracle
    faults produce honest *partial* commits with
    ``ChainCommitError.committed`` accounting — exactly the
    partial-batch failure mode the resume path must survive.
    """

    def __init__(
        self,
        backend,
        plan: FaultPlan,
        *,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.backend = backend
        self.plan = plan
        self._sleep = sleep

    def call(self, function_name: str):
        self.plan.fire(f"call:{function_name}", sleep=self._sleep)
        return self.backend.call(function_name)

    def call_as(self, caller, function_name: str):
        self.plan.fire(f"call:{function_name}", caller, sleep=self._sleep)
        return self.backend.call_as(caller, function_name)

    def invoke(self, caller, function_name: str, /, **kwargs) -> None:
        self.plan.fire(f"invoke:{function_name}", caller, sleep=self._sleep)
        return self.backend.invoke(caller, function_name, **kwargs)


def standard_fault_specs(
    transient: Sequence[Any] = (),
    persistent: Sequence[Any] = (),
    *,
    probability: float = 0.35,
    transient_kinds: Sequence[str] = ("error", "timeout"),
) -> List[FaultSpec]:
    """The canonical chaos mix (the chaos smoke's):
    transient commit faults on the given oracles (alternating error /
    timeout kinds) plus persistent commit failure on the offenders."""
    specs: List[FaultSpec] = []
    for i, target in enumerate(transient):
        specs.append(
            FaultSpec(
                op="invoke:update_prediction",
                kind=transient_kinds[i % len(transient_kinds)],
                target=target,
                probability=probability,
            )
        )
    for target in persistent:
        specs.append(
            FaultSpec(
                op="invoke:update_prediction",
                kind="error",
                target=target,
                probability=1.0,
            )
        )
    return specs
