"""Named fault points: the hook the chain adapter fires at its RPC
boundaries.

Mirrors the hook of :mod:`svoc_tpu.durability.faultspace`
(``faultspace.py:526-562``: ``_CONTROLLER``, :func:`arm`,
:func:`disarm`, :func:`armed`, :func:`fault_point`), the declaration
registry (``:81-158``: :class:`FaultPointSpec`, :func:`declare`,
:func:`surface`) and the declarations of the two points that
:mod:`svoc_torch.io.chain` fires (``:187-206``):

- ``chain.tx.pre_invoke``, before every signed per-oracle tx;
- ``chain.batch.pre_rpc``, before the batched commit's one RPC.

With no controller armed a firing is one global load and a ``None``
check.  An armed controller is duck-typed: it needs ``fire(name, *,
payload, torn)`` and ``close()``.  The reference's ``FaultController``
(schedules keyed on the Nth firing, kill/torn/error actions, the
durable fired log) and the crash harness come with ROADMAP A11.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

#: The harness that reaches and asserts a chain point (the reference's
#: ``tools/chaos_fuzz.py``).
SMOKE_FUZZ = "fuzz"

ACTIONS = ("kill", "torn", "error")
STAGES = ("run", "recovery")


@dataclasses.dataclass(frozen=True)
class FaultPointSpec:
    """One declared point of the fault surface."""

    name: str
    owner: str           # owning module path
    invariant: str       # the durability invariant a fault here threatens
    actions: Tuple[str, ...]      # valid actions at this point
    smokes: Tuple[str, ...]       # which harness(es) reach + assert it
    modes: Tuple[str, ...] = ("per_tx", "batched")  # commit modes reaching it
    stage: str = "run"   # "run" fires in the serving loop, "recovery" on restart

    def __post_init__(self):
        if not self.actions or any(a not in ACTIONS for a in self.actions):
            raise ValueError(f"{self.name}: invalid actions {self.actions}")
        if self.stage not in STAGES:
            raise ValueError(f"{self.name}: invalid stage {self.stage!r}")


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
    """Register one fault point and return its name.  Declaring the same
    spec again is a no-op; a different spec under the same name raises."""
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
    """The declared fault points, sorted by name."""
    with _REGISTRY_LOCK:
        return {name: _REGISTRY[name] for name in sorted(_REGISTRY)}


# The chain adapter's RPC boundaries (it binds fault_point lazily, as
# the reference's does, so the declarations live here).
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


_CONTROLLER: Optional[Any] = None


def arm(controller):
    """Install ``controller`` as the process's fault controller; raises
    if one is already armed."""
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
    """The boundary hook: hands the firing to the armed controller, if
    any."""
    ctl = _CONTROLLER
    if ctl is None:
        return
    ctl.fire(name, payload=payload, torn=torn)
