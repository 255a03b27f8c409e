"""The multi-claim consensus fabric (the port's counterpart of
:mod:`svoc_tpu.fabric`): many claims, one consensus dispatch.

- :class:`ClaimSpec`, :class:`ClaimState`, :class:`ClaimRegistry` —
  per-claim description and live state (:mod:`.registry`);
- :class:`ClaimRouter` — fair scheduling + the claim-cube dispatch
  (:mod:`.router`);
- :class:`MultiSession` — the operator facade (:mod:`.session`);
- :func:`run_fabric_scenario` — the seeded smoke (:mod:`.scenario`).
"""

from svoc_torch.fabric.registry import ClaimRegistry, ClaimSpec, ClaimState
from svoc_torch.fabric.router import ClaimRouter
from svoc_torch.fabric.scenario import run_fabric_scenario
from svoc_torch.fabric.session import MultiSession

__all__ = [
    "ClaimRegistry",
    "ClaimRouter",
    "ClaimSpec",
    "ClaimState",
    "MultiSession",
    "run_fabric_scenario",
]
