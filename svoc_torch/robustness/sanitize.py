"""Input-integrity quarantine gate ahead of the consensus.

Mirrors :mod:`svoc_tpu.robustness.sanitize` (``sanitize.py:45-295``).
The contract refuses a malformed prediction by panicking its
transaction; the consensus on the card would instead fold a NaN through
every reduction.  The gate restores the refusal at the float boundary:
each oracle's vector is quarantined for a non-finite component (NaN,
Inf), a value outside the consensus domain ``[lo, hi]``, or a magnitude
the wsad/felt codec cannot represent, with the fixed precedence
nan > inf > range > codec.

- :func:`quarantine_reasons`, :func:`quarantine_mask` and
  :func:`quarantine_mask_claims` are the tensor twins that decide
  admission on the device (the reference's ``*_jax`` functions; one
  function covers any leading shape, so the claim cube needs no vmap).
- :class:`QuarantineGate` is the numpy host gate that reports reasons.

The reference gate feeds the ``oracle_quarantine{reason=}`` metrics
series and emits a ``quarantine.verdict`` journal event per counted
inspection.  ``utils/metrics`` and ``utils/events`` are not ported yet:
this gate keeps a plain :class:`collections.Counter` of reasons (and a
count of slots inspected) and emits no event.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

#: The largest signed 128-bit integer (the port's copy of
#: ``svoc_tpu/ops/fixedpoint.py::I128_MAX``).
I128_MAX: int = 2**127 - 1

#: Largest real-unit magnitude the wsad/felt codec can represent
#: (``I128_MAX / 1e6``).
WSAD_LIMIT: float = float(I128_MAX) * 1e-6

#: Quarantine reasons, in precedence order (first match wins).
QUARANTINE_REASONS: Tuple[str, ...] = ("nan", "inf", "range", "codec")


@dataclasses.dataclass(frozen=True)
class SanitizeConfig:
    """Value-domain bounds for the gate, in real units; ``None`` turns
    the bound off.  The codec bound always holds."""

    lo: Optional[float] = 0.0
    hi: Optional[float] = 1.0

    def __post_init__(self):
        if self.lo is not None and self.hi is not None and self.lo > self.hi:
            raise ValueError(f"need lo <= hi, got [{self.lo}, {self.hi}]")

    @classmethod
    def for_consensus(cls, constrained: bool):
        """The contract's [0, 1] interval for the constrained model; the
        codec window only for the unconstrained one (``max_spread``
        bounds the estimator, not the value domain)."""
        if constrained:
            return cls(lo=0.0, hi=1.0)
        return cls(lo=None, hi=None)


class QuarantineMasks(NamedTuple):
    """Per-oracle bool masks, one per reason."""

    nan: Any
    inf: Any
    range: Any
    codec: Any

    @property
    def quarantined(self):
        return (self.nan | self.inf) | (self.range | self.codec)


def quarantine_reasons(
    values: torch.Tensor, lo: Optional[float], hi: Optional[float]
) -> QuarantineMasks:
    """Reason masks ``[..., N]`` for ``values [..., N, M]``.  A NaN
    component can trip only ``nan``: ``x < lo`` and ``x > hi`` are False
    for NaN, and the codec check reads a copy with non-finite values
    zeroed."""
    nan = torch.isnan(values).any(dim=-1)
    inf = torch.isinf(values).any(dim=-1)
    finite = torch.where(torch.isfinite(values), values, 0.0)
    out_of_range = torch.zeros_like(nan)
    if lo is not None:
        out_of_range = out_of_range | (values < lo).any(dim=-1)
    if hi is not None:
        out_of_range = out_of_range | (values > hi).any(dim=-1)
    codec = (finite.abs() > WSAD_LIMIT).any(dim=-1)
    # Precedence: a non-finite vector is "nan"/"inf", never "range".
    out_of_range = out_of_range & ~(nan | inf)
    codec = codec & ~((nan | inf) | out_of_range)
    return QuarantineMasks(nan=nan, inf=inf, range=out_of_range, codec=codec)


def quarantine_mask(
    values: torch.Tensor, lo: Optional[float], hi: Optional[float]
) -> torch.Tensor:
    """Admission mask ``ok [N]`` (True = clean) for ``values [N, M]``."""
    return ~quarantine_reasons(values, lo, hi).quarantined


def quarantine_mask_claims(
    values: torch.Tensor, lo: Optional[float], hi: Optional[float]
) -> torch.Tensor:
    """Admission masks ``ok [C, N]`` for a claim cube ``[C, N, M]``: the
    same rule as :func:`quarantine_mask` for every claim, on the
    cube's device (no host round trip before the consensus)."""
    if values.dim() != 3:
        raise ValueError(f"claim cube must be [C, N, M], got {tuple(values.shape)}")
    return quarantine_mask(values, lo, hi)


@dataclasses.dataclass
class QuarantineReport:
    """One host gate pass over a fleet block: ``reasons[slot]`` is the
    first reason for each quarantined slot, ``ok`` the admission mask."""

    ok: np.ndarray  # [N] bool, True = admitted
    reasons: Dict[int, str]

    @property
    def quarantined_slots(self) -> List[int]:
        return sorted(self.reasons)

    @property
    def clean(self) -> bool:
        return not self.reasons

    def as_dict(self) -> Dict[str, Any]:
        return {
            "quarantined": [
                {"slot": slot, "reason": self.reasons[slot]}
                for slot in self.quarantined_slots
            ],
            "admitted": int(np.sum(self.ok)),
            "total": int(self.ok.shape[0]),
        }


class QuarantinedInputError(RuntimeError):
    """A commit was refused because the gate quarantined fleet slots."""

    def __init__(self, report: QuarantineReport):
        self.report = report
        detail = ", ".join(
            f"slot {s}: {report.reasons[s]}" for s in report.quarantined_slots
        )
        super().__init__(f"quarantined fleet slots refuse commit ({detail})")


class QuarantineGate:
    """Host gate: inspect → report → count.  ``reasons`` counts every
    quarantined slot of a counted inspection by reason;
    ``slots_inspected`` counts the slots those inspections saw."""

    def __init__(self, config: Optional[SanitizeConfig] = None):
        self.config = config or SanitizeConfig()
        self.reasons: collections.Counter = collections.Counter()
        self.slots_inspected = 0

    def inspect(self, values, *, count: bool = True) -> QuarantineReport:
        """Classify every fleet slot of ``values [N, M]`` (numpy, or a
        tensor on any device, which is brought to the host)."""
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        arr = np.asarray(values, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr[None, :]
        reasons: Dict[int, str] = {}
        ok = np.ones(arr.shape[0], dtype=bool)
        for slot in range(arr.shape[0]):
            reason = self._classify(arr[slot], self.config)
            if reason is not None:
                reasons[slot] = reason
                ok[slot] = False
        if count:
            self.reasons.update(reasons.values())
            self.slots_inspected += arr.shape[0]
        return QuarantineReport(ok=ok, reasons=reasons)

    @staticmethod
    def _classify(vec: np.ndarray, cfg: SanitizeConfig) -> Optional[str]:
        if np.any(np.isnan(vec)):
            return "nan"
        if np.any(np.isinf(vec)):
            return "inf"
        if cfg.lo is not None and np.any(vec < cfg.lo):
            return "range"
        if cfg.hi is not None and np.any(vec > cfg.hi):
            return "range"
        if np.any(np.abs(vec) > WSAD_LIMIT):
            return "codec"
        return None
