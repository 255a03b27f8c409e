"""The static description of one claim of the multi-claim fabric.

Mirrors :class:`svoc_tpu.fabric.registry.ClaimSpec`
(``registry.py:36-95``), with its validation and
``consensus_config()``.  Its SLO objectives, ``ClaimState`` and
``ClaimRegistry`` (which hold a ``Session`` per claim) are not ported
yet (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from svoc_torch.consensus.kernel import ConsensusConfig


@dataclasses.dataclass(frozen=True)
class ClaimSpec:
    """One claim (market, story, topic).

    ``seed=None`` takes the claim's oracle-stream seed from the fabric's
    base seed (:func:`svoc_torch.sim.generators.claim_seed`).
    ``weight`` is the claim's fair-scheduling share.  ``tamper`` is the
    Byzantine-scenario hook, called as ``tamper(cycle, block)`` with the
    claim's served-cycle count and its ``[N, M]`` fleet block as a host
    float64 numpy array, returning the (possibly corrupted) block as an
    array, which is cast to float32 and put back on the device (the
    reference's contract, ``svoc_tpu/apps/session.py:622-633``); None for
    an honest claim."""

    claim_id: str
    seed: Optional[int] = None
    n_oracles: int = 7
    n_failing: int = 2
    dimension: int = 6
    constrained: bool = True
    #: unconstrained estimator spread (> 0 when ``constrained=False``).
    max_spread: float = 10.0
    weight: int = 1
    tamper: Optional[Callable] = None

    def __post_init__(self):
        if not self.claim_id:
            raise ValueError("claim_id must be non-empty")
        if "-" in self.claim_id or "/" in self.claim_id:
            # Lineage ids are ``blk<scope>-<claim>-<n>``: a separator in
            # the claim id would make the partition ambiguous.
            raise ValueError(
                f"claim_id {self.claim_id!r} must not contain '-' or '/'"
            )
        if self.weight < 1:
            raise ValueError("weight must be >= 1")
        if not self.constrained and self.max_spread <= 0.0:
            raise ValueError(
                "unconstrained claims need max_spread > 0 "
                "(contract.cairo:365-368 divides by it)"
            )

    def consensus_config(self) -> ConsensusConfig:
        """The claim's consensus configuration; claims that share it and
        their fleet shape batch into one dispatch."""
        return ConsensusConfig(
            n_failing=self.n_failing,
            constrained=self.constrained,
            max_spread=self.max_spread,
        )
