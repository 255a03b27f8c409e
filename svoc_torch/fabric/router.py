"""The claim-cube dispatch of one shape/config group.

Mirrors the non-meshed, non-device-resident branch of
:meth:`svoc_tpu.fabric.router.ClaimRouter._dispatch_group`
(``router.py:567-713``) and the output slice of ``_finish_group``
(``:806``): stack the claims' fleet blocks, pad the cube to its
power-of-two bucket, one consensus dispatch, keep the first ``C`` rows.
Scheduling and selection, the chain commit, SLO accounting, the journal,
the pipelined mode, device-resident staging and the claim mesh are not
ported yet (ROADMAP A9).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from svoc_torch.consensus.batch import (
    claims_consensus_gated,
    claims_consensus_sanitized,
    pad_claim_cube,
)
from svoc_torch.consensus.kernel import ConsensusConfig, ConsensusOutput
from svoc_torch.robustness.sanitize import SanitizeConfig


def dispatch_group(
    blocks: Sequence[torch.Tensor],
    oks: Optional[Sequence[torch.Tensor]],
    cfg: ConsensusConfig,
    sanitized: bool = False,
) -> Tuple[ConsensusOutput, torch.Tensor]:
    """One consensus dispatch over the ``[N, M]`` fleet blocks of ``C``
    claims that share a shape and ``cfg``.

    ``sanitized=True`` (the router's ``sanitized_dispatch`` mode)
    computes the admission masks from the cube on its device, with the
    bounds of ``SanitizeConfig.for_consensus(cfg.constrained)``, and
    ignores ``oks``; otherwise ``oks`` are the claims' ``[N]`` admission
    masks (all admitted when None).  Returns ``(output, ok)``, each with
    ``C`` rows."""
    values = torch.stack([b.to(torch.float32) for b in blocks])
    c = values.shape[0]
    if sanitized:
        values, _, claim_mask = pad_claim_cube(values)
        bounds = SanitizeConfig.for_consensus(cfg.constrained)
        out, ok = claims_consensus_sanitized(values, claim_mask, cfg, bounds.lo, bounds.hi)
    else:
        values, ok, claim_mask = pad_claim_cube(
            values, None if oks is None else torch.stack(list(oks))
        )
        out = claims_consensus_gated(values, ok, claim_mask, cfg)
    return ConsensusOutput(*(field[:c] for field in out)), ok[:c]
