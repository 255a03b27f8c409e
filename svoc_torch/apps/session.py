"""The request-fed fetch of one claim: its rolling window and its fleet.

Mirrors the request branch of :meth:`svoc_tpu.apps.session.Session.fetch`
(``session.py:537-602``, the window; ``:604-636``, the fleet and the
tamper hook) as two functions.  The rest of ``Session`` (the comment
store, the chain commit, the WAL, the supervisor and breaker, the
preview statistics, the journal) is not ported yet (ROADMAP A8-A11).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.sim.oracle import assemble_fleet, draw_fleet

#: Rows of a claim's rolling window (``svoc_tpu/io/comment_store.py``).
PREDICTION_WINDOW = 50
#: Bootstrap subset of an honest oracle (``SessionConfig.bootstrap_subset``).
BOOTSTRAP_SUBSET = 10


def request_window(
    previous: Optional[torch.Tensor],
    window: torch.Tensor,
    cap: int = PREDICTION_WINDOW,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """A claim's new request vectors ``window [K, M]`` appended to its
    ``previous`` window and capped at its last ``cap`` rows; then tiled
    cyclically up to the next power of two of its rows (the padding rows
    are real vectors repeated), with the bootstrap subset
    ``min(BOOTSTRAP_SUBSET, max(1, bucket // 2))``, strictly under the
    bucket.  Returns ``(kept, tiled, subset)``: ``kept`` is the window to
    hold for the claim's next feed."""
    if window.dim() != 2:
        raise ValueError(f"request window must be [K, M], got {tuple(window.shape)}")
    if window.shape[0] == 0:
        raise ValueError("request-driven fetch got an empty window")
    if previous is not None:
        if previous.shape[1] != window.shape[1]:
            raise ValueError(
                f"request window is [K, {window.shape[1]}], the claim's is "
                f"[K, {previous.shape[1]}]"
            )
        window = torch.cat([previous, window])
    kept = window[-cap:]
    rows = kept.shape[0]
    bucket = 1 << max(0, rows - 1).bit_length()
    tiled = kept
    if bucket > rows:
        tiled = kept[torch.arange(bucket, device=kept.device) % rows]
    return kept, tiled, min(BOOTSTRAP_SUBSET, max(1, bucket // 2))


def fleet_block(
    gen: torch.Generator,
    window: torch.Tensor,
    spec: ClaimSpec,
    subset: int,
    tamper: Optional[Callable] = None,
    cycle: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The claim's oracle fleet from its tiled window: ``spec.n_oracles``
    oracles of which ``spec.n_failing`` fail, honest ones averaging
    ``subset`` window rows; then ``tamper(cycle, block)`` when given (the
    scenario hook, applied before the gate).  Returns ``(values [N, M]
    float32, honest [N])`` on ``gen``'s device.

    The hook gets what the reference's gets (``session.py:622-633``): the
    block fetched to the host as a float64 numpy array; its return is
    read as float64, cast to float32 and put back on the block's device.
    Only a tampered claim pays that fetch, as in the reference."""
    draws = draw_fleet(
        gen, window.shape[0], window.shape[1], spec.n_oracles, spec.n_failing, subset
    )
    values, honest = assemble_fleet(window, *draws)
    values = values.to(torch.float32)
    if tamper is not None:
        block = values.detach().cpu().numpy().astype(np.float64)
        tampered = np.asarray(tamper(cycle, block), dtype=np.float64).astype(np.float32)
        values = torch.from_numpy(tampered).to(values.device)
    return values, honest
