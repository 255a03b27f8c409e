"""Parametric, seeded Byzantine oracle strategies.

Mirrors :mod:`svoc_tpu.robustness.attacks` (``attacks.py:49-161``):
:data:`ATTACK_NAMES` and :func:`apply_attack` with its five strategies.
The reference's failing oracle is a benign uniform draw that cannot
displace a median; these are ``k`` colluders who see the round's honest
values, coordinate, and emit values the input gate admits (finite, in
the domain):

- ``cluster``: the coalition plants one tight cluster at ``center +
  magnitude·direction``;
- ``shift``: each colluder keeps its honest-looking draw and adds the
  same offset toward the target;
- ``sign_flip``: colluders mirror their values about the honest center;
- ``straddle``: colluders sit at the reliability mask's boundary radius
  (the cut clamped into the honest subset, ``attacks.py:130-147``),
  alternately just inside and just outside;
- ``drift``: ``shift`` scaled by ``round_frac``.

The reference dispatches on a traced attack id through ``lax.switch``
so its grid vmaps; here the id is a Python int and one call takes a
whole cell: ``key [..., 2]``, ``values [..., N, M]`` and
``colluder_mask [..., N]`` share any leading (trial) axes, and
``round_frac`` is a number or a tensor of the leading shape.  The
jitter ``1e-3·uniform(-1, 1)`` is the reference's draw from the cell's
key, bit for bit; the rest follows the reference op for op (its ``a +
b·c`` as one fused multiply-add, as XLA compiles it), within a few ulp.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from svoc_torch.ops.stats import masked_smooth_median, quadratic_risk
from svoc_torch.sim import prng

ATTACK_NAMES: Tuple[str, ...] = (
    "cluster",
    "shift",
    "sign_flip",
    "straddle",
    "drift",
)


def _direction(center: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Unit vector from the honest center toward the target essence."""
    d = target - center
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)


def apply_attack(
    key: torch.Tensor,
    values: torch.Tensor,
    colluder_mask: torch.Tensor,
    attack_id: int,
    magnitude: float,
    n_failing: int,
    *,
    target=None,
    round_frac=1.0,
    smooth_mode: str = "cairo",
    clip: Optional[Tuple[float, float]] = (0.0, 1.0),
) -> torch.Tensor:
    """Overwrite the masked slots of honest fleets with colluder values.

    ``attack_id`` indexes :data:`ATTACK_NAMES`; ``magnitude`` is the
    offset length along the target direction (``cluster``, ``shift``,
    ``drift``) or the boundary band's relative width (``straddle``);
    ``n_failing`` is the defense's mask budget; ``target`` the ``[M]``
    target essence (default the all-ones corner); ``clip`` the admission
    bounds (None for unconstrained fleets).  Returns the attacked block,
    shaped as ``values``."""
    attack_id = int(attack_id)
    if not 0 <= attack_id < len(ATTACK_NAMES):
        raise ValueError(f"attack id {attack_id} not in [0, {len(ATTACK_NAMES)})")
    n, m = values.shape[-2:]
    dev, dt = values.device, values.dtype
    target = torch.ones(m, dtype=dt, device=dev) if target is None else torch.as_tensor(
        np.asarray(target, np.float32), device=dev)
    honest_mask = ~colluder_mask
    center = masked_smooth_median(values, honest_mask, smooth_mode)  # [..., M]
    direction = _direction(center, target)
    noise = 1e-3 * prng.uniform(key, (n, m), -1.0, 1.0)
    rank = torch.cumsum(colluder_mask.to(torch.int32), dim=-1) - 1
    mag = torch.tensor(magnitude, dtype=dt, device=dev)
    name = ATTACK_NAMES[attack_id]
    if name == "cluster":
        colluder_vals = prng._fma(mag, direction, center)[..., None, :] + noise
    elif name == "shift":
        colluder_vals = prng._fma(mag, direction[..., None, :], values) + noise
    elif name == "sign_flip":
        colluder_vals = (2.0 * center[..., None, :] - values) + noise
    elif name == "straddle":
        qr = quadratic_risk(values, center[..., None, :])
        qr_ranked = torch.where(honest_mask, qr, torch.inf)
        n_honest = honest_mask.to(torch.int64).sum(-1)
        cut = torch.minimum(torch.tensor(max(n - n_failing - 1, 0), device=dev), (n_honest - 1).clamp(min=0))
        r_cut = torch.sqrt(torch.sort(qr_ranked, dim=-1).values.gather(-1, cut[..., None])[..., 0])
        r_cut = torch.where(torch.isfinite(r_cut), r_cut, 0.0)
        side = torch.where(rank % 2 == 0, -1.0, 1.0)
        radius = r_cut[..., None] * prng._fma(side, mag, torch.tensor(1.0, device=dev))
        colluder_vals = prng._fma(radius[..., None], direction[..., None, :], center[..., None, :]) + noise
    else:  # drift
        frac = torch.as_tensor(round_frac, dtype=dt, device=dev)
        step = (frac * mag)[..., None, None] * direction[..., None, :]
        colluder_vals = (values + step) + noise
    if clip is not None:
        colluder_vals = torch.clamp(colluder_vals, clip[0], clip[1])
    return torch.where(colluder_mask[..., None], colluder_vals, values)
