"""Empirical breakdown-point certification of the consensus estimator.

Mirrors :mod:`svoc_tpu.robustness.certify` (``certify.py:55-350``):
:class:`BreakdownCell`, :func:`_grid_eval`, :func:`breakdown_sweep` and
:func:`certificate`.  The certificate the paper's claim asks for —
bounded essence deviation under up to ``n_failing`` coordinated
adversaries — for every strategy of :mod:`svoc_torch.robustness.attacks`:

1. draw ``T`` honest fleets and their attack-free consensus;
2. evaluate the (attack × colluder count × magnitude) grid, plus one
   benign replacement control a count (the same slots overwritten by
   independent honest draws);
3. bound each count's deviation by ``max(bound_abs, bound_ratio ·
   benign_deviation)``;
4. per attack, the largest prefix-monotone tolerated colluder count.

The reference evaluates the grid as one vmapped jit.  Here a cell is
one call: its ``T`` attacked blocks go through
:func:`svoc_torch.ops.fused_consensus.consensus_blocks`, which is the
reference's ``consensus_step_batched`` on the CPU and ONE launch of the
gated claim-cube kernel (B3) on CUDA, so a grid of ``C`` cells is
``C + 1`` launches (the reference consensus of the honest fleets is the
first).  No per-block plain loop runs on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.ops.fused_consensus import consensus_blocks
from svoc_torch.robustness.attacks import ATTACK_NAMES, apply_attack
from svoc_torch.sim import prng
from svoc_torch.sim.generators import generate_beta_oracles, generate_gaussian_oracles


@dataclasses.dataclass(frozen=True)
class BreakdownCell:
    """One (attack, colluder-count, magnitude) grid cell, reduced over
    trials."""

    attack: str
    colluders: int
    fraction: float
    magnitude: float
    mean_deviation: float
    max_deviation: float
    mean_capture: float
    valid_fraction: float


def _grid_eval(
    attack_keys: torch.Tensor,  # [C, T, 2] keys
    honest: torch.Tensor,  # [T, N, M] honest fleet blocks
    benign: torch.Tensor,  # [T, N, M] independent honest blocks (the control)
    positions: torch.Tensor,  # [T, N] per-trial colluder slot order
    attack_ids: Sequence[int],  # [C] index into ATTACK_NAMES; -1 = benign control
    counts: Sequence[int],  # [C] colluder counts
    magnitudes: Sequence[float],  # [C]
    *,
    cfg: ConsensusConfig,
    n_failing: int,
    clip: Optional[Tuple[float, float]],
    target: Optional[Tuple[float, ...]],
):
    """Every grid cell: four float32 tensors ``[C]`` (mean and max
    deviation, mean capture, valid fraction)."""
    t, n, m = honest.shape
    dev = honest.device
    essence_ref = consensus_blocks(honest, cfg).essence  # [T, M]
    drift_id = ATTACK_NAMES.index("drift")
    schedule = (torch.arange(t, dtype=honest.dtype, device=dev) + 1.0) / t
    out_rows = []
    for aid, k, mag, keys in zip(attack_ids, counts, magnitudes, attack_keys):
        cmask = positions < int(k)
        if aid >= 0:
            # Drift is certified along its whole schedule: trial i runs at
            # round_frac (i+1)/T; every other attack is single-round.
            frac = schedule if aid == drift_id else 1.0
            attacked = apply_attack(keys, honest, cmask, aid, float(np.float32(mag)), n_failing,
                                    target=target, round_frac=frac, clip=clip)
        else:  # the benign replacement control
            attacked = torch.where(cmask[..., None], benign, honest)
        out = consensus_blocks(attacked, cfg)
        deviation = torch.linalg.vector_norm(out.essence - essence_ref, dim=-1) / (m**0.5)
        captured = (out.reliable & cmask).sum(-1).to(torch.float32) / max(int(k), 1)
        out_rows.append(torch.stack([
            deviation.mean(), deviation.max(), captured.mean(),
            out.interval_valid.to(deviation.dtype).mean(),
        ]))
    rows = torch.stack(out_rows)
    return rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]


def breakdown_sweep(
    key: torch.Tensor,
    cfg: ConsensusConfig,
    *,
    n_oracles: int,
    colluder_counts: Sequence[int],
    magnitudes: Sequence[float],
    attacks: Sequence[str] = ATTACK_NAMES,
    n_trials: int = 64,
    dim: int = 6,
    beta_a: float = 20.0,
    beta_b: float = 20.0,
    gauss_mu: Optional[Sequence[float]] = None,
    gauss_sigma: float = 3.0,
) -> Dict[str, Any]:
    """Run the (attack × count × magnitude) grid for one consensus config
    on the key's device; returns the cells and the per-count benign
    control rows, as the reference does.  Constrained fleets are Beta(a,
    b) on ``[0, 1]^M`` with the all-ones target; unconstrained fleets are
    Gaussian around ``gauss_mu`` with the target ``max_spread`` along the
    diagonal.  ``drift`` runs along its whole schedule."""
    for a in attacks:
        if a not in ATTACK_NAMES:
            raise ValueError(f"unknown attack {a!r} (have {ATTACK_NAMES})")
    counts = [int(c) for c in colluder_counts]
    if any(c < 0 or c >= n_oracles for c in counts):
        raise ValueError(f"colluder counts {counts} outside [0, {n_oracles})")

    k_fleet, k_benign, k_slots, k_attack = prng.split(key, 4).unbind(-2)
    trial_keys = prng.split(k_fleet, n_trials)
    benign_keys = prng.split(k_benign, n_trials)
    if cfg.constrained:
        def gen(ks):
            return generate_beta_oracles(ks, n_oracles, 0, beta_a, beta_b, dim=dim)[0]

        clip: Optional[Tuple[float, float]] = (0.0, 1.0)
        target: Optional[Tuple[float, ...]] = tuple([1.0] * dim)
    else:
        mu = np.asarray(gauss_mu, np.float32) if gauss_mu is not None else np.full((dim,), 10.0, np.float32)

        def gen(ks):
            return generate_gaussian_oracles(ks, n_oracles, 0, mu, np.full((dim,), gauss_sigma, np.float32))[0]

        clip = None
        target = tuple(float(x) for x in (mu + cfg.max_spread / np.sqrt(dim)))
    honest = gen(trial_keys)
    benign = gen(benign_keys)
    # Per-trial colluder slot order, shared across cells so the count rows
    # of one trial nest.
    perms = prng.permutation(prng.split(k_slots, n_trials), n_oracles)
    positions = torch.argsort(perms, dim=-1)

    ids, cts, mags = [], [], []
    for a in attacks:
        for c in counts:
            for g in magnitudes:
                ids.append(ATTACK_NAMES.index(a))  # the global taxonomy index
                cts.append(c)
                mags.append(float(g))
    for c in counts:
        ids.append(-1)
        cts.append(c)
        mags.append(0.0)
    n_cells = len(ids)
    # fold_in(k_attack, i) is split(k_attack, n_cells)[i].
    attack_keys = prng.split(prng.split(k_attack, n_cells), n_trials)

    mean_dev, max_dev, capture, valid = (
        np.asarray(x.cpu(), np.float64)
        for x in _grid_eval(attack_keys, honest, benign, positions, ids, cts, mags, cfg=cfg,
                            n_failing=cfg.n_failing, clip=clip, target=target)
    )

    cells = []
    i = 0
    for a in attacks:
        for c in counts:
            for g in magnitudes:
                cells.append(BreakdownCell(
                    attack=a,
                    colluders=c,
                    fraction=c / n_oracles,
                    magnitude=float(g),
                    mean_deviation=float(mean_dev[i]),
                    max_deviation=float(max_dev[i]),
                    mean_capture=float(capture[i]),
                    valid_fraction=float(valid[i]),
                ))
                i += 1
    benign_rows = {}
    for c in counts:
        benign_rows[c] = float(mean_dev[i])
        i += 1
    return {
        "n_oracles": n_oracles,
        "n_trials": n_trials,
        "dim": dim,
        "config": {
            "n_failing": cfg.n_failing,
            "constrained": cfg.constrained,
            "max_spread": cfg.max_spread,
            "smooth_mode": cfg.smooth_mode,
        },
        "colluder_counts": counts,
        "magnitudes": [float(g) for g in magnitudes],
        "attacks": list(attacks),
        "cells": cells,
        "benign_deviation": benign_rows,
    }


def certificate(
    sweep: Dict[str, Any],
    *,
    bound_abs: float = 0.05,
    bound_ratio: float = 3.0,
) -> Dict[str, Any]:
    """Reduce a sweep to the certificate: per attack, the largest
    prefix-monotone tolerated colluder count under the calibrated
    deviation bound."""
    counts = sweep["colluder_counts"]
    n = sweep["n_oracles"]
    benign = sweep["benign_deviation"]
    bounds = {c: max(bound_abs, bound_ratio * benign[c]) for c in counts}
    by_attack: Dict[str, Dict[int, list]] = {}
    for cell in sweep["cells"]:
        by_attack.setdefault(cell.attack, {}).setdefault(cell.colluders, []).append(cell)
    attacks_out = {}
    for attack, rows in by_attack.items():
        tolerated = 0
        for c in sorted(rows):
            if all(r.mean_deviation <= bounds[c] for r in rows[c]):
                tolerated = c
            else:
                break  # prefix-monotone: a gap ends the certificate
        worst_capture = max(r.mean_capture for cells in rows.values() for r in cells)
        attacks_out[attack] = {
            "tolerated_colluders": tolerated,
            "tolerated_fraction": tolerated / n,
            "worst_mean_capture": worst_capture,
            "table": [dataclasses.asdict(r) for c in sorted(rows) for r in rows[c]],
        }
    return {
        "n_oracles": n,
        "n_failing": sweep["config"]["n_failing"],
        "constrained": sweep["config"]["constrained"],
        "design_fraction": sweep["config"]["n_failing"] / n,
        "bound_abs": bound_abs,
        "bound_ratio": bound_ratio,
        "bounds": {str(c): bounds[c] for c in counts},
        "benign_deviation": {str(c): benign[c] for c in counts},
        "attacks": attacks_out,
        "certified": all(
            a["tolerated_fraction"] >= sweep["config"]["n_failing"] / n for a in attacks_out.values()
        ),
    }
