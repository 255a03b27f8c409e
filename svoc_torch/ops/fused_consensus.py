"""Fused two-pass consensus kernels: the plain PyTorch versions and the
wrappers of their CUDA kernels.

Mirrors :mod:`svoc_tpu.ops.pallas_consensus`: the single-claim
``FusedConsensusOutput``, ``fused_consensus`` and its kernel body
``_consensus_kernel`` (``pallas_consensus.py:104-372``; kernel
``svoc_torch/csrc/fused_consensus.cu``), and the gated claim cube,
``fused_consensus_gated_claims`` and its kernel body
``_gated_claims_kernel`` (``pallas_consensus.py:381-640``; kernel
``svoc_torch/csrc/gated_claims_consensus.cu``).

:func:`fused_consensus` and :func:`fused_consensus_gated_claims` take
the plain version for a tensor on the CPU and launch the kernel for a
CUDA tensor; on CUDA they raise rather than fall back (a ``smooth_mode``
other than ``"cairo"``, a wrong dtype or shape, a fleet whose working
set exceeds one block's shared memory).  There is no fallback counter:
nothing falls back.  The TPU-only limits on the fleet size
(``fused_fallback_reason``: a multiple of 128, at most 1024) do not
apply.

The single-claim semantics are those of the TPU kernel, which differ
from :func:`svoc_torch.consensus.kernel.consensus_step` in two details:
``m = N - n_failing`` is a constant of the call (no clamp at 1), and a
smooth-median rank outside ``[0, N)`` reads 0.  The gated claim cube
computes :func:`svoc_torch.consensus.kernel.consensus_step_gated_claims`
op for op, with counts read at run time.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from svoc_torch.consensus.kernel import (
    ConsensusConfig,
    ConsensusOutput,
    _mask_padded_claims,
    reliability,
)
from svoc_torch.ops import _build, stats
from svoc_torch.ops.sort import cairo_rank

#: Shared memory one block may use on sm_90 (227 KB).
MAX_SMEM_BYTES = 232448


class FusedConsensusOutput(NamedTuple):
    essence: torch.Tensor  # [M]
    essence_first_pass: torch.Tensor  # [M]
    reliability_first_pass: torch.Tensor  # scalar
    reliability_second_pass: torch.Tensor  # scalar
    reliable: torch.Tensor  # [N] bool
    quadratic_risk: torch.Tensor  # [N]
    skewness: torch.Tensor  # [M]
    kurtosis: torch.Tensor  # [M]


def _smooth_median_ranks(m: int):
    """Ranks of the Cairo smooth median of ``m`` entries
    (``math.cairo:113-126``): ``m//2 - 1`` and ``m//2``."""
    return m // 2 - 1, m // 2


def _value_at_rank(col: torch.Tensor, rank: torch.Tensor, r: int) -> torch.Tensor:
    """Value of ``col`` whose rank is ``r``, 0 when no rank is ``r``."""
    return torch.where(rank == r, col, 0.0).sum(dim=0)


def _smooth_median(v: torch.Tensor, keep, m: int) -> torch.Tensor:
    """Per-column Cairo smooth median of the ``keep`` rows (all rows when
    ``keep`` is None); dropped rows are keyed +inf."""
    key = v if keep is None else torch.where(keep[:, None], v, torch.inf)
    rank = cairo_rank(key)
    lo, hi = _smooth_median_ranks(m)
    return (_value_at_rank(v, rank, lo) + _value_at_rank(v, rank, hi)) * 0.5


def fused_consensus_plain(
    values: torch.Tensor, cfg: ConsensusConfig
) -> FusedConsensusOutput:
    """The kernel's computation in plain PyTorch, on any device."""
    n, dim = values.shape
    v = values.float()
    m = n - cfg.n_failing
    mf = torch.tensor(float(m), device=v.device)

    essence1 = _smooth_median(v, None, n)
    qr = stats.quadratic_risk(v, essence1)
    rel1 = reliability(cfg, qr.sum() / n, dim)
    reliable = cairo_rank(qr) < m
    w = reliable.float()[:, None]

    mean_rel = (v * w).sum(dim=0) / mf
    essence2 = _smooth_median(v, reliable, m) if cfg.constrained else mean_rel
    rel2 = reliability(cfg, torch.where(reliable, qr, 0.0).sum() / mf, dim)

    centered = (v - mean_rel) * w
    var = (centered * centered).sum(dim=0) / mf
    z = centered / torch.clamp(torch.sqrt(var), min=1e-30)
    skew = (z**3).sum(dim=0) * mf / ((mf - 1.0) * (mf - 2.0))
    t1 = (z**4).sum(dim=0) * mf * (mf + 1.0) / (mf - 1.0)
    kurt = (t1 - 3.0 * (mf - 1.0) ** 2) / ((mf - 2.0) * (mf - 3.0))
    return FusedConsensusOutput(
        essence=essence2,
        essence_first_pass=essence1,
        reliability_first_pass=rel1,
        reliability_second_pass=rel2,
        reliable=reliable,
        quadratic_risk=qr,
        skewness=skew,
        kurtosis=kurt,
    )


def _check_kernel_inputs(values: torch.Tensor, cfg: ConsensusConfig) -> None:
    """Raise on what the CUDA kernel does not take.  The shared-memory
    check asks the built kernel for its layout, so it comes last."""
    if values.dim() != 2 or values.shape[0] < 1 or values.shape[1] < 1:
        raise ValueError(f"values must be [N, M] with N, M >= 1, got {tuple(values.shape)}")
    if values.dtype != torch.float32:
        raise ValueError(f"values must be float32, got {values.dtype}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    if cfg.smooth_mode != "cairo":
        raise ValueError(
            f"the fused consensus kernel implements smooth_mode 'cairo' only, "
            f"got {cfg.smooth_mode!r}"
        )
    if values.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {values.device}")
    n, dim = values.shape
    need = _lib().svoc_fused_consensus_smem_bytes(n, dim)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"a [{n}, {dim}] fleet needs {need} bytes of shared memory, "
            f"more than one block's {MAX_SMEM_BYTES}"
        )


@functools.cache
def _lib():
    lib = _build.load("fused_consensus")
    lib.svoc_fused_consensus.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.svoc_fused_consensus.restype = ctypes.c_int
    lib.svoc_fused_consensus_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.svoc_fused_consensus_smem_bytes.restype = ctypes.c_size_t
    return lib


def fused_consensus_cuda(
    values: torch.Tensor, cfg: ConsensusConfig
) -> FusedConsensusOutput:
    """Launch ``csrc/fused_consensus.cu`` on the values' device and its
    current stream."""
    _check_kernel_inputs(values, cfg)
    n, dim = values.shape
    m = n - cfg.n_failing
    f32 = dict(dtype=torch.float32, device=values.device)
    essence = torch.empty(dim, **f32)
    essence1 = torch.empty(dim, **f32)
    rel = torch.empty(2, **f32)
    mask = torch.empty(n, dtype=torch.int32, device=values.device)
    qr = torch.empty(n, **f32)
    moments = torch.empty(2, dim, **f32)
    lo_all, hi_all = _smooth_median_ranks(n)
    lo_rel, hi_rel = _smooth_median_ranks(m)
    _build.launch(
        "fused_consensus", _lib().svoc_fused_consensus, values.device,
        values.data_ptr(), essence.data_ptr(), essence1.data_ptr(), rel.data_ptr(),
        mask.data_ptr(), qr.data_ptr(), moments.data_ptr(),
        n, dim, m, lo_all, hi_all, lo_rel, hi_rel, int(cfg.constrained),
        float(cfg.max_spread),
    )
    fused_consensus_cuda.launches += 1
    return FusedConsensusOutput(
        essence=essence,
        essence_first_pass=essence1,
        reliability_first_pass=rel[0],
        reliability_second_pass=rel[1],
        reliable=mask.bool(),
        quadratic_risk=qr,
        skewness=moments[0],
        kurtosis=moments[1],
    )


#: Kernel launches since the count was last set to 0.
fused_consensus_cuda.launches = 0


def fused_consensus(values: torch.Tensor, cfg: ConsensusConfig) -> FusedConsensusOutput:
    """One-launch two-pass consensus on ``values [N, M]`` float32: the
    plain version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if values.device.type == "cpu":
        return fused_consensus_plain(values, cfg)
    return fused_consensus_cuda(values, cfg)


# ---------------------------------------------------------------------------
# Gated claim cube (B3): one claim per block, quarantine admission folded
# into both passes (docs/FABRIC.md).
# ---------------------------------------------------------------------------


def _gated_smooth_median(safe: torch.Tensor, keep: torch.Tensor, count: torch.Tensor):
    """``[C, M]``: per claim and column, the mean of the keys at ranks
    ``clip(count//2 - 1)`` and ``clip(count//2)`` with the rows outside
    ``keep`` keyed +inf, so a rank on a dropped row reads +inf
    (``_masked_value_at_rank``, ``pallas_consensus.py:381-408``)."""
    c, n, _ = safe.shape
    s = torch.sort(torch.where(keep[..., None], safe, torch.inf), dim=1).values
    mid = torch.div(count, 2, rounding_mode="floor")
    claims = torch.arange(c, device=safe.device)
    a = s[claims, (mid - 1).clamp(0, n - 1)]
    b = s[claims, mid.clamp(0, n - 1)]
    return (a + b) * 0.5


def _interval_ok(x: torch.Tensor) -> torch.Tensor:
    return torch.logical_and(x >= 0.0, x <= 1.0)


def fused_consensus_gated_claims_plain(
    values: torch.Tensor,
    ok: torch.Tensor,
    claim_mask: torch.Tensor,
    cfg: ConsensusConfig,
) -> ConsensusOutput:
    """The kernel's computation as batched PyTorch ops, on any device:
    ``values [C, N, M]``, admission masks ``ok [C, N]`` (True =
    admitted), active claims ``claim_mask [C]``; every output field has
    a leading claim axis."""
    if cfg.smooth_mode != "cairo":
        raise ValueError(
            f"the gated claim-cube consensus implements smooth_mode 'cairo' only, "
            f"got {cfg.smooth_mode!r}"
        )
    dim = values.shape[2]
    okb = ok.bool()
    # Neutral fill before any arithmetic: 0 * NaN is NaN.
    safe = torch.where(okb[..., None], values.float(), 0.0)
    safe = torch.where(torch.isfinite(safe), safe, 0.0)
    n_ok = okb.sum(dim=1)

    # ---- FIRST PASS over the admitted rows ----
    essence1 = _gated_smooth_median(safe, okb, n_ok)
    qr = stats.quadratic_risk(safe, essence1[:, None, :])
    qr_ok = torch.where(okb, qr, 0.0)
    rel1 = reliability(cfg, qr_ok.sum(dim=1) / n_ok.clamp(min=1), dim)

    # Gated ranking: quarantined rows key +inf; the cut counts from n_ok.
    rank = cairo_rank(torch.where(okb, qr, torch.inf).T).T
    reliable = torch.logical_and(rank < (n_ok - cfg.n_failing)[:, None], okb)
    w = reliable[..., None]
    n_rel = reliable.sum(dim=1)
    denom = n_rel.clamp(min=1)[:, None].float()

    # ---- SECOND PASS (risk still centred on essence1); masks select ----
    mean_rel = torch.where(w, safe, 0.0).sum(dim=1) / denom
    essence2 = _gated_smooth_median(safe, reliable, n_rel) if cfg.constrained else mean_rel
    rel2 = reliability(cfg, torch.where(reliable, qr_ok, 0.0).sum(dim=1) / denom[:, 0], dim)

    # ---- MOMENTS over the reliable rows, count-clamped denominators ----
    nr = n_rel.float()[:, None]
    centered = torch.where(w, safe - mean_rel[:, None, :], 0.0)
    std = torch.sqrt((centered * centered).sum(dim=1) / denom)
    z = torch.where(
        reliable[..., None], (safe - mean_rel[:, None, :]) / std.clamp(min=1e-30)[:, None, :], 0.0
    )
    skew = (z**3).sum(dim=1) * nr / ((nr - 1.0) * (nr - 2.0)).clamp(min=1.0)
    t1 = (z**4).sum(dim=1) * nr * (nr + 1.0) / (nr - 1.0).clamp(min=1.0)
    kurt = (t1 - 3.0 * (nr - 1.0) ** 2) / ((nr - 2.0) * (nr - 3.0)).clamp(min=1.0)

    valid = _interval_ok(rel1) & _interval_ok(rel2) & (n_ok >= 2) & (n_rel >= 2)
    out = ConsensusOutput(
        essence=torch.where(torch.isfinite(essence2), essence2, 0.0),
        essence_first_pass=torch.where(torch.isfinite(essence1), essence1, 0.0),
        reliability_first_pass=rel1,
        reliability_second_pass=rel2,
        reliable=reliable,
        quadratic_risk=qr,
        skewness=skew,
        kurtosis=kurt,
        interval_valid=valid,
    )
    return _mask_padded_claims(out, claim_mask)


def _check_gated_inputs(values, ok, claim_mask, cfg: ConsensusConfig) -> None:
    """Raise on what the gated kernel does not take; the shared-memory
    check asks the built kernel for its layout, so it comes last."""
    if values.dim() != 3 or min(values.shape) < 1:
        raise ValueError(f"values must be [C, N, M] with C, N, M >= 1, got {tuple(values.shape)}")
    c, n, dim = values.shape
    if values.dtype != torch.float32:
        raise ValueError(f"values must be float32, got {values.dtype}")
    if tuple(ok.shape) != (c, n) or ok.dtype != torch.bool:
        raise ValueError(f"ok must be bool [C, N] = [{c}, {n}], got {ok.dtype} {tuple(ok.shape)}")
    if tuple(claim_mask.shape) != (c,) or claim_mask.dtype != torch.bool:
        raise ValueError(
            f"claim_mask must be bool [C] = [{c}], got {claim_mask.dtype} {tuple(claim_mask.shape)}"
        )
    if not (values.is_contiguous() and ok.is_contiguous() and claim_mask.is_contiguous()):
        raise ValueError("values, ok and claim_mask must be contiguous")
    if cfg.smooth_mode != "cairo":
        raise ValueError(
            f"the gated claim-cube kernel implements smooth_mode 'cairo' only, "
            f"got {cfg.smooth_mode!r}"
        )
    if any(t.device.type != "cuda" for t in (values, ok, claim_mask)) or not (
        values.device == ok.device == claim_mask.device
    ):
        raise ValueError(
            f"the CUDA kernel needs values, ok and claim_mask on one CUDA device, got "
            f"{values.device}, {ok.device}, {claim_mask.device}"
        )
    need = _gated_smem_bytes(n, dim)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"a [{n}, {dim}] fleet needs {need} bytes of shared memory, "
            f"more than one block's {MAX_SMEM_BYTES}"
        )


@functools.cache
def _gated_lib():
    lib = _build.load("gated_claims_consensus")
    lib.svoc_gated_claims_consensus.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.svoc_gated_claims_consensus.restype = ctypes.c_int
    lib.svoc_gated_claims_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.svoc_gated_claims_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _gated_smem_bytes(n: int, dim: int) -> int:
    return _gated_lib().svoc_gated_claims_smem_bytes(n, dim)


def fused_consensus_gated_claims_cuda(
    values: torch.Tensor,
    ok: torch.Tensor,
    claim_mask: torch.Tensor,
    cfg: ConsensusConfig,
) -> ConsensusOutput:
    """Launch ``csrc/gated_claims_consensus.cu`` on the values' device
    and its current stream: one block per claim; padding claims come back
    inactive."""
    _check_gated_inputs(values, ok, claim_mask, cfg)
    c, n, dim = values.shape
    dev = values.device
    f32 = dict(dtype=torch.float32, device=dev)
    essence = torch.empty(c, dim, **f32)
    essence1 = torch.empty(c, dim, **f32)
    rel1 = torch.empty(c, **f32)
    rel2 = torch.empty(c, **f32)
    reliable = torch.empty(c, n, dtype=torch.bool, device=dev)
    qr = torch.empty(c, n, **f32)
    skew = torch.empty(c, dim, **f32)
    kurt = torch.empty(c, dim, **f32)
    valid = torch.empty(c, dtype=torch.bool, device=dev)
    _build.launch(
        "gated_claims_consensus", _gated_lib().svoc_gated_claims_consensus, dev,
        values.data_ptr(), ok.data_ptr(), claim_mask.data_ptr(), essence.data_ptr(),
        essence1.data_ptr(), rel1.data_ptr(), rel2.data_ptr(), reliable.data_ptr(),
        qr.data_ptr(), skew.data_ptr(), kurt.data_ptr(), valid.data_ptr(),
        c, n, dim, cfg.n_failing, int(cfg.constrained), float(cfg.max_spread),
    )
    fused_consensus_gated_claims_cuda.launches += 1
    return ConsensusOutput(
        essence=essence,
        essence_first_pass=essence1,
        reliability_first_pass=rel1,
        reliability_second_pass=rel2,
        reliable=reliable,
        quadratic_risk=qr,
        skewness=skew,
        kurtosis=kurt,
        interval_valid=valid,
    )


#: Kernel launches since the count was last set to 0.
fused_consensus_gated_claims_cuda.launches = 0


def fused_consensus_gated_claims(
    values: torch.Tensor,
    ok: torch.Tensor,
    claim_mask: "torch.Tensor | None" = None,
    cfg: ConsensusConfig = ConsensusConfig(),
) -> ConsensusOutput:
    """Gated two-pass consensus over a padded claim cube ``values [C, N,
    M]`` float32 with admission masks ``ok [C, N]`` and active claims
    ``claim_mask [C]`` (all active when None): the plain version for CPU
    tensors, one kernel launch for CUDA tensors."""
    if claim_mask is None:
        claim_mask = torch.ones(values.shape[0], dtype=torch.bool, device=values.device)
    if values.device.type == "cpu":
        return fused_consensus_gated_claims_plain(values, ok, claim_mask, cfg)
    return fused_consensus_gated_claims_cuda(values, ok, claim_mask, cfg)
