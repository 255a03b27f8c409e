"""Single-claim fused two-pass consensus: the plain PyTorch version and
the wrapper of its CUDA kernel.

Mirrors the single-claim part of :mod:`svoc_tpu.ops.pallas_consensus`
(``FusedConsensusOutput``, ``fused_consensus`` and the kernel body
``_consensus_kernel``, ``pallas_consensus.py:104-372``).  The kernel is
``svoc_torch/csrc/fused_consensus.cu``.

:func:`fused_consensus` takes the plain version for a tensor on the CPU
and launches the kernel for a CUDA tensor; on CUDA it raises rather than
fall back (a ``smooth_mode`` other than ``"cairo"``, a fleet whose
working set exceeds one block's shared memory).  The TPU-only limits on
the fleet size (a multiple of 128, at most 1024) do not apply.

Semantics are those of the TPU kernel, which differ from
:func:`svoc_torch.consensus.kernel.consensus_step` in two details:
``m = N - n_failing`` is a constant of the call (no clamp at 1), and a
smooth-median rank outside ``[0, N)`` reads 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from svoc_torch.consensus.kernel import ConsensusConfig, reliability
from svoc_torch.ops import _build
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


def row_risk(v: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """``Σ_c (v - center)²`` per row, summed in column order with each
    product and sum rounded on its own, as the kernel does."""
    d = v - center
    qr = d[:, 0] * d[:, 0]
    for c in range(1, v.shape[1]):
        qr = qr + d[:, c] * d[:, c]
    return qr


def fused_consensus_plain(
    values: torch.Tensor, cfg: ConsensusConfig
) -> FusedConsensusOutput:
    """The kernel's computation in plain PyTorch, on any device."""
    n, dim = values.shape
    v = values.float()
    m = n - cfg.n_failing
    mf = torch.tensor(float(m), device=v.device)

    essence1 = _smooth_median(v, None, n)
    qr = row_risk(v, essence1)
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
    """Launch ``csrc/fused_consensus.cu`` on the current stream."""
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
    err = _lib().svoc_fused_consensus(
        values.data_ptr(), essence.data_ptr(), essence1.data_ptr(), rel.data_ptr(),
        mask.data_ptr(), qr.data_ptr(), moments.data_ptr(),
        n, dim, m, lo_all, hi_all, lo_rel, hi_rel, int(cfg.constrained),
        float(cfg.max_spread), torch.cuda.current_stream(values.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_consensus kernel launch failed: CUDA error {err}")
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
