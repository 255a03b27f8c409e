"""A fleet's draws in one launch: the plain PyTorch version and the
wrapper of its CUDA kernel.

The draws are those of :func:`svoc_torch.sim.oracle.draw_fleet` (the
reference's ``gen_oracle_predictions``, ``svoc_tpu/sim/oracle.py:23-59``),
bit for bit as ``jax.random`` under jax 0.9.0 draws them: from each claim
key, ``k_fail, k_boot, k_perm = split(key, 3)``; ``uniform(k_fail,
(n_failing, M))``; ``choice(k, W, (S,), replace=False)`` for each of
``split(k_boot, N - n_failing)``; ``permutation(k_perm, N)``.  It has no
Pallas counterpart: XLA fuses each draw with its hash.

:func:`fleet_draws_plain` is the composition of :mod:`svoc_torch.sim.prng`
(on CUDA: 7 threefry launches and two ``torch.sort`` calls a batch of
fleets); the kernel ``svoc_torch/csrc/fleet_draws.cu`` computes every
claim's key schedule, subsets, shuffle and failing values in one launch.
:func:`svoc_torch.sim.oracle.draw_fleet` takes the plain version for
keys on the CPU and launches the kernel for keys on CUDA; on CUDA it
raises rather than fall back, before any launch, on a shape the kernel
does not take.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from svoc_torch.ops import _build

#: The kernel's limits: one shuffle round for the subsets (``shuffle_rounds``
#: is 1 up to 1625), the shuffle's numbers and its round's order in one
#: block's 227 KB of shared memory, and the jobs of a claim on the grid's y.
MAX_WINDOW = 1625
MAX_ORACLES = 16384
_WARPS, _FAIL_PER_BLOCK = 8, 1024  # a block: 8 subsets (a warp each), or 1024 failing values
_MAX_JOBS = 65535
_MAX_CLAIMS = 2**31 - 1


class FleetDraws(NamedTuple):
    failing_vals: torch.Tensor  #: [..., n_failing, M] uniform(0, 1), float32
    boot_idx: torch.Tensor  #: [..., n_oracles - n_failing, subset] window rows, no repeats per row
    perm: torch.Tensor  #: [..., n_oracles] the shuffle


def _check(keys: torch.Tensor, window_rows: int, dim: int, n_oracles: int, n_failing: int,
           subset_size: int) -> None:
    if keys.shape[-1:] != (2,) or keys.dtype != torch.int64:
        raise ValueError(f"keys must be [..., 2] int64, got {tuple(keys.shape)} {keys.dtype}")
    if not 0 < subset_size <= window_rows:
        raise ValueError(f"subset_size {subset_size} must be in [1, {window_rows}]")
    if not 0 <= n_failing <= n_oracles or dim < 0:
        raise ValueError(f"need 0 <= n_failing <= n_oracles and dim >= 0, got n_failing {n_failing}, "
                         f"n_oracles {n_oracles}, dim {dim}")


def fleet_draws_plain(keys: torch.Tensor, window_rows: int, dim: int, n_oracles: int, n_failing: int,
                      subset_size: int = 10) -> FleetDraws:
    """The kernel's function in plain PyTorch, on any device: the draws
    of :mod:`svoc_torch.sim.prng`, one call each."""
    # At first use: svoc_torch.sim's package imports sim/oracle.py, which
    # imports this module.
    from svoc_torch.sim import prng

    _check(keys, window_rows, dim, n_oracles, n_failing, subset_size)
    k_fail, k_boot, k_perm = prng.split(keys, 3).unbind(-2)
    failing_vals = prng.uniform(k_fail, (n_failing, dim))
    boot_idx = prng.choice(prng.split(k_boot, n_oracles - n_failing), window_rows, subset_size)
    perm = prng.permutation(k_perm, n_oracles)
    return FleetDraws(failing_vals, boot_idx, perm)


def _check_kernel(keys: torch.Tensor, window_rows: int, dim: int, n_oracles: int, n_failing: int,
                  subset_size: int) -> None:
    _check(keys, window_rows, dim, n_oracles, n_failing, subset_size)
    if window_rows > MAX_WINDOW:
        raise ValueError(f"a window of {window_rows} rows needs two shuffle rounds for its subsets; "
                         f"the kernel takes at most {MAX_WINDOW}")
    if n_oracles > MAX_ORACLES:
        raise ValueError(f"{n_oracles} oracles exceed the kernel's shuffle in shared memory "
                         f"(at most {MAX_ORACLES})")
    # A claim's blocks: its shuffle, its subsets, its failing values.
    jobs = 1 + math.ceil((n_oracles - n_failing) / _WARPS) + math.ceil(n_failing * dim / _FAIL_PER_BLOCK)
    if jobs > _MAX_JOBS:
        raise ValueError(f"{n_oracles} oracles of {dim} values exceed one claim's jobs on the grid")
    if math.prod(keys.shape[:-1]) > _MAX_CLAIMS:
        raise ValueError(f"{math.prod(keys.shape[:-1])} claims exceed one launch's grid")


@functools.cache
def _kernel():
    fn = _build.load("fleet_draws").svoc_fleet_draws
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 8 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def fleet_draws_cuda(keys: torch.Tensor, window_rows: int, dim: int, n_oracles: int, n_failing: int,
                     subset_size: int = 10) -> FleetDraws:
    """Launch ``csrc/fleet_draws.cu`` on the keys' device and its current
    stream: every claim's draws in one launch.  Raises ``ValueError`` on
    what the kernel does not take, before any launch."""
    from svoc_torch.sim.prng import shuffle_rounds  # at first use, as in fleet_draws_plain

    _check_kernel(keys, window_rows, dim, n_oracles, n_failing, subset_size)
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernel needs keys on a CUDA device")
    lead, h = keys.shape[:-1], n_oracles - n_failing
    c = math.prod(lead)
    if not keys.is_contiguous():
        keys = keys.contiguous()
    # Each output in its final shape: claim-major, as the kernel writes it.
    failing = torch.empty((*lead, n_failing, dim), dtype=torch.float32, device=dev)
    boot = torch.empty((*lead, h, subset_size), dtype=torch.int64, device=dev)
    perm = torch.empty((*lead, n_oracles), dtype=torch.int64, device=dev)
    if c:
        _build.launch("fleet_draws", _kernel(), dev, keys.data_ptr(), c, window_rows, dim, n_oracles, n_failing,
                      subset_size, shuffle_rounds(window_rows), shuffle_rounds(n_oracles), failing.data_ptr(),
                      boot.data_ptr(), perm.data_ptr())
        fleet_draws_cuda.launches += 1
    return FleetDraws(failing, boot, perm)


#: Kernel launches since the count was last set to 0.
fleet_draws_cuda.launches = 0
