"""threefry2x32: the plain PyTorch version and the wrapper of its CUDA
kernel.

Mirrors JAX's default PRNG hash under jax 0.9.0: ``threefry2x32_p`` and
its unrolled lowering ``_threefry2x32_lowering``
(``jax/_src/prng.py:863-938``), 20 rounds of add, rotate and xor with a
key injection after every four.  It has no Pallas counterpart: XLA fuses
the hash into the draw that uses it.  The kernel is
``svoc_torch/csrc/threefry.cu`` (4 counters of one key a thread, its key
found by a multiply-high, its words stored 16 bytes at a time; the rounds
are ``csrc/threefry.cuh``, which the fleet-draws kernel shares); the
draws built on it are :mod:`svoc_torch.sim.prng`.  A fleet's draws on
CUDA do not launch it: :mod:`svoc_torch.ops.fleet_draws` hashes its whole
key schedule in one launch of its own.

Words are uint32 values held in int64 tensors (``[0, 2**32)``), so that
they sort, compare and index as unsigned numbers.

:func:`threefry` takes the plain version for keys on the CPU and
launches the kernel for keys on CUDA; on CUDA it raises rather than fall
back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from svoc_torch.ops import _build

MASK = 0xFFFFFFFF
#: jax/_src/prng.py:895-896; the groups of four rounds alternate.
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: The kernel's grid: 4 counters of one key a thread, and every thread's
#: index (keys x counter groups) below 2**31 - 256, so that its index
#: arithmetic fits 32 bits.
PER_THREAD = 4
_MAX_THREADS = 2**31 - 256
_MAX_COUNTERS = 2**31


def threefry2x32_plain(k1, k2, x1, x2):
    """``(y1, y2) = threefry2x32((k1, k2), (x1, x2))`` elementwise over
    broadcast int64 tensors of uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for r in range(5):
        for rot in ROTATIONS[r % 2]:
            x1 = (x1 + x2) & MASK
            x2 = ((x2 << rot) | (x2 >> (32 - rot))) & MASK
            x2 = x1 ^ x2
        x1 = (x1 + ks[(r + 1) % 3]) & MASK
        x2 = (x2 + ks[(r + 2) % 3] + r + 1) & MASK
    return x1, x2


def _check(keys: torch.Tensor, n: int, base) -> None:
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys must be [B, 2] int64, got {tuple(keys.shape)} {keys.dtype}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if isinstance(base, torch.Tensor):
        if base.shape != (keys.shape[0],) or base.dtype != torch.int64:
            raise ValueError(f"base must be [{keys.shape[0]}] int64, got {tuple(base.shape)} {base.dtype}")
        if base.device != keys.device:
            raise ValueError("base must lie on the keys' device")
    elif not 0 <= base <= MASK:
        raise ValueError(f"base must be a uint32, got {base}")
    if n > 2**32:
        raise ValueError(f"n must be at most 2**32, got {n}")


def threefry_plain(keys: torch.Tensor, n: int, base: Union[int, torch.Tensor] = 0,
                   xor: bool = False) -> torch.Tensor:
    """The function of the kernel in plain PyTorch, on any device."""
    _check(keys, n, base)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    c = base[:, None] + i if isinstance(base, torch.Tensor) else base + i[None, :]
    y1, y2 = threefry2x32_plain(keys[:, 0:1], keys[:, 1:2], c >> 32, c & MASK)
    return y1 ^ y2 if xor else torch.stack([y1, y2], dim=-1)


@functools.cache
def _kernel():
    fn = _build.load("threefry").svoc_threefry2x32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def threefry_cuda(keys: torch.Tensor, n: int, base: Union[int, torch.Tensor] = 0,
                  xor: bool = False) -> torch.Tensor:
    """Launch ``csrc/threefry.cu`` on the keys' device and its current
    stream: 4 counters of one key a thread.  Raises ``ValueError`` on
    what the kernel does not take, before any launch."""
    _check(keys, n, base)
    b = keys.shape[0]
    if n >= _MAX_COUNTERS or b * -(-n // PER_THREAD) > _MAX_THREADS:
        raise ValueError(f"{b} x {n} counters exceed one launch's grid (fewer than 2**31 counters a key "
                         f"and 2**31 - 256 groups of {PER_THREAD} in all)")
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernel needs keys on a CUDA device")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if isinstance(base, torch.Tensor):
        if not base.is_contiguous():
            raise ValueError("base must be contiguous")
        base_ptr, base0 = base.data_ptr(), 0
    else:
        base_ptr, base0 = None, base
    out = torch.empty((b, n) if xor else (b, n, 2), dtype=torch.int64, device=dev)
    if b * n == 0:
        return out
    _build.launch("threefry", _kernel(), dev, keys.data_ptr(), base_ptr, base0, b, n, int(xor),
                  out.data_ptr())
    threefry_cuda.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
threefry_cuda.launches = 0


def threefry(keys: torch.Tensor, n: int, base: Union[int, torch.Tensor] = 0,
             xor: bool = False) -> torch.Tensor:
    """``out[b, i] = threefry2x32(keys[b], (hi, lo))`` where ``(hi, lo)``
    are the 32-bit words of ``base[b] + i`` (``base`` a uint32, one int
    or one per key; the caller keeps a tensor's values in ``[0, 2**32)``),
    for ``i < n``: ``[B, n, 2]``, or ``[B, n]`` of ``y1 ^ y2`` with
    ``xor``.  The plain version for keys on the CPU, the kernel on CUDA."""
    if keys.device.type == "cpu":
        return threefry_plain(keys, n, base, xor)
    return threefry_cuda(keys, n, base, xor)
