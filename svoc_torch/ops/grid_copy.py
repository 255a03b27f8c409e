"""Gridded block copy: the plain PyTorch version and the wrapper of its
CUDA kernel.

Mirrors the ``pallas_call`` of the reference's probe tool
(``tools/tpu_probe.py:99-112``): a copy kernel over a 2-D grid whose
``BlockSpec((1, 128, 128), lambda i, j: (i, j, 0))`` cuts a
``[4, 256, 128]`` float32 array into eight tiles.  The kernel is
``svoc_torch/csrc/grid_copy.cu``; what it is for is the probe
(:mod:`svoc_torch.tools.probe`): does a kernel with a multi-dimensional
grid build, load and launch on this card, on the caller's stream.

:func:`grid_copy` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor; on CUDA it raises rather than
fall back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from svoc_torch.ops import _build

#: CUDA's grid limits (x, y, z).
MAX_GRID = (2**31 - 1, 65535, 65535)


def _grid(x: torch.Tensor, block: Sequence[int]) -> Tuple[int, int, int]:
    """The grid ``(G, R/br, C/bc)`` of ``block`` over ``x``; raises on a
    block that does not tile ``x`` exactly, as a ``BlockSpec`` would."""
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty [G, R, C] tensor, got {tuple(x.shape)}")
    if len(block) != 3 or block[0] != 1 or block[1] < 1 or block[2] < 1:
        raise ValueError(f"block must be (1, br, bc) with br, bc >= 1, got {tuple(block)}")
    g, r, c = x.shape
    if r % block[1] or c % block[2]:
        raise ValueError(f"block {tuple(block)} does not divide the shape {tuple(x.shape)}")
    return g, r // block[1], c // block[2]


def grid_copy_plain(x: torch.Tensor, block: Sequence[int]) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: a loop over
    the grid that assigns tile by tile, so that a wrong index map would
    show."""
    grid = _grid(x, block)
    _, br, bc = block
    out = torch.empty_like(x)
    for g in range(grid[0]):
        for i in range(grid[1]):
            for j in range(grid[2]):
                rows, cols = slice(i * br, (i + 1) * br), slice(j * bc, (j + 1) * bc)
                out[g, rows, cols] = x[g, rows, cols]
    return out


@functools.cache
def _kernel():
    fn = _build.load("grid_copy").svoc_grid_copy
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grid_copy_cuda(x: torch.Tensor, block: Sequence[int]) -> torch.Tensor:
    """Launch ``csrc/grid_copy.cu`` on x's device and its current stream:
    one thread block per grid cell.  Raises ``ValueError`` on what the
    kernel does not take."""
    grid = _grid(x, block)
    if x.element_size() not in (2, 4):
        raise ValueError(f"the kernel copies 2- and 4-byte elements, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if any(n > limit for n, limit in zip(grid, MAX_GRID)):
        raise ValueError(f"grid {grid} exceeds CUDA's limits {MAX_GRID}")
    if x.device.type != "cuda":
        raise ValueError("the CUDA kernel needs a tensor on a CUDA device")
    _, br, bc = block
    out = torch.empty_like(x)
    es = x.element_size()
    vec = (
        x.data_ptr() % 16 == 0
        and out.data_ptr() % 16 == 0
        and (x.shape[2] * es) % 16 == 0
        and (bc * es) % 16 == 0
    )
    _build.launch(
        "grid copy", _kernel(), x.device,
        x.data_ptr(), out.data_ptr(), es, x.shape[0], x.shape[1], x.shape[2], br, bc, int(vec),
    )
    grid_copy_cuda.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
grid_copy_cuda.launches = 0


def grid_copy(x: torch.Tensor, block: Sequence[int]) -> torch.Tensor:
    """``x [G, R, C]`` copied in tiles of ``block = (1, br, bc)`` over the
    grid ``(G, R/br, C/bc)``: the plain version on the CPU, the kernel on
    CUDA."""
    if x.device.type == "cpu":
        return grid_copy_plain(x, block)
    return grid_copy_cuda(x, block)
