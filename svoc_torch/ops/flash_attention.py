"""Forward flash attention with tag masks: the plain PyTorch version and
the wrapper of its CUDA kernel.

Mirrors the forward of :mod:`svoc_tpu.ops.pallas_attention`
(``_tag_mask``, ``_flash_kernel``, ``flash_attention``;
``pallas_attention.py:48-131, 252-308, 421-502``).  The kernel is
``svoc_torch/csrc/flash_attention.cu``.

One mask rule covers both modes: query i sees key j iff their tags are
equal and the key's tag is > 0.  Packed rows (``segment_ids``) use the
segment ids as both tags, so a padding query sees nothing; per-key
padding (``kmask``) uses query tags of 1 and the mask as key tags.  A
row that sees no key outputs exactly 0, with an lse of ``-inf``.

:func:`flash_attention` takes the plain version for tensors on the CPU
and launches the kernel for CUDA tensors; on CUDA it raises rather than
fall back.  Unlike the TPU kernel, T need not divide any block size.
The backward kernels (``_flash_dq_kernel``, ``_flash_dkv_kernel``) are
not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from svoc_torch.ops import _build

#: The TPU kernel's finite "minus infinity" (``pallas_attention.py:48``).
NEG_INF = -1e30

#: Head widths the kernel is built for.
HEAD_DIMS = (16, 32, 64, 128)


def attention_tags(
    q: torch.Tensor,
    kmask: "torch.Tensor | None" = None,
    segment_ids: "torch.Tensor | None" = None,
):
    """``(qtag, ktag)`` int32 ``[B, T]`` for the two masking modes."""
    b, t = q.shape[:2]
    if segment_ids is not None:
        if kmask is not None:
            raise ValueError("pass kmask or segment_ids, not both")
        tags = segment_ids.to(torch.int32).contiguous()
        return tags, tags
    ones = torch.ones((b, t), dtype=torch.int32, device=q.device)
    if kmask is None:
        return ones, ones
    return ones, kmask.to(torch.int32).contiguous()


def flash_attention_plain(q, k, v, qtag, ktag, return_lse: bool = False):
    """The kernel's function in plain PyTorch on ``[B, T, H, D]`` (fp32
    arithmetic, output in q's dtype), on any device."""
    d = q.shape[-1]
    qf = q.float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    live = (qtag[:, :, None] == ktag[:, None, :]) & (ktag[:, None, :] > 0)
    live = live[:, None]  # [B, 1, Tq, Tk]
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / torch.clamp(
        l, min=1e-30
    ).permute(0, 2, 1, 3)
    dead = ~live.any(dim=-1)  # [B, 1, Tq]
    out = torch.where(dead.permute(0, 2, 1)[..., None], 0.0, out).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(dead, -torch.inf, (m + torch.log(l))[..., 0])  # [B, H, T]
    return out, lse.permute(0, 2, 1).contiguous()


def _check_kernel_inputs(q, k, v, qtag, ktag) -> None:
    """Raise on what the CUDA kernel does not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, D], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bfloat16 or float32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} and heads {h} must each be <= 65535")
    for name, tag in (("qtag", qtag), ("ktag", ktag)):
        if tag.shape != (b, t) or tag.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{b}, {t}]")
    tensors = (q, k, v, qtag, ktag)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, k, v and the tags must be contiguous")
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError("the CUDA kernel needs every tensor on one CUDA device")


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").svoc_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, qtag, ktag, return_lse: bool = False):
    """Launch ``csrc/flash_attention.cu`` on the current stream."""
    _check_kernel_inputs(q, k, v, qtag, ktag)
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    lse = (
        torch.empty((b, t, h), dtype=torch.float32, device=q.device)
        if return_lse
        else None
    )
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qtag.data_ptr(), ktag.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        int(q.dtype == torch.bfloat16), b, t, h, d, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


#: Kernel launches since the count was last set to 0.
flash_attention_cuda.launches = 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kmask: "torch.Tensor | None" = None,
    segment_ids: "torch.Tensor | None" = None,
    return_lse: bool = False,
):
    """``q, k, v [B, T, H, D]`` → ``[B, T, H, D]`` (and the lse
    ``[B, T, H]`` with ``return_lse``).  ``kmask [B, T]`` (1 = real key)
    or ``segment_ids [B, T]`` (0 = padding) masks; with neither, every
    key is seen."""
    qtag, ktag = attention_tags(q, kmask, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, qtag, ktag, return_lse)
    return flash_attention_cuda(q, k, v, qtag, ktag, return_lse)
