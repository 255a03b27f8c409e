"""Flash attention with tag masks, forward and backward: the plain
PyTorch versions, the wrappers of their CUDA kernels, and the autograd
Function that joins them.

Mirrors :mod:`svoc_tpu.ops.pallas_attention` (``_tag_mask``,
``_flash_kernel``, ``_p_block``, ``_flash_dq_kernel``,
``_flash_dkv_kernel``, ``_flash_diff`` and ``flash_attention``;
``pallas_attention.py:48-131, 142-249, 378-502``).  The kernels are
``svoc_torch/csrc/flash_attention.cu`` (forward) and
``svoc_torch/csrc/flash_attention_bwd.cu`` (dq, and dk with dv).  The
input type chooses the body inside each kernel: bf16 runs the forward,
dq and dk/dv on the tensor cores (``mma.sync``, bf16 operands, fp32
accumulators), float32 runs fp32 arithmetic on the CUDA cores, which its
2e-5 (forward) and 1e-4 (backward) contracts need.

One mask rule covers both modes: query i sees key j iff their tags are
equal and the key's tag is > 0.  Packed rows (``segment_ids``) use the
segment ids as both tags, so a padding query sees nothing; per-key
padding (``kmask``) uses query tags of 1 and the mask as key tags.  A
row that sees no key outputs exactly 0, with an lse of ``-inf``, and
gets exactly 0 gradient; so does a key that no query sees.

:func:`flash_attention` takes the plain versions for tensors on the CPU
and launches the kernels for CUDA tensors; on CUDA it raises rather than
fall back.  With grad enabled and q, k or v requiring grad it goes
through :class:`FlashAttentionFunction` (the FlashAttention-2 backward,
p recomputed from the saved lse); otherwise it runs the forward alone.
Unlike the TPU kernels, T need not divide any block size.
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


def tag_mask(qtag: torch.Tensor, ktag: torch.Tensor) -> torch.Tensor:
    """``[B, Tq, Tk]``: query i sees key j iff their tags are equal and
    the key's tag is > 0 (``_tag_mask``, ``pallas_attention.py:60``)."""
    return (qtag[:, :, None] == ktag[:, None, :]) & (ktag[:, None, :] > 0)


def flash_attention_plain(q, k, v, qtag, ktag, return_lse: bool = False):
    """The kernel's function in plain PyTorch on ``[B, T, H, D]`` (fp32
    arithmetic, output in q's dtype), on any device."""
    d = q.shape[-1]
    qf = q.float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    live = tag_mask(qtag, ktag)[:, None]  # [B, 1, Tq, Tk]
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


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO·O)`` in fp32, ``[B, T, H]``: the backward's
    per-row term, computed outside the kernels as the JAX package does
    in XLA (``pallas_attention.py:402``)."""
    return (dout.float() * out.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, qtag, ktag, out, lse, dout):
    """The backward kernels' function in plain PyTorch: ``(dq, dk, dv)``
    in q's dtype and the public ``[B, T, H, D]`` layout, from the
    forward's ``out`` and ``lse [B, T, H]`` and the cotangent ``dout``.

    fp32 arithmetic; p is recomputed from the saved lse and is exactly 0
    on masked pairs and on rows whose lse is ``-inf`` (``_p_block``);
    ``ds = p·(dP − delta)``, ``dq = scale·Σ ds·k``, ``dk = scale·Σ dsᵀ·q``,
    ``dv = Σ pᵀ·dO``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    s = scale * torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    row_lse = lse.permute(0, 2, 1)[..., None]  # [B, H, Tq, 1]
    finite = torch.isfinite(row_lse)
    live = tag_mask(qtag, ktag)[:, None] & finite
    p = torch.where(live, torch.exp(s - torch.where(finite, row_lse, 0.0)), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = attention_delta(out, dout).permute(0, 2, 1)[..., None]  # [B, H, Tq, 1]
    ds = p * (dp - delta)
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


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
    _check_aligned(q, k, v)


def _check_aligned(*tensors) -> None:
    """The bf16 bodies move rows by 16-byte ``cp.async``: every bf16
    tensor must start on a 16-byte boundary (a fresh allocation does)."""
    if any(x.dtype == torch.bfloat16 and x.data_ptr() % 16 for x in tensors):
        raise ValueError("bf16 q, k, v and dout must start on a 16-byte boundary")


def _check_bwd_inputs(q, k, v, qtag, ktag, dout, lse, delta) -> None:
    """Raise on what the backward kernels do not take."""
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout must be {q.dtype} {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != q.shape[:3] or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:3])}")
    extra = (dout, lse, delta)
    if not all(x.is_contiguous() for x in extra):
        raise ValueError("dout, lse and delta must be contiguous")
    _check_kernel_inputs(q, k, v, qtag, ktag)
    if any(x.device != q.device for x in extra):
        raise ValueError("the CUDA kernel needs every tensor on one CUDA device")
    _check_aligned(dout)


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").svoc_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel(name: str):
    """``svoc_flash_attention_dq`` (one output) or ``..._dkv`` (two)."""
    fn = getattr(_build.load("flash_attention_bwd"), name)
    n_out = 1 if name.endswith("_dq") else 2
    fn.argtypes = [ctypes.c_void_p] * (8 + n_out) + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch_bwd(name, q, k, v, qtag, ktag, dout, lse, delta, outs) -> None:
    b, t, h, d = q.shape
    _build.launch(
        name, _bwd_kernel(name), q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qtag.data_ptr(), ktag.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
        int(q.dtype == torch.bfloat16), b, t, h, d, 1.0 / math.sqrt(d),
    )


def flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta):
    """Launch the dq kernel of ``csrc/flash_attention_bwd.cu``:
    ``dq [B, T, H, D]`` in q's dtype, from ``dout`` (q's dtype) and the
    fp32 ``lse`` and ``delta [B, T, H]``."""
    _check_bwd_inputs(q, k, v, qtag, ktag, dout, lse, delta)
    dq = torch.empty_like(q)
    _launch_bwd("svoc_flash_attention_dq", q, k, v, qtag, ktag, dout, lse, delta, (dq,))
    flash_dq_cuda.launches += 1
    return dq


def flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta):
    """Launch the dk/dv kernel of ``csrc/flash_attention_bwd.cu``:
    ``(dk, dv)``, each ``[B, T, H, D]`` in q's dtype."""
    _check_bwd_inputs(q, k, v, qtag, ktag, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("svoc_flash_attention_dkv", q, k, v, qtag, ktag, dout, lse, delta, (dk, dv))
    flash_dkv_cuda.launches += 1
    return dk, dv


#: Kernel launches since each count was last set to 0.
flash_dq_cuda.launches = 0
flash_dkv_cuda.launches = 0


def flash_attention_cuda(q, k, v, qtag, ktag, return_lse: bool = False):
    """Launch ``csrc/flash_attention.cu`` on q's device and its current
    stream."""
    _check_kernel_inputs(q, k, v, qtag, ktag)
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    lse = (
        torch.empty((b, t, h), dtype=torch.float32, device=q.device)
        if return_lse
        else None
    )
    _build.launch(
        "flash attention", _kernel(), q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qtag.data_ptr(), ktag.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        int(q.dtype == torch.bfloat16), b, t, h, d, 1.0 / math.sqrt(d),
    )
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


#: Kernel launches since the count was last set to 0.
flash_attention_cuda.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention over ``[B, T, H, D]`` with int32
    tags: the counterpart of ``_flash_diff`` (``pallas_attention.py:
    378-415``).  The forward keeps the lse; the backward computes delta
    in fp32, then runs the dq and dk/dv kernels on CUDA, or the plain
    backward on the CPU.  The tags get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, qtag, ktag):
        fwd = flash_attention_plain if q.device.type == "cpu" else flash_attention_cuda
        out, lse = fwd(q, k, v, qtag, ktag, return_lse=True)
        ctx.save_for_backward(q, k, v, qtag, ktag, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qtag, ktag, out, lse = ctx.saved_tensors
        # The cotangent arrives through SelfAttention's reshape, possibly
        # strided; the kernels read it in place.
        dout = dout.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, qtag, ktag, out, lse, dout)
        else:
            delta = attention_delta(out, dout)
            dq = flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta)
            dk, dv = flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta)
        return dq, dk, dv, None, None


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
    key is seen.

    Differentiable: with grad enabled and q, k or v requiring grad the
    call goes through :class:`FlashAttentionFunction`.  ``return_lse``
    is inference-only, as in the JAX package, and raises there."""
    qtag, ktag = attention_tags(q, kmask, segment_ids)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if return_lse:
            raise ValueError("return_lse=True is inference-only: its lse has no gradient")
        return FlashAttentionFunction.apply(q, k, v, qtag, ktag)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, qtag, ktag, return_lse)
    return flash_attention_cuda(q, k, v, qtag, ktag, return_lse)
