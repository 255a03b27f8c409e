"""Ring attention: exact attention over a sequence-sharded mesh axis.

Mirrors :mod:`svoc_tpu.parallel.ring_attention` (``_ring_protocol``
:36, ``ring_rotate`` :54, ``_block_attn`` :62, ``ring_attention`` :75,
``ring_attention_fn`` :274, ``dense_attention_reference`` :300).  The
sequence axis is split over the mesh: each slot holds a Q/K/V block
``[B, T_local, H, D]``, and the K/V blocks (with their key masks) travel
round the ring by :func:`svoc_torch.parallel.sharded.ppermute`, shard
``s`` → ``s + 1``, while a streaming softmax accumulates the exact
result.  The slot processes its own block first, then each of the
``n − 1`` blocks that arrive.

The per-hop attention (``block_impl``):

- ``"dense"``: the einsum chain of ``_block_attn`` merged by the
  online-softmax recurrence (running max ``m``, sum ``l``, output
  ``o``).  A query row that sees no real key anywhere in the ring
  returns exactly 0, as the flash rule does.
- ``"flash"``: B1, ``svoc_torch/csrc/flash_attention.cu``, once a hop
  through :func:`svoc_torch.ops.flash_attention.flash_attention` with
  the hop's key mask and ``return_lse=True`` (its plain version on CPU
  tensors).  Hops merge by log-sum-exp under the reference's
  double-``where`` guard: a hop whose keys are all padding gives lse
  ``-inf`` and output 0, and a row dead so far keeps weight 0 instead of
  the NaN of ``exp(-inf − -inf)``.  Inference only, as in the reference:
  its lse has no gradient.

**The backward.**  The reference's dense inner carries a two-pass ring
custom VJP (``:157-270``): reverse mode through ``fori_loop`` would
transpose every ``ppermute``.  The port does not port it.  Its runner is
single-controller: every slot's ops land on one autograd graph, and a
rotation is a ``.to(device)`` that autograd carries back to the source
slot, so autograd differentiates the forward's rotation as it stands.
The backward then runs on autograd's engine after the shard_map has
returned, with no collective in it.  A custom ``torch.autograd.Function``
whose backward rotated the dk/dv accumulators would have to run its
collectives on autograd's threads, outside the runner's lockstep, where
a collective has no slot context.  The price is memory: autograd keeps
every hop's score block for the backward, ``[B, H, T_local, T]`` a slot
in all, where the reference recomputes them in its second pass.  The
gradients are the same function (held to the reference's 1e-5 in
``tests/test_torch_ring_attention.py``), dead rows' exactly 0.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from svoc_torch.ops.dense_attention import NEG_INF, _rsqrt_f32, dense_attention_reference  # noqa: F401
from svoc_torch.parallel.mesh import Mesh, P
from svoc_torch.parallel.sharded import axis_size, ppermute, shard_map

BLOCK_IMPLS = ("dense", "flash")


def ring_rotate(tree, axis_name: str, n_dev: int):
    """One forward rotation (shard s → s + 1) of a tensor or a tuple of
    them, in one exchange."""
    perm = [(s, (s + 1) % n_dev) for s in range(n_dev)]
    return ppermute(tree, axis_name, perm)


def _ring_protocol(axis_name: str, n_dev: int, rotating, carry, update):
    """THE ring rotation loop, the single place the permutation lives:
    ``update(rotating, carry) → carry`` on the local blocks, then after
    each of the ``n_dev − 1`` rotations of ``rotating``."""
    carry = update(rotating, carry)
    for _ in range(n_dev - 1):
        rotating = ring_rotate(rotating, axis_name, n_dev)
        carry = update(rotating, carry)
    return carry


def _block_attn(q, k, v, kmask, scale: float):
    """Scores and masked exp-stats for one K/V block: ``(m_blk [B, H,
    Tq], p [B, H, Tq, Tk], pv [B, Tq, H, D])``, ``p`` the un-normalized
    ``exp(scores − m_blk)``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = torch.where(kmask[:, None, None, :] > 0, scores, NEG_INF)
    m_blk = scores.amax(dim=-1)
    p = torch.exp(scores - m_blk[..., None])
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return m_blk, p, pv


def _ring_dense(q, k, v, kmask, axis_name: str, n_dev: int) -> torch.Tensor:
    """The dense inner: one ring pass reducing ``(m, l, o)``."""
    b, t_local, h, d = q.shape
    scale = _rsqrt_f32(d).item()  # float32(1) / sqrt(float32(d)), the reference's scale

    def update(rot, carry):
        k_blk, v_blk, mask_blk = rot
        m, l, o = carry
        m_blk, p, pv = _block_attn(q, k_blk, v_blk, mask_blk, scale)
        m_new = torch.maximum(m, m_blk)
        corr = torch.exp(m - m_new)
        corr_blk = torch.exp(m_blk - m_new)
        l = l * corr + p.sum(dim=-1) * corr_blk
        o = o * corr.permute(0, 2, 1)[..., None] + pv.float() * corr_blk.permute(0, 2, 1)[..., None]
        return m_new, l, o

    dev = q.device
    carry0 = (
        torch.full((b, h, t_local), NEG_INF, dtype=torch.float32, device=dev),
        torch.zeros((b, h, t_local), dtype=torch.float32, device=dev),
        torch.zeros((b, t_local, h, d), dtype=torch.float32, device=dev),
    )
    m, l, o = _ring_protocol(axis_name, n_dev, (k, v, kmask), carry0, update)
    out = (o / torch.clamp(l, min=1e-30).permute(0, 2, 1)[..., None]).to(q.dtype)
    # Dead rows (every key padding) return exactly 0, the flash path's
    # convention; their gradients are exactly 0 through the where.
    dead = (m <= NEG_INF / 2).permute(0, 2, 1)[..., None]  # [B, Tq, H, 1]
    return torch.where(dead, torch.zeros_like(out), out)


def _ring_flash(q, k, v, kmask, axis_name: str, n_dev: int) -> torch.Tensor:
    """The flash inner: B1 with ``return_lse`` once a hop, merged by
    log-sum-exp."""
    from svoc_torch.ops.flash_attention import flash_attention

    b, t_local, h, d = q.shape
    q = q.contiguous()

    def update(rot, carry):
        k_blk, v_blk, mask_blk = rot
        o, lse = carry
        o_b, lse_b = flash_attention(q, k_blk, v_blk, kmask=mask_blk > 0, return_lse=True)
        lse_new = torch.logaddexp(lse, lse_b)
        # Every key so far padding: exp(-inf − -inf) would be NaN.  The
        # double where keeps the untaken branch from forming it.
        dead = torch.isneginf(lse_new)
        d_old = torch.where(dead, 0.0, lse - lse_new)
        d_new = torch.where(dead, 0.0, lse_b - lse_new)
        w_old = torch.where(dead, 0.0, torch.exp(d_old))[..., None]
        w_new = torch.where(dead, 0.0, torch.exp(d_new))[..., None]
        return o * w_old + o_b.float() * w_new, lse_new

    dev = q.device
    carry0 = (
        torch.zeros((b, t_local, h, d), dtype=torch.float32, device=dev),
        torch.full((b, t_local, h), -math.inf, dtype=torch.float32, device=dev),
    )
    o, _lse = _ring_protocol(axis_name, n_dev, (k.contiguous(), v.contiguous(), kmask), carry0, update)
    return o.to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kmask: Optional[torch.Tensor] = None,
    *,
    axis_name: str,
    block_impl: str = "dense",
) -> torch.Tensor:
    """Exact non-causal attention with K/V rotating over ``axis_name``.

    Call inside a shard_map body: every argument is the slot's block,
    ``q, k, v [B, T_local, H, D]`` and ``kmask [B, T_local]`` (1 = real
    key).  Returns the slot's output block ``[B, T_local, H, D]``."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"unknown block_impl {block_impl!r}")
    if kmask is None:
        kmask = torch.ones(k.shape[:2], dtype=torch.int32, device=k.device)
    n_dev = axis_size(axis_name)
    if block_impl == "flash":
        return _ring_flash(q, k, v, kmask, axis_name, n_dev)
    return _ring_dense(q, k, v, kmask, axis_name, n_dev)


def ring_attention_fn(mesh: Mesh, seq_axis: str = "seq", block_impl: str = "dense") -> Callable[..., torch.Tensor]:
    """``(q, k, v, kmask) → out`` with the sequence dimension split over
    ``seq_axis`` (batch and head dimensions replicated); the output is
    assembled on the mesh's first slot's device."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"unknown block_impl {block_impl!r}")
    spec = P(None, seq_axis, None, None)
    mask_spec = P(None, seq_axis)

    def body(q, k, v, kmask):
        return ring_attention(q, k, v, kmask, axis_name=seq_axis, block_impl=block_impl)

    return shard_map(body, mesh=mesh, in_specs=(spec, spec, spec, mask_spec), out_specs=spec)
