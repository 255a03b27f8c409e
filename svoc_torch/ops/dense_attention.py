"""Dense (monolithic-softmax) attention in plain PyTorch.

Mirrors the two dense forms of the JAX package, neither of which is a
kernel there (both are einsum chains left to the compiler), so neither
is one here:

- :func:`dense_attention` is the encoder's dense branch
  (``svoc_tpu/models/encoder.py:65-70``): the ``cfg.attention ==
  "dense"`` path of :class:`svoc_torch.models.encoder.SelfAttention`,
  packed (a block-diagonal bias) and unpacked (a key-padding bias).
- :func:`dense_attention_reference` is the equivalence reference
  (``svoc_tpu/parallel/ring_attention.py:300-309``) that the probes hold
  the flash kernels against.

The two round at different places and mask differently; they stay apart:

=====================  ==========================  =========================
                       ``dense_attention``         ``..._reference``
=====================  ==========================  =========================
scale                  a ``dtype`` scalar times    float32, after the cast
                       the ``dtype`` scores        of the scores to float32
mask                   an **additive** float32     a select of ``NEG_INF``
                       bias (0 kept, -1e9 masked)  (-1e30) on masked keys
probabilities          cast to ``dtype``           cast to v's dtype
=====================  ==========================  =========================

With the additive bias a query that sees no key (the padding queries of
a packed row) has all scores equal and averages v uniformly; such rows
are never gathered.  A select of ``-inf`` would give NaN there and the
flash rule gives 0: neither is the reference's dense result.
"""

from __future__ import annotations

import torch

#: The reference's finite "minus infinity" (``ring_attention.py:33``).
NEG_INF = -1e30

#: The additive bias of a masked key (``encoder.py:122``, ``packing.py:274``).
MASKED_BIAS = -1e9


def _rsqrt_f32(d: int) -> torch.Tensor:
    """``1 / sqrt(d)`` computed in float32, as ``1.0 / jnp.sqrt(d)`` is."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    dtype: torch.dtype,
) -> torch.Tensor:
    """``q, k, v [B, T, H, D]`` in ``dtype`` and an additive float32
    ``bias`` that broadcasts to ``[B, H, T, T]`` → ``[B, T, H, D]``."""
    # The scale is rounded to `dtype` first, then multiplies the `dtype`
    # scores (one rounding of an exact product), as the reference does.
    scale = _rsqrt_f32(q.shape[-1]).to(dtype).item()
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = scores.float() + bias  # float32 softmax
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def key_padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """``mask [B, T]`` (> 0 = real key) → the ``[B, 1, 1, T]`` bias."""
    return _bias(mask[:, None, None, :] > 0)


def block_diagonal_bias(seg: torch.Tensor) -> torch.Tensor:
    """``seg [R, T]`` (0 = padding) → the ``[R, 1, T, T]`` bias: query q
    sees key k iff both lie in the same real segment."""
    same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    return _bias(same[:, None, :, :])


def _bias(keep: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=keep.device)
    return torch.where(keep, zero, MASKED_BIAS)


def dense_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kmask: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Monolithic-softmax attention over ``[B, T, H, D]`` with an
    optional per-key mask ``[B, T]`` (> 0 = real key)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * _rsqrt_f32(q.shape[-1]).item()
    if kmask is not None:
        scores = torch.where(kmask[:, None, None, :] > 0, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
