"""Sequence-parallel encoder forward: the whole model on sequence shards.

Mirrors :mod:`svoc_tpu.parallel.sp_encoder` (``_global_position_ids``
:42, ``_block`` :58, ``sequence_parallel_forward_fn`` :72).  The
activations are split over a ``"seq"`` mesh axis for the entire
forward (embeddings, every encoder block and the head), so a slot holds
``T / n`` tokens of each row.  Its collectives, all across the slots of
:func:`svoc_torch.parallel.sharded.shard_map`:

- one ``all_gather`` of each shard's count of real tokens, for the
  global RoBERTa position ids (a real token's position counts the real
  tokens before it on every shard);
- the K/V rotations of :func:`svoc_torch.parallel.ring_attention.
  ring_attention` inside each block (``cfg.attention`` picks the per-hop
  block: ``"flash"`` launches B1 once a hop);
- one ``psum`` that delivers the CLS vector (global token 0, on shard 0)
  to every slot's replicated head.

The blocks are :func:`svoc_torch.parallel.encoder_math.encoder_block`
with the ring as its ``attention_fn``; the parameters are the port's
state dict (``SentimentEncoder.state_dict()`` or ``params_from_flax``),
replicated.  Differentiable with the dense inner (autograd through the
rotation, :mod:`svoc_torch.parallel.ring_attention`); the flash inner is
inference only, as in the reference.  Blocks are never rematerialized
here: a recomputed forward would run its collectives outside the
runner's lockstep.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from svoc_torch.models.configs import EncoderConfig
from svoc_torch.parallel.encoder_math import cls_head, embed_tokens, encoder_block, param_tree
from svoc_torch.parallel.mesh import Mesh, P
from svoc_torch.parallel.ring_attention import ring_attention
from svoc_torch.parallel.sharded import all_gather, axis_index, psum, shard_map, to_slot


def _global_position_ids(mask_local: torch.Tensor, cfg: EncoderConfig, axis: str) -> torch.Tensor:
    """RoBERTa position ids across sequence shards: a real token's
    position is its global count of real tokens so far + ``pad_id``
    (``cumsum(mask) * mask + pad_id`` over the whole row)."""
    ax = axis_index(axis)
    all_counts = all_gather(mask_local.sum(dim=1)[None], axis)  # [n, B]
    prefix = all_counts[:ax].sum(dim=0)  # [B] real tokens before this shard
    local_cumsum = torch.cumsum(mask_local, dim=-1)
    return (prefix[:, None] + local_cumsum) * mask_local + cfg.pad_id


def _block(x, mask_local, bp: Mapping, cfg: EncoderConfig, axis: str):
    """One encoder block on sequence shards: the shared block math with
    the ring as its attention."""

    def ring(q, k, v, kmask):
        return ring_attention(q, k, v, kmask, axis_name=axis, block_impl=cfg.attention)

    return encoder_block(x, mask_local, bp, cfg, attention_fn=ring)


def sequence_parallel_forward_fn(mesh: Mesh, cfg: EncoderConfig, seq_axis: str = "seq") -> Callable:
    """``(params, ids [B, T], mask [B, T]) → logits [B, n_labels]`` with
    ``T`` split over ``seq_axis`` (``T`` must divide by its size);
    ``params`` is the port's state dict, replicated, and the logits come
    back on the mesh's first slot's device."""

    def body(params, ids_local, mask_local):
        p = param_tree(to_slot(params))
        pos_ids = _global_position_ids(mask_local, cfg, seq_axis)
        x = embed_tokens(ids_local, pos_ids, p, cfg)
        for i in range(cfg.n_layers):
            x = _block(x, mask_local, p[f"block_{i}"], cfg, seq_axis)
        # CLS pooling: global token 0 lives on shard 0; the psum hands it
        # to every slot's head.
        cls_local = x[:, 0, :] if axis_index(seq_axis) == 0 else torch.zeros_like(x[:, 0, :])
        cls = psum(cls_local, seq_axis)
        return cls_head(cls.to(cfg.dtype), p, cfg)

    return shard_map(body, mesh=mesh, in_specs=(P(), P(None, seq_axis), P(None, seq_axis)), out_specs=P())
