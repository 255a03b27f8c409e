"""Pipeline parallelism: the encoder's layers split over a ``stage`` axis.

Mirrors :mod:`svoc_tpu.parallel.pipeline` (``stack_block_params`` :50,
``pipeline_forward_fn`` :62).  The layer stack is split into ``S``
contiguous stages, one a slot along ``stage``, and ``M`` microbatches
flow through them GPipe-style: at step ``t`` stage ``s`` runs
microbatch ``t − s``, activations and their padding masks hop to the
next stage by :func:`svoc_torch.parallel.sharded.ppermute`, and the
schedule drains in ``S + M − 1`` steps.  The block parameters are
stacked on a leading ``[n_layers]`` axis split ``P(stage)``, so a slot
holds only its stage's layers; the last stage's logits reach every
slot by ``psum``.  A ``data`` axis in the mesh splits the batch, each
data index running a pipeline of its own.

**Where the port departs: it skips the bubbles.**  The reference is one
SPMD program, so every stage computes at every step, embedding and
head included, and ``where`` masks out the steps it has no microbatch
for (the ``(S − 1) / (S + M − 1)`` bubble).  Here each slot runs its own
Python, so a stage computes only at the ``M`` steps it has a
microbatch, and only stage 0 embeds and only the last stage runs the
head.  An idle stage still takes part in every step's ``ppermute`` (the
collective needs every slot of the group), passing what it last held:
the next stage is idle one step later, so nothing idle is ever read.
So under ``cfg.attention == "flash"`` a forward launches B1 ``M ×
n_layers`` times a data index (each stage ``M × n_layers / S``), not the
``(S + M − 1) × n_layers`` of the reference's schedule.  The logits are
the same function.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from svoc_torch.models.configs import EncoderConfig
from svoc_torch.parallel.encoder_math import cls_head, embed_tokens, encoder_block, local_position_ids, param_tree
from svoc_torch.parallel.mesh import Mesh, P
from svoc_torch.parallel.sharded import axis_index, ppermute, psum, shard_map, to_slot


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def stack_block_params(params: Mapping[str, torch.Tensor], cfg: EncoderConfig) -> Tuple[Dict, Dict]:
    """The port's state dict → ``(stacked_blocks, rest)``: every block
    leaf gains a leading ``[n_layers]`` axis (the axis ``stage``
    splits), ``rest`` holds the embeddings and the head, as nested
    dicts of :func:`svoc_torch.parallel.encoder_math.param_tree`."""
    tree = param_tree(params)
    stacked = _stack([tree[f"block_{i}"] for i in range(cfg.n_layers)])
    rest = {k: v for k, v in tree.items() if not k.startswith("block_")}
    return stacked, rest


def pipeline_forward_fn(
    mesh: Mesh,
    cfg: EncoderConfig,
    n_microbatches: int,
    stage_axis: str = "stage",
    data_axis: Optional[str] = None,
) -> Callable:
    """``(params, ids [B, T], mask [B, T]) → logits [B, n_labels]`` with
    the layers pipelined over ``stage_axis``; ``params`` is the port's
    state dict (the stage split happens inside, by
    :func:`stack_block_params`).  ``B`` must divide by ``n_microbatches``
    (times the ``data_axis`` size when one splits the batch)."""
    n_stages = mesh.shape[stage_axis]
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by {n_stages} stages")
    layers_per_stage = cfg.n_layers // n_stages
    m = n_microbatches
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def body(stacked_local, rest, ids, mask):
        s = axis_index(stage_axis)
        rest = to_slot(rest)
        b, t = ids.shape
        if b % m:
            raise ValueError(f"local batch {b} not divisible by {m} microbatches")
        mb = b // m
        ids_m, mask_m = ids.reshape(m, mb, t), mask.reshape(m, mb, t)
        act = torch.zeros((mb, t, cfg.hidden), dtype=cfg.dtype, device=ids.device)
        act_mask = torch.zeros((mb, t), dtype=mask.dtype, device=ids.device)
        outs = []
        for step in range(n_stages + m - 1):
            # Activations and their padding masks hop one stage forward.
            act_in, mask_in = ppermute((act, act_mask), stage_axis, perm)
            micro = step - s
            if not 0 <= micro < m:
                continue  # a bubble: this stage has no microbatch at this step
            if s == 0:
                xm = mask_m[micro]
                x = embed_tokens(ids_m[micro], local_position_ids(xm, cfg), rest, cfg)
            else:
                x, xm = act_in, mask_in
            for i in range(layers_per_stage):
                x = encoder_block(x, xm, _index(stacked_local, i), cfg)
            act, act_mask = x, xm
            if s == n_stages - 1:
                outs.append(cls_head(x[:, 0, :].to(cfg.dtype), rest, cfg))
        logits = torch.cat(outs) if s == n_stages - 1 else torch.zeros(
            (b, cfg.n_labels), dtype=torch.float32, device=ids.device)
        # Only the last stage holds the logits: the psum hands them to all.
        return psum(logits, stage_axis)

    batch_spec = P(data_axis, None) if data_axis else P(None, None)
    mapped = shard_map(body, mesh=mesh, in_specs=(P(stage_axis), P(), batch_spec, batch_spec), out_specs=batch_spec)

    def forward(params, ids, mask):
        stacked, rest = stack_block_params(params, cfg)
        return mapped(stacked, rest, ids, mask)

    return forward
