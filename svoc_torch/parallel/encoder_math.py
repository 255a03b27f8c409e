"""Functional encoder math on raw parameter trees.

Mirrors :mod:`svoc_tpu.parallel.encoder_math` (``encoder_math.py:21-113``):
:func:`dense`, :func:`layernorm`, :func:`embed_tokens`,
:func:`local_position_ids`, :func:`cls_head`, :func:`local_attention` and
:func:`encoder_block` with ``dense_fn=`` and ``attention_fn=``.  The
W8A8 forward (:mod:`svoc_torch.models.quant`) runs the block through
here with its quantized matmul, the sequence-parallel encoder
(:mod:`~svoc_torch.parallel.sp_encoder`) with the ring as its attention,
the pipeline (:mod:`~svoc_torch.parallel.pipeline`) as it is, and the
tensor-parallel train step (:mod:`svoc_torch.train.trainer`) on a model
shard's heads, so that the block's wiring is written once.  The head
count comes from the query projection's width, so a block whose
projections hold some of the heads runs those.  With ``dense_fn`` left
at its default, the blocks equal
:class:`svoc_torch.models.encoder.SentimentEncoder`'s exactly at float32.

The parameters are the port's own names, as a nested dict
(:func:`param_tree` of a state dict): a dense is ``{"weight" [O, I],
"bias" [O]}``, a LayerNorm ``{"weight", "bias"}``, an embedding
``{"weight"}``, under ``block_{i}.attention.query`` and the rest of the
module names.  The dtypes are the module's: matmuls in ``cfg.dtype``,
LayerNorm and softmax in float32.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from svoc_torch.models.configs import EncoderConfig
from svoc_torch.ops.dense_attention import dense_attention, key_padding_bias


def param_tree(state: Mapping[str, torch.Tensor]) -> Dict:
    """A flat state dict (``block_0.attention.query.weight``) → the
    nested dict the functions below index."""
    tree: Dict = {}
    for name, tensor in state.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = tensor
    return tree


def dense(x: torch.Tensor, p: Mapping, dtype: torch.dtype) -> torch.Tensor:
    """``nn.Dense(dtype=dtype)``: input, weight and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), p["weight"].to(dtype), p["bias"].to(dtype))


def layernorm(x: torch.Tensor, p: Mapping, eps: float) -> torch.Tensor:
    """``nn.LayerNorm(dtype=float32)``: float32 statistics and result."""
    return F.layer_norm(x.float(), x.shape[-1:], p["weight"].float(), p["bias"].float(), eps)


def embed_tokens(ids, pos_ids, rest: Mapping, cfg: EncoderConfig) -> torch.Tensor:
    """Token + position embedding + the embedding LayerNorm
    (``encoder.py:82-95``).  The rows are cast to ``cfg.dtype`` before
    the add, as ``nn.Embed(dtype=cfg.dtype)`` gathers them."""
    tok = F.embedding(ids, rest["tok_emb"]["weight"]).to(cfg.dtype)
    pos = F.embedding(pos_ids, rest["pos_emb"]["weight"]).to(cfg.dtype)
    return layernorm(tok + pos, rest["ln_emb"], cfg.ln_eps).to(cfg.dtype)


def local_position_ids(mask: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """RoBERTa position ids of one unsharded block (``encoder.py:87``)."""
    return torch.cumsum(mask, dim=-1) * mask + cfg.pad_id


def cls_head(cls_vec: torch.Tensor, rest: Mapping, cfg: EncoderConfig) -> torch.Tensor:
    """The first-token head (``encoder.py:105-107``): dense → tanh in
    ``cfg.dtype``, then a float32 projection to the labels."""
    cls = torch.tanh(dense(cls_vec, rest["head_dense"], cfg.dtype))
    return dense(cls.float(), rest["head_out"], torch.float32)


def local_attention(q, k, v, kmask, cfg: EncoderConfig) -> torch.Tensor:
    """Attention over whole sequences, as ``cfg.attention`` says
    (``encoder.py:46-60``): the dense chain under the key-padding bias,
    or the flash kernel masked by the padding keys."""
    if cfg.attention == "flash":
        from svoc_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, kmask=kmask > 0)
    return dense_attention(q, k, v, key_padding_bias(kmask), cfg.dtype)


def encoder_block(x, kmask, bp: Mapping, cfg: EncoderConfig, attention_fn=None, *,
                  dense_fn=None) -> torch.Tensor:
    """One :class:`~svoc_torch.models.encoder.EncoderBlock` from a raw
    parameter dict.  ``attention_fn(q, k, v, kmask) → ctx`` defaults to
    :func:`local_attention`; ``dense_fn(x, p, dtype)`` defaults to
    :func:`dense` (the int8 forward passes its quantized matmul)."""
    if dense_fn is None:
        dense_fn = dense
    b, t, _ = x.shape
    d = cfg.head_dim
    ap = bp["attention"]
    q = dense_fn(x, ap["query"], cfg.dtype).reshape(b, t, -1, d)
    k = dense_fn(x, ap["key"], cfg.dtype).reshape(b, t, -1, d)
    v = dense_fn(x, ap["value"], cfg.dtype).reshape(b, t, -1, d)
    if attention_fn is None:
        ctx = local_attention(q, k, v, kmask, cfg)
    else:
        ctx = attention_fn(q, k, v, kmask)
    a = dense_fn(ctx.reshape(b, t, -1), ap["out"], cfg.dtype)
    x = layernorm(x + a, bp["ln_attn"], cfg.ln_eps).to(cfg.dtype)
    f = F.gelu(dense_fn(x, bp["ffn_in"], cfg.dtype), approximate="none")
    f = dense_fn(f, bp["ffn_out"], cfg.dtype)
    return layernorm(x + f, bp["ln_ffn"], cfg.ln_eps).to(cfg.dtype)
