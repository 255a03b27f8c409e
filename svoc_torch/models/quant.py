"""W8A8 dynamic post-training quantization of the sentiment encoder.

Mirrors :mod:`svoc_tpu.models.quant` (``quant.py:57-227``):
:func:`quantize_dense`, :func:`quantize_params`, :func:`is_quantized_tree`,
:func:`quantized_size_bytes`, :func:`_quantize_rows`, :func:`qdense`,
:func:`make_cached_qdense`, :func:`_bias_attention`,
:func:`quantized_forward` and :func:`quantized_packed_forward`, and the
two modules :func:`svoc_torch.models.forward.resolve_forward` returns for
``quant="int8"``.

The six matmuls of each block (query, key, value, out, ffn_in, ffn_out)
run int8 × int8 → int32; embeddings, LayerNorms, softmax, residuals and
the head stay in ``cfg.dtype``/float32.  The scheme is the reference's,
symmetric and with no zero point:

- weights: per output channel, ``scale[o] = max(amax|W[o, :]|, 1e-8) /
  127``, folded once (:func:`quantize_params`);
- activations: per row, dynamic, the same rule over the row;
- accumulation in int32, then ``acc.float() * (s * w_scale) + bias``
  cast to ``cfg.dtype``.

``x / s`` is a division, as the reference's is (not a product with a
reciprocal), and ``torch.round`` rounds half to even as ``jnp.round``
does, so on the same float32 inputs the int8 tensors and the int32 sums
equal the reference's.  The epilogue may differ by one float32 ulp
where XLA contracts it into a fused multiply-add.

The reference computes the int8 product with XLA's int8 dot and has no
Pallas kernel here, so the product stays a library call:
``torch._int_mm``.  Each int8 weight is stored ``[O, I]`` row-major
(``Linear.weight``'s layout), and ``w_int8.t()`` is the column-major
``[I, O]`` operand that ``torch._int_mm`` takes without a copy.  On
CUDA ``torch._int_mm`` needs more than 16 rows and inner and outer
widths that are multiples of 8; another shape raises with the shape in
the message.  The quantized tree keeps the port's flat state-dict names,
with ``<dense>.weight`` replaced by ``<dense>.w_int8`` and
``<dense>.w_scale``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from svoc_torch.models.configs import EncoderConfig
from svoc_torch.ops.dense_attention import block_diagonal_bias, dense_attention
from svoc_torch.parallel.encoder_math import (
    cls_head,
    embed_tokens,
    encoder_block,
    local_position_ids,
    param_tree,
)

#: Kernels quantized inside each encoder block.
_BLOCK_DENSES = ("query", "key", "value", "out", "ffn_in", "ffn_out")


def _dense_prefix(i: int, name: str) -> str:
    return f"block_{i}.attention.{name}." if name in ("query", "key", "value", "out") else f"block_{i}.{name}."


def quantize_dense(p: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{weight [O, I], bias [O]}`` → ``{w_int8 [O, I], w_scale [O],
    bias [O]}`` with per-output-channel symmetric scales."""
    w = p["weight"].float()
    scale = torch.clamp_min(w.abs().amax(dim=1), 1e-8) / 127.0
    w_int8 = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return {"w_int8": w_int8.contiguous(), "w_scale": scale, "bias": p["bias"].float()}


def quantize_params(params: Mapping[str, torch.Tensor], cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """Float state dict → quantized state dict: every block dense becomes
    an int8 triple, every other tensor is kept as it is."""
    out = dict(params)
    for i in range(cfg.n_layers):
        for name in _BLOCK_DENSES:
            prefix = _dense_prefix(i, name)
            q = quantize_dense({"weight": out.pop(prefix + "weight"), "bias": out.pop(prefix + "bias")})
            for leaf, tensor in q.items():
                out[prefix + leaf] = tensor
    return out


def is_quantized_tree(params: Mapping) -> bool:
    """Whether ``params`` is already a :func:`quantize_params` output (a
    state dict with any ``.w_int8`` tensor)."""
    return any(name == "w_int8" or name.endswith(".w_int8") for name in params)


def quantized_size_bytes(qparams: Mapping[str, torch.Tensor]) -> int:
    """Bytes of the quantized state dict (int8 kernels, float32 scales
    and biases, the rest as stored)."""
    return sum(t.numel() * t.element_size() for t in qparams.values())


def _quantize_rows(x: torch.Tensor):
    """Per-row dynamic int8 quantization: ``x → (xq int8, s float32)``."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return xq, s


def int8_matmul(xq: torch.Tensor, w_int8: torch.Tensor) -> torch.Tensor:
    """``xq [..., I]`` int8 times ``w_int8 [O, I]`` int8 → ``[..., O]``
    int32 through ``torch._int_mm`` (the weight as its column-major
    transpose, no copy)."""
    lead = xq.shape[:-1]
    a = xq.reshape(-1, xq.shape[-1])
    if a.is_cuda:
        m, k = a.shape
        n = w_int8.shape[0]
        if m <= 16 or k % 8 or n % 8:
            raise ValueError(
                f"torch._int_mm on CUDA needs more than 16 rows and widths that are "
                f"multiples of 8: got [{m}, {k}] x [{k}, {n}]"
            )
    return torch._int_mm(a.contiguous(), w_int8.t()).reshape(*lead, w_int8.shape[0])


def _epilogue(acc: torch.Tensor, s: torch.Tensor, qp: Mapping, dtype) -> torch.Tensor:
    return (acc.float() * (s * qp["w_scale"]) + qp["bias"]).to(dtype)


def qdense(x: torch.Tensor, qp: Mapping, dtype: torch.dtype) -> torch.Tensor:
    """The dynamically quantized replacement for
    :func:`svoc_torch.parallel.encoder_math.dense` (same ``(x, params,
    dtype)`` signature, so ``encoder_block`` takes it as ``dense_fn``)."""
    xq, s = _quantize_rows(x)
    return _epilogue(int8_matmul(xq, qp["w_int8"]), s, qp, dtype)


def make_cached_qdense():
    """A :func:`qdense` that quantizes each distinct activation tensor
    once: Q, K and V of a block share one quantization of their input
    (``quant.py:142-177``).  The cache keys on the tensor's identity and
    keeps a reference to it, so a freed tensor's id never aliases a new
    one; make one per forward call."""
    cache: Dict = {}

    def cached_qdense(x: torch.Tensor, qp: Mapping, dtype: torch.dtype) -> torch.Tensor:
        hit = cache.get(id(x))
        if hit is not None and hit[0] is x:
            _, xq, s = hit
        else:
            xq, s = _quantize_rows(x)
            cache[id(x)] = (x, xq, s)
        return _epilogue(int8_matmul(xq, qp["w_int8"]), s, qp, dtype)

    return cached_qdense


def _bias_attention(bias: torch.Tensor, cfg: EncoderConfig):
    """``attention_fn`` with a precomputed additive float32 bias (the
    packed block-diagonal case): the dense chain of
    :func:`~svoc_torch.parallel.encoder_math.local_attention`."""

    def attn(q, k, v, _kmask):
        return dense_attention(q, k, v, bias, cfg.dtype)

    return attn


def quantized_forward(qparams: Mapping, ids: torch.Tensor, mask: torch.Tensor,
                      cfg: EncoderConfig) -> torch.Tensor:
    """Unpacked ``(ids, mask) → logits`` with int8 block matmuls, on a
    quantized state dict."""
    rest = param_tree(qparams)
    qd = make_cached_qdense()  # one per forward: Q/K/V share one quantization
    x = embed_tokens(ids, local_position_ids(mask, cfg), rest, cfg)
    for i in range(cfg.n_layers):
        x = encoder_block(x, mask, rest[f"block_{i}"], cfg, dense_fn=qd)
    return cls_head(x[:, 0, :], rest, cfg)


def quantized_packed_forward(qparams: Mapping, ids: torch.Tensor, pos_ids: torch.Tensor,
                             seg: torch.Tensor, cls_pos: torch.Tensor,
                             cfg: EncoderConfig) -> torch.Tensor:
    """The sequence-packed twin (block-diagonal attention, a CLS gather
    a segment) with int8 matmuls: ``[R, S, n_labels]`` logits."""
    rest = param_tree(qparams)
    qd = make_cached_qdense()
    x = embed_tokens(ids, pos_ids, rest, cfg)
    attn = _bias_attention(block_diagonal_bias(seg), cfg)
    for i in range(cfg.n_layers):
        x = encoder_block(x, None, rest[f"block_{i}"], cfg, attention_fn=attn, dense_fn=qd)
    index = cls_pos.long()[:, :, None].expand(-1, -1, cfg.hidden)
    return cls_head(torch.gather(x, 1, index), rest, cfg)


class QuantizedSentimentEncoder(nn.Module):
    """``(ids, mask) → logits`` over a quantized state dict
    (:func:`quantize_params`' output): the module
    :func:`~svoc_torch.models.forward.resolve_forward` gives for
    ``quant="int8"``."""

    def __init__(self, cfg: EncoderConfig, qparams: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.qparams = dict(qparams)

    def forward(self, ids, mask):
        return quantized_forward(self.qparams, ids, mask, self.cfg)


class QuantizedPackedSentimentEncoder(QuantizedSentimentEncoder):
    """``(ids, pos_ids, seg, cls_pos) → logits [R, S, n_labels]`` over a
    quantized state dict."""

    def forward(self, ids, pos_ids, seg, cls_pos):  # type: ignore[override]
        return quantized_packed_forward(self.qparams, ids, pos_ids, seg, cls_pos, self.cfg)
