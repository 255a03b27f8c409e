"""RoBERTa-style post-LN sentiment encoder as ``nn.Module``s.

Mirrors :mod:`svoc_tpu.models.encoder` (``SelfAttention``,
``EncoderBlock``, ``SentimentEncoder``, ``init_params``,
``param_shardings``).  Submodules
keep the flax names (``block_{i}.attention.query``, ``ln_attn``, …) so
that :func:`svoc_torch.models.from_jax.params_from_flax` maps a flax tree
onto them one to one.  What must match the reference:

- the matmuls run in ``cfg.dtype``; every LayerNorm runs in float32 and
  its result is cast back to ``cfg.dtype``; GELU is the exact erf form;
- positions are ``cumsum(mask)*mask + pad_id`` and the position table
  has ``max_len + pad_id + 1`` rows;
- the head is dense → tanh on the first token, then a float32
  projection to the labels.

``cfg.attention`` picks the attention, as in the reference: ``"dense"``
(the default) is :func:`svoc_torch.ops.dense_attention.dense_attention`
under an additive float32 bias, plain PyTorch as the JAX package leaves
it to XLA; ``"flash"`` is
:func:`svoc_torch.ops.flash_attention.flash_attention`, its CUDA kernel
for CUDA tensors and its plain version for CPU tensors, masked by the
padding keys (``kmask``) or, in the packed encoder, by segments.  Any
other value raises.  ``cfg.remat`` reruns each block's forward inside
the backward (``torch.utils.checkpoint``) when grad is on.  The
projections and the FFN stay ``F.linear``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from svoc_torch.device import resolve_device
from svoc_torch.models.configs import EncoderConfig
from svoc_torch.ops.dense_attention import dense_attention, key_padding_bias
from svoc_torch.ops.flash_attention import flash_attention

ATTENTIONS = ("dense", "flash")


def check_attention(cfg: EncoderConfig) -> None:
    if cfg.attention not in ATTENTIONS:
        raise ValueError(
            f"cfg.attention must be 'dense' or 'flash' (got {cfg.attention!r})"
        )


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``flax.linen.Dense(dtype=dtype)``: input and parameters in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor, eps: float, dtype: torch.dtype):
    """A float32 LayerNorm whose result is cast to ``dtype``."""
    return F.layer_norm(
        x.float(), x.shape[-1:], layer.weight.float(), layer.bias.float(), eps
    ).to(dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.query = nn.Linear(cfg.hidden, cfg.hidden)
        self.key = nn.Linear(cfg.hidden, cfg.hidden)
        self.value = nn.Linear(cfg.hidden, cfg.hidden)
        self.out = nn.Linear(cfg.hidden, cfg.hidden)

    def forward(self, x, bias=None, kmask=None, segments=None):
        """``bias`` (additive float32, broadcast to ``[B, H, T, T]``)
        masks the dense branch; ``kmask`` or ``segments`` the flash one."""
        cfg = self.cfg
        check_attention(cfg)
        b, t, _ = x.shape
        h, d = cfg.n_heads, cfg.head_dim
        q = dense(self.query, x, cfg.dtype).view(b, t, h, d)
        k = dense(self.key, x, cfg.dtype).view(b, t, h, d)
        v = dense(self.value, x, cfg.dtype).view(b, t, h, d)
        if cfg.attention == "flash":
            ctx = flash_attention(q, k, v, kmask=kmask, segment_ids=segments)
        else:
            ctx = dense_attention(q, k, v, bias, cfg.dtype)
        return dense(self.out, ctx.reshape(b, t, cfg.hidden), cfg.dtype)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = SelfAttention(cfg)
        self.ln_attn = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)
        self.ffn_in = nn.Linear(cfg.hidden, cfg.intermediate)
        self.ffn_out = nn.Linear(cfg.intermediate, cfg.hidden)
        self.ln_ffn = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)

    def forward(self, x, bias=None, kmask=None, segments=None):
        cfg = self.cfg
        a = self.attention(x, bias, kmask, segments)
        x = layer_norm(self.ln_attn, x + a, cfg.ln_eps, cfg.dtype)
        f = F.gelu(dense(self.ffn_in, x, cfg.dtype), approximate="none")
        f = dense(self.ffn_out, f, cfg.dtype)
        return layer_norm(self.ln_ffn, x + f, cfg.ln_eps, cfg.dtype)


class SentimentEncoder(nn.Module):
    """Token ids + attention mask → classification logits ``[B, n_labels]``."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.pos_emb = nn.Embedding(cfg.max_len + cfg.pad_id + 1, cfg.hidden)
        self.ln_emb = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", EncoderBlock(cfg))
        self.head_dense = nn.Linear(cfg.hidden, cfg.hidden)
        self.head_out = nn.Linear(cfg.hidden, cfg.n_labels)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layers)]

    def embed(self, ids, pos_ids):
        cfg = self.cfg
        x = self.tok_emb(ids).to(cfg.dtype) + self.pos_emb(pos_ids).to(cfg.dtype)
        return layer_norm(self.ln_emb, x, cfg.ln_eps, cfg.dtype)

    def head(self, cls):
        cls = torch.tanh(dense(self.head_dense, cls, self.cfg.dtype))
        return dense(self.head_out, cls, torch.float32)

    def encode(self, x, bias=None, kmask=None, segments=None):
        """The blocks in order, each rematerialized when ``cfg.remat``
        and grad is on."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        for block in self.blocks():
            if remat:
                x = checkpoint(block, x, bias, kmask, segments, use_reentrant=False)
            else:
                x = block(x, bias, kmask, segments)
        return x

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        check_attention(cfg)
        pos_ids = torch.cumsum(mask, dim=-1) * mask + cfg.pad_id
        x = self.embed(ids, pos_ids)
        if cfg.attention == "flash":
            x = self.encode(x, kmask=mask > 0)
        else:
            x = self.encode(x, bias=key_padding_bias(mask))
        return self.head(x[:, 0, :])


class _SkipInit(torch.overrides.TorchFunctionMode):
    """Skips ``torch.nn.init``'s initialisers.  A module built on the meta
    device only for its names and shapes needs none, and their meta
    versions import ``torch._dynamo`` the first time a process runs one
    (seconds)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__module__", None) == "torch.nn.init":
            return args[0] if args else kwargs["tensor"]
        return func(*args, **(kwargs or {}))


def meta_module(cls, cfg: EncoderConfig) -> nn.Module:
    """``cls(cfg)`` on the meta device, its tensors left uninitialised."""
    with torch.device("meta"), _SkipInit():
        return cls(cfg)


def init_params(
    cfg: EncoderConfig,
    seed: int = 0,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """A seeded random state dict for :class:`SentimentEncoder` (and the
    packed twin, which shares it), drawn on ``device`` from a
    ``torch.Generator``.  The scales are those of the flax initialisers
    (Dense: normal with variance 1/fan_in, zero bias; Embed: normal with
    variance 1/features, flax's ``variance_scaling(1, "fan_in",
    "normal", out_axis=0)`` on a ``[rows, features]`` table; LayerNorm: 1
    and 0); the numbers are not flax's."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes = meta_module(SentimentEncoder, cfg)
    params = {}
    for name, module in shapes.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, nn.Linear):
            std = 1.0 / math.sqrt(module.in_features)
            params[prefix + "weight"] = _normal(module.weight.shape, std, gen, device)
            params[prefix + "bias"] = torch.zeros(module.out_features, device=device)
        elif isinstance(module, nn.Embedding):
            std = 1.0 / math.sqrt(module.embedding_dim)
            params[prefix + "weight"] = _normal(module.weight.shape, std, gen, device)
        elif isinstance(module, nn.LayerNorm):
            params[prefix + "weight"] = torch.ones(cfg.hidden, device=device)
            params[prefix + "bias"] = torch.zeros(cfg.hidden, device=device)
    return {k: v.to(dtype) for k, v in params.items()}


#: The Megatron layout (``encoder.py:142-171``): these projections split
#: their output features over the model axis, the row-split ones their
#: input features.
COLUMN_SPLIT = ("ffn_in", "query", "key", "value")
ROW_SPLIT = ("ffn_out", "attention.out")


def param_shardings(params: Dict[str, torch.Tensor], mesh, model_axis: str = "model") -> Dict:
    """A :class:`~svoc_torch.parallel.mesh.NamedSharding` for each tensor
    of the port's state dict: tensor parallelism over ``model_axis``,
    the reference's Megatron layout.  A ``Linear`` weight is ``[out,
    in]`` here, the transpose of flax's ``[in, out]`` kernel, so the
    ``query``, ``key``, ``value`` and ``ffn_in`` weights split dimension
    0 (flax's column) and ``ffn_out`` and ``attention.out`` dimension 1
    (flax's row); every other tensor (biases, LayerNorms, embeddings, the
    head) is replicated, as the reference matches only 2-D kernels."""
    from svoc_torch.parallel.mesh import NamedSharding, P

    def spec_for(name: str, leaf: torch.Tensor) -> P:
        if leaf.dim() == 2 and name.endswith(".weight"):
            if any(k in name for k in COLUMN_SPLIT):
                return P(model_axis, None)
            if any(k in name for k in ROW_SPLIT):
                return P(None, model_axis)
        return P()

    return {name: NamedSharding(mesh, spec_for(name, leaf)) for name, leaf in params.items()}


def _normal(shape, std, gen, device):
    return torch.randn(shape, generator=gen, device=device) * std


def load_encoder(cls, cfg: EncoderConfig, params: Dict[str, torch.Tensor]):
    """``cls(cfg)`` holding ``params`` as its tensors (no copy, no
    default init), in eval mode."""
    model = meta_module(cls, cfg)
    model.load_state_dict(params, assign=True)
    return model.eval()
