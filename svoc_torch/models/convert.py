"""HF RoBERTa checkpoint → :class:`svoc_torch.models.encoder.SentimentEncoder` state dict.

Mirrors :mod:`svoc_tpu.models.convert` (``convert.py:1-222``).  The
reference's classifier is the HF torch model
``SamLowe/roberta-base-go_emotions``; this converter maps a
``RobertaForSequenceClassification`` state dict onto the port's encoder,
whose submodules carry the flax names, with the reference's
correspondences (``convert.py:10-27``):

- ``embeddings.word_embeddings``            → ``tok_emb``
- ``embeddings.position_embeddings``        → ``pos_emb`` (the same
  cumsum-past-pad positions, a table of ``max_len + pad + 1`` rows)
- ``embeddings.token_type_embeddings[0]``   → folded into ``pos_emb``
  (RoBERTa adds its one token type to every position)
- ``encoder.layer.i.attention.self.q/k/v``  → ``block_i.attention.{query,key,value}``
- ``attention.output.dense``                → ``block_i.attention.out``
- ``attention.output.LayerNorm``            → ``block_i.ln_attn``
- ``intermediate.dense`` / ``output.dense`` → ``block_i.ffn_in`` / ``ffn_out``
- ``output.LayerNorm``                      → ``block_i.ln_ffn``
- ``classifier.dense`` / ``out_proj``       → ``head_dense`` / ``head_out``

A torch ``Linear`` keeps its ``[out, in]`` weight here (the reference
transposes to flax's ``[in, out]``).  :func:`load_hf_checkpoint` reads a
local directory only (``config.json`` and ``pytorch_model.bin`` through
``torch.load``): it imports no ``transformers`` and fetches nothing.
:func:`save_params` and :func:`load_params` keep the reference's ``.npz``
layout (``convert.py:154-184``: keys are ``/``-joined flax tree paths),
so either package reads the other's file; a loaded tree becomes a state
dict through :func:`svoc_torch.models.from_jax.params_from_flax`
(``params_from_flax(load_params(path))``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from svoc_torch.models.configs import EncoderConfig
from svoc_torch.models.encoder import SentimentEncoder, load_encoder


def _get(cfg, name: str):
    return cfg[name] if isinstance(cfg, Mapping) else getattr(cfg, name)


def config_from_hf(hf_config, head: str = "sigmoid") -> EncoderConfig:
    """An :class:`EncoderConfig` from a HF ``RobertaConfig``, given as a
    mapping (``config.json``) or an object with the same attributes."""
    return EncoderConfig(
        vocab_size=_get(hf_config, "vocab_size"),
        hidden=_get(hf_config, "hidden_size"),
        n_layers=_get(hf_config, "num_hidden_layers"),
        n_heads=_get(hf_config, "num_attention_heads"),
        intermediate=_get(hf_config, "intermediate_size"),
        max_len=_get(hf_config, "max_position_embeddings") - _get(hf_config, "pad_token_id") - 1,
        n_labels=_n_labels(hf_config),
        pad_id=_get(hf_config, "pad_token_id"),
        ln_eps=_get(hf_config, "layer_norm_eps"),
        head=head,
    )


def _n_labels(hf_config) -> int:
    """``num_labels``: an attribute of a config object; in ``config.json``
    the length of ``id2label``, as ``transformers`` derives it."""
    if not isinstance(hf_config, Mapping):
        return hf_config.num_labels
    if "num_labels" in hf_config:
        return hf_config["num_labels"]
    return len(hf_config["id2label"])


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).clone()


def convert_roberta_state_dict(state_dict: Mapping[str, Any], cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """Torch ``RobertaForSequenceClassification`` state dict → the state
    dict of ``SentimentEncoder(cfg)`` (float32, on the CPU)."""
    sd = {k: _f32(v) for k, v in state_dict.items()}
    pre = "roberta."
    out: Dict[str, torch.Tensor] = {
        "tok_emb.weight": sd[pre + "embeddings.word_embeddings.weight"],
        # Token type 0 is added to every position alike: fold it in.
        "pos_emb.weight": sd[pre + "embeddings.position_embeddings.weight"]
        + sd[pre + "embeddings.token_type_embeddings.weight"][0][None, :],
        "ln_emb.weight": sd[pre + "embeddings.LayerNorm.weight"],
        "ln_emb.bias": sd[pre + "embeddings.LayerNorm.bias"],
        "head_dense.weight": sd["classifier.dense.weight"],
        "head_dense.bias": sd["classifier.dense.bias"],
        "head_out.weight": sd["classifier.out_proj.weight"],
        "head_out.bias": sd["classifier.out_proj.bias"],
    }
    layer = {
        "attention.query": "attention.self.query",
        "attention.key": "attention.self.key",
        "attention.value": "attention.self.value",
        "attention.out": "attention.output.dense",
        "ln_attn": "attention.output.LayerNorm",
        "ffn_in": "intermediate.dense",
        "ffn_out": "output.dense",
        "ln_ffn": "output.LayerNorm",
    }
    for i in range(cfg.n_layers):
        for ours, theirs in layer.items():
            for part in ("weight", "bias"):
                out[f"block_{i}.{ours}.{part}"] = sd[f"{pre}encoder.layer.{i}.{theirs}.{part}"]
    return out


def load_hf_checkpoint(path: str, head: str = "sigmoid"):
    """A local HF checkpoint directory (``config.json`` and
    ``pytorch_model.bin``) → ``(SentimentEncoder, state dict)``, the
    encoder holding the converted float32 tensors on the CPU.  Reads the
    directory only: nothing is fetched."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path!r} is not a local checkpoint directory")
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f), head=head)
    state_dict = torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu",
                            weights_only=True)
    params = convert_roberta_state_dict(state_dict, cfg)
    return load_encoder(SentimentEncoder, cfg, params), params


# --------------------------------------------------------------------------
# Converted-checkpoint persistence: the reference's single .npz
# --------------------------------------------------------------------------


def flax_tree(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The encoder's state dict → the reference's flax tree
    ``{"params": ...}`` of numpy float arrays (the inverse of
    :func:`~svoc_torch.models.from_jax.params_from_flax`): ``Linear`` →
    ``kernel`` ``[in, out]`` and ``bias``, ``LayerNorm`` → ``scale`` and
    ``bias``, ``Embedding`` → ``embedding``.  A quantized dense
    (:func:`svoc_torch.models.quant.quantize_params`) becomes the
    reference's ``w_int8 [in, out]`` int8, ``w_scale`` and ``bias``
    float32, dtype-exact."""
    tree: Dict[str, Any] = {}
    modules = {k.rsplit(".", 1)[0] for k in state_dict}
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    for module in sorted(modules):
        leaf = module.rsplit(".", 1)[-1]
        if module + ".w_int8" in state_dict:
            node = {"w_int8": np.ascontiguousarray(host(state_dict[module + ".w_int8"]).T),
                    "w_scale": host(state_dict[module + ".w_scale"]),
                    "bias": host(state_dict[module + ".bias"])}
        elif leaf in ("tok_emb", "pos_emb"):
            node = {"embedding": host(state_dict[module + ".weight"].float())}
        elif leaf.startswith("ln_"):
            node = {"scale": host(state_dict[module + ".weight"].float()),
                    "bias": host(state_dict[module + ".bias"].float())}
        else:
            node = {"kernel": np.ascontiguousarray(host(state_dict[module + ".weight"].float()).T),
                    "bias": host(state_dict[module + ".bias"].float())}
        parent = tree
        for part in module.split(".")[:-1]:
            parent = parent.setdefault(part, {})
        parent[leaf] = node
    return {"params": tree}


def save_params(path: str, params) -> str:
    """Write ``params`` as one ``.npz`` in the reference's layout (keys
    are ``/``-joined tree paths); ``params`` is a flax-layout tree or the
    encoder's state dict (converted by :func:`flax_tree`).  Returns the
    file's path (``.npz`` appended when missing)."""
    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        params = flax_tree(params)
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, f"{prefix}/{key}" if prefix else str(key))
        else:
            flat[prefix] = np.asarray(node)

    walk(params, "")
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, **flat)
    return path


def load_params(path: str) -> Dict[str, Any]:
    """The inverse of :func:`save_params`: the nested tree, as the
    reference's ``load_params`` returns it."""
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return out


def main(argv=None) -> int:
    """CLI: ``python -m svoc_torch.models.convert DIR -o params.npz``:
    convert a local HF RoBERTa classifier directory to a params file both
    packages load."""
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("path", help="local HF checkpoint directory (config.json, pytorch_model.bin)")
    parser.add_argument("-o", "--out", required=True, help="output .npz")
    parser.add_argument("--head", choices=("sigmoid", "softmax"), default="sigmoid")
    args = parser.parse_args(argv)

    model, params = load_hf_checkpoint(args.path, head=args.head)
    out_path = save_params(args.out, params)
    n = sum(int(t.numel()) for t in params.values())
    print(f"converted {args.path}: {n / 1e6:.1f}M params ({model.cfg.n_layers}L/{model.cfg.hidden}H, "
          f"{model.cfg.n_labels} labels) -> {out_path}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
