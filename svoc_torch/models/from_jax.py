"""Carries a flax parameter tree into the port's encoder (no
``svoc_tpu`` counterpart).

:func:`params_from_flax` takes the tree of
:class:`svoc_tpu.models.encoder.SentimentEncoder` as nested dicts of
arrays (``tree["params"]["block_0"]["attention"]["query"]["kernel"]``,
…) and returns the state dict of
:class:`svoc_torch.models.encoder.SentimentEncoder`, whose submodules
carry the same names.  ``Dense`` kernels ``[in, out]`` become
``Linear.weight`` ``[out, in]``; ``LayerNorm`` ``scale``/``bias`` become
``weight``/``bias``; ``Embed.embedding`` becomes ``weight``.  A dense of
the reference's quantized tree (``svoc_tpu.models.quant.quantize_params``:
``w_int8 [in, out]``, ``w_scale``, ``bias``) becomes the port's quantized
triple (``w_int8 [out, in]`` int8, ``w_scale`` and ``bias`` float32),
dtype-exact and never cast.  Arrays are read through ``numpy.asarray``,
so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(array, dtype) -> torch.Tensor:
    a = np.asarray(array)
    if a.dtype.kind not in "fiu":  # bfloat16 arrives as a numpy extension type
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a))  # a writable copy
    return t if dtype is None else t.to(dtype)


def params_from_flax(tree: Mapping, dtype: "torch.dtype | None" = None) -> Dict[str, torch.Tensor]:
    """Flax encoder tree → torch state dict (on the CPU; ``dtype`` casts
    every tensor when given)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        if "w_int8" in node:  # a quantized Dense (svoc_tpu/models/quant.py:57)
            out[prefix + "w_int8"] = _tensor(node["w_int8"], None).T.contiguous()
            out[prefix + "w_scale"] = _tensor(node["w_scale"], None)
            out[prefix + "bias"] = _tensor(node["bias"], None)
        elif "kernel" in node:  # Dense
            out[prefix + "weight"] = _tensor(node["kernel"], dtype).T.contiguous()
            out[prefix + "bias"] = _tensor(node["bias"], dtype)
        elif "scale" in node:  # LayerNorm
            out[prefix + "weight"] = _tensor(node["scale"], dtype)
            out[prefix + "bias"] = _tensor(node["bias"], dtype)
        elif "embedding" in node:  # Embed
            out[prefix + "weight"] = _tensor(node["embedding"], dtype)
        else:
            for name, child in node.items():
                walk(child, f"{prefix}{name}.")

    walk(tree["params"] if "params" in tree else tree, "")
    return out
