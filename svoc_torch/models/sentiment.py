"""The sentiment stage: texts or token batches → normalized 6-D emotion
vectors.

Mirrors :mod:`svoc_tpu.models.sentiment` (``GO_EMOTIONS_LABELS``,
``TRACKED_INDICES``, ``scores_to_vectors`` and ``SentimentPipeline``;
``sentiment.py:26-59, 62-341``).  Not ported here: ``tokenizer_name`` (no
HF tokenizer files are in the repository, so the pipeline always runs
the hashing tokenizer, which is also what the reference falls back to),
``data_mesh``, ``quant`` (:mod:`svoc_torch.models.forward` raises for
int8) and the ``stage_span`` traces.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from svoc_torch.device import resolve_device
from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, EncoderConfig
from svoc_torch.models.encoder import ATTENTIONS, init_params, load_encoder
from svoc_torch.models.forward import resolve_forward
from svoc_torch.models.packing import pack_tokens_auto, strip_padding
from svoc_torch.models.tokenizer import HashingTokenizer

#: The 28 go_emotions labels in model-head order.
GO_EMOTIONS_LABELS = (
    "admiration", "amusement", "anger", "annoyance", "approval", "caring",
    "confusion", "curiosity", "desire", "disappointment", "disapproval",
    "disgust", "embarrassment", "excitement", "fear", "gratitude", "grief",
    "joy", "love", "nervousness", "optimism", "pride", "realization",
    "relief", "remorse", "sadness", "surprise", "neutral",
)

#: The tracked subset, DIMENSION = 6 (``client/common.py:19-31``).
TRACKED_LABELS = (
    "optimism", "anger", "annoyance", "excitement", "nervousness", "remorse",
)

TRACKED_INDICES = tuple(GO_EMOTIONS_LABELS.index(l) for l in TRACKED_LABELS)


def scores_to_vectors(
    logits: torch.Tensor,
    label_indices: tuple = TRACKED_INDICES,
    multi_label: bool = True,
) -> torch.Tensor:
    """Logits ``[B, L]`` → sum-normalized tracked vectors ``[B, len(idx)]``:
    per-label sigmoid (multi-label) or softmax, then the reference's
    sum-to-one ``normalize``."""
    scores = torch.sigmoid(logits) if multi_label else torch.softmax(logits, dim=-1)
    sel = scores[:, list(label_indices)]
    return sel / sel.sum(dim=-1, keepdim=True)


class SentimentPipeline:
    """Encoder, tokenizer and vector head on one device, with fixed batch
    shapes: construct once, call with a list of strings, get
    ``[len(texts), M]`` float64 vectors back.

    ``params`` is a state dict (from :func:`init_params` or
    :func:`svoc_torch.models.from_jax.params_from_flax`); without it the
    weights are drawn from ``seed``.  ``params_dtype`` casts the float32
    tensors once (bf16-resident weights, as the flagship runs).  One
    state dict serves the unpacked module (``model``) and the packed one
    (``packed_model``), under either ``cfg.attention``.  ``packed``
    routes ``__call__`` through :meth:`call_packed` with
    ``max_segments`` comments a row."""

    def __init__(
        self,
        cfg: EncoderConfig = ROBERTA_GO_EMOTIONS,
        seq_len: int = 128,
        batch_size: int = 32,
        label_indices: tuple = TRACKED_INDICES,
        seed: int = 0,
        params: Optional[Dict[str, torch.Tensor]] = None,
        params_dtype: Optional[torch.dtype] = None,
        packed: bool = False,
        max_segments: int = 8,
        device=None,
    ):
        # All config validation up front, before the weights are drawn
        # or moved.
        if packed and cfg.attention not in ATTENTIONS:
            raise ValueError(
                "packed inference supports cfg.attention 'dense' or "
                f"'flash' (got {cfg.attention!r})"
            )
        if max(label_indices) >= cfg.n_labels:
            raise ValueError(
                f"label_indices {label_indices} out of range for a "
                f"{cfg.n_labels}-label head — pass label_indices "
                f"matching the model (e.g. (0, 1) for SST-2)"
            )
        unpacked_cls = resolve_forward(cfg)
        packed_cls = resolve_forward(cfg, packed=True)
        # float32 matmuls (the head's last projection, and every matmul of
        # a float32 config such as TINY_TEST) stay full float32 on the
        # card, as XLA's are: no TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.packed = packed
        self.max_segments = max_segments
        self.label_indices = tuple(label_indices)
        self.device = resolve_device(device)
        if params is None:
            params = init_params(cfg, seed, self.device)
        params = {
            k: v.to(self.device, params_dtype if params_dtype and v.is_floating_point() else v.dtype)
            for k, v in params.items()
        }
        self.model = load_encoder(unpacked_cls, cfg, params)
        self.packed_model = load_encoder(packed_cls, cfg, params)
        self.tokenizer = HashingTokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=seq_len)

    @property
    def dimension(self) -> int:
        return len(self.label_indices)

    def _vectors(self, logits: torch.Tensor) -> torch.Tensor:
        return scores_to_vectors(logits, self.label_indices, self.cfg.head == "sigmoid")

    @torch.inference_mode()
    def forward(self, ids, mask) -> torch.Tensor:
        """``[B, T]`` token ids and mask on the pipeline's device →
        vectors ``[B, M]``."""
        return self._vectors(self.model(ids, mask))

    @torch.inference_mode()
    def packed_forward(self, ids, pos, seg, cls_pos) -> torch.Tensor:
        """``[R, T]`` packed tensors (and ``cls_pos [R, S]``) on the
        pipeline's device → vectors ``[R, S, M]``.  Invalid segments give
        rows the caller masks with ``seg_valid``."""
        logits = self.packed_model(ids, pos, seg, cls_pos)
        r, s, n_labels = logits.shape
        return self._vectors(logits.reshape(r * s, n_labels)).reshape(r, s, self.dimension)

    def forward_fn(self):
        """The raw ``(ids, mask) → [B, M]`` device function (the
        parameters live in the module, not in an argument)."""
        return self.forward

    def packed_forward_fn(self):
        """The raw ``(ids, pos, seg, cls_pos) → [R, S, M]`` device
        function; ``S`` comes from the inputs, so one callable serves
        every ``max_segments``."""
        return self.packed_forward

    def _to_device(self, arrays):
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    def call_packed(self, texts: Sequence[str], max_segments: int = 8) -> np.ndarray:
        """Packed equivalent of ``__call__``: the same ``[len(texts), M]``
        result from about packing-factor fewer forward rows.  The row
        count is padded to ``batch_size`` multiples by repeating the last
        row, so the forward's shapes stay fixed."""
        if not len(texts):
            return np.zeros((0, self.dimension))
        ids, mask = self.tokenizer(list(texts), self.seq_len)
        batch, n = pack_tokens_auto(
            strip_padding(ids, mask), self.seq_len, max_segments, self.tokenizer.pad_id
        )
        if n != len(texts):
            raise RuntimeError(f"packer consumed {n}/{len(texts)} without a row cap")
        out = np.zeros((len(texts), self.dimension), dtype=np.float64)
        b = self.batch_size
        for i in range(0, batch.ids.shape[0], b):
            sl = slice(i, i + b)
            chunk = [batch.ids[sl], batch.pos[sl], batch.seg[sl], batch.cls_pos[sl]]
            n_real = chunk[0].shape[0]
            if n_real < b:
                chunk = [
                    np.concatenate([a, np.repeat(a[-1:], b - n_real, axis=0)], axis=0)
                    for a in chunk
                ]
            vecs = self.packed_forward(*self._to_device(chunk)).cpu().numpy().astype(np.float64)
            valid = batch.seg_valid[sl] > 0
            out[batch.owner[sl][valid]] = vecs[:n_real][valid]
        return out

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """``sentiment_analysis`` equivalent: pad the last chunk with
        ``""`` to ``batch_size``, run the forward per chunk, return
        ``[len(texts), M]`` float64."""
        if self.packed:
            return self.call_packed(texts, self.max_segments)
        out = []
        b = self.batch_size
        for i in range(0, len(texts), b):
            chunk = list(texts[i : i + b])
            n_real = len(chunk)
            chunk += [""] * (b - n_real)
            vecs = self.forward(*self._to_device(self.tokenizer(chunk, self.seq_len)))
            out.append(vecs[:n_real].cpu().numpy().astype(np.float64))
        return np.concatenate(out, axis=0) if out else np.zeros((0, self.dimension))
