"""The sentiment head: packed encoder logits → normalized 6-D emotion
vectors.

Mirrors :mod:`svoc_tpu.models.sentiment` (``GO_EMOTIONS_LABELS``,
``TRACKED_INDICES``, ``scores_to_vectors`` and the packed forward of
``SentimentPipeline``; ``sentiment.py:26-59, 226-252``).  The pipeline
here is the packed forward only; the unpacked ``__call__`` and
``call_packed`` are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from svoc_torch.device import resolve_device
from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, EncoderConfig
from svoc_torch.models.encoder import init_params, load_encoder
from svoc_torch.models.packing import PackedSentimentEncoder
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
    """Packed encoder, its tokenizer and the vector head on one device.

    ``params`` is a state dict (from :func:`init_params` or
    :func:`svoc_torch.models.from_jax.params_from_flax`); without it the
    weights are drawn from ``seed``.  ``params_dtype`` casts the float32
    tensors once (bf16-resident weights, as the flagship runs)."""

    def __init__(
        self,
        cfg: EncoderConfig = ROBERTA_GO_EMOTIONS,
        seq_len: int = 128,
        label_indices: tuple = TRACKED_INDICES,
        seed: int = 0,
        params: Optional[Dict[str, torch.Tensor]] = None,
        params_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        if max(label_indices) >= cfg.n_labels:
            raise ValueError(
                f"label_indices {label_indices} out of range for a "
                f"{cfg.n_labels}-label head"
            )
        # float32 matmuls (the head's last projection, and every matmul of
        # a float32 config such as TINY_TEST) stay full float32 on the
        # card, as XLA's are: no TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.seq_len = seq_len
        self.label_indices = tuple(label_indices)
        self.device = resolve_device(device)
        if params is None:
            params = init_params(cfg, seed, self.device)
        params = {
            k: v.to(self.device, params_dtype if params_dtype and v.is_floating_point() else v.dtype)
            for k, v in params.items()
        }
        self.model = load_encoder(PackedSentimentEncoder, cfg, params)
        self.tokenizer = HashingTokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=seq_len)

    @property
    def dimension(self) -> int:
        return len(self.label_indices)

    @torch.inference_mode()
    def packed_forward(self, ids, pos, seg, cls_pos) -> torch.Tensor:
        """``[R, T]`` packed tensors (and ``cls_pos [R, S]``) on the
        pipeline's device → vectors ``[R, S, M]``.  Invalid segments give
        rows the caller masks with ``seg_valid``."""
        logits = self.model(ids, pos, seg, cls_pos)
        r, s, n_labels = logits.shape
        vecs = scores_to_vectors(
            logits.reshape(r * s, n_labels), self.label_indices, self.cfg.head == "sigmoid"
        )
        return vecs.reshape(r, s, self.dimension)
