"""Encoder configurations.

Mirrors :mod:`svoc_tpu.models.configs` with torch dtypes.
``ROBERTA_GO_EMOTIONS`` is the architecture of the reference classifier
``SamLowe/roberta-base-go_emotions`` (RoBERTa-base, 28 labels, sigmoid
head); ``DISTILBERT_SST2`` the single-oracle DistilBERT-SST2 shape;
``TINY_TEST`` the small config of the tests.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 50265
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    intermediate: int = 3072
    max_len: int = 512
    n_labels: int = 28
    pad_id: int = 1
    ln_eps: float = 1e-5
    #: computation dtype of the matmuls; layernorms and the last head
    #: projection run in float32.
    dtype: torch.dtype = torch.bfloat16
    #: "sigmoid" (multi-label, go_emotions) or "softmax" (SST-2).
    head: str = "sigmoid"

    @property
    def head_dim(self) -> int:
        if self.hidden % self.n_heads:
            raise ValueError(f"hidden {self.hidden} not divisible by {self.n_heads} heads")
        return self.hidden // self.n_heads


ROBERTA_GO_EMOTIONS = EncoderConfig()

DISTILBERT_SST2 = EncoderConfig(
    vocab_size=30522,
    n_layers=6,
    max_len=512,
    n_labels=2,
    pad_id=0,
    head="softmax",
    ln_eps=1e-12,
)

TINY_TEST = EncoderConfig(
    vocab_size=1024,
    hidden=64,
    n_layers=2,
    n_heads=4,
    intermediate=128,
    max_len=64,
    n_labels=28,
    dtype=torch.float32,
)
