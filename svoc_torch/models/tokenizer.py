"""Deterministic hashing tokenizer producing fixed-shape batches.

Mirrors :class:`svoc_tpu.models.tokenizer.HashingTokenizer`
(``tokenizer.py:29-89``): lowercase, split on non-alphanumerics, FNV-1a
hash into the vocabulary after four special ids.  The flagship names an
HF tokenizer that is not in the repository, so the reference runs this
hashing fallback, and so does the port.  :func:`load_tokenizer`
(``tokenizer.py:118-143``, without the HF branch, whose files the
repository lacks) returns the native C++ tokenizer
(:mod:`svoc_torch.runtime`, ROADMAP A6), which the serving paths run; this Python
tokenizer is its plain version, bit-identical on ASCII text.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from svoc_torch.runtime import NativeHashingTokenizer

_FNV_OFFSET = 14695981039346656037
_FNV_PRIME = 1099511628211
_U64 = (1 << 64) - 1


def _fnv1a(token: str) -> int:
    h = _FNV_OFFSET
    for byte in token.encode("utf-8"):
        h = ((h ^ byte) * _FNV_PRIME) & _U64
    return h


class HashingTokenizer:
    """Reserves ``[pad, bos/cls, eos/sep, unk]`` then hashes words into
    ``[n_special, vocab_size)``."""

    N_SPECIAL = 4

    def __init__(self, vocab_size: int, pad_id: int = 1, max_len: int = 512):
        self.vocab_size = vocab_size
        self.pad_id = pad_id
        self.max_len = max_len
        specials = list(range(self.N_SPECIAL))
        self.bos_id = next(i for i in specials if i != pad_id)
        self.eos_id = next(i for i in specials if i not in (pad_id, self.bos_id))

    def _word_ids(self, text: str) -> List[int]:
        out: List[int] = []
        word = []
        for ch in text.lower():
            if ch.isalnum():
                word.append(ch)
            elif word:
                out.append(self._hash_word("".join(word)))
                word = []
        if word:
            out.append(self._hash_word("".join(word)))
        return out

    def _hash_word(self, word: str) -> int:
        return self.N_SPECIAL + (_fnv1a(word) % (self.vocab_size - self.N_SPECIAL))

    def __call__(
        self, texts: Sequence[str], seq_len: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenize a batch → ``(ids [B, T], mask [B, T])`` int32."""
        t = seq_len or self.max_len
        ids = np.full((len(texts), t), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), t), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.bos_id] + self._word_ids(text)[: t - 2] + [self.eos_id]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask


def load_tokenizer(vocab_size: int, pad_id: int = 1, max_len: int = 512):
    """The tokenizer the pipelines run: the native hashing tokenizer,
    built at first use; raises ``RuntimeError`` when it cannot be built
    (no fallback to :class:`HashingTokenizer`)."""
    return NativeHashingTokenizer(vocab_size, pad_id=pad_id, max_len=max_len)
