"""Sequence packing: several comments per fixed-length row.

Mirrors :mod:`svoc_tpu.models.packing` (``PackedBatch``,
``strip_padding``, ``pack_tokens``, ``PackedSentimentEncoder``;
``packing.py:55-147, 228-285``).  :func:`pack_tokens` is the Python
greedy next-fit packer and gives arrays identical to the reference's for
the same token lists.  The native C++ packer comes in a later slice.

Positions restart per segment at ``pad_id + 1``; a packed segment sees
exactly the keys of its own comment, so its logits are those of the
unpacked forward.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from svoc_torch.models.encoder import SentimentEncoder


class PackedBatch(NamedTuple):
    """Fixed-shape packed token batch (all int32): ``R`` rows of ``T``
    tokens holding up to ``S`` segments each."""

    ids: np.ndarray  #: [R, T] token ids (pad_id where empty)
    pos: np.ndarray  #: [R, T] positions, restarting per segment
    seg: np.ndarray  #: [R, T] 1-based segment id within the row, 0 = padding
    cls_pos: np.ndarray  #: [R, S] row offset of each segment's first token
    seg_valid: np.ndarray  #: [R, S] 1 where the segment exists
    owner: np.ndarray  #: [R, S] index into the packed input list, -1 invalid

    @property
    def n_segments(self) -> int:
        return int(self.seg_valid.sum())


def strip_padding(ids: np.ndarray, mask: np.ndarray) -> List[np.ndarray]:
    """Fixed-shape tokenizer output → per-text unpadded id arrays."""
    return [row[m > 0] for row, m in zip(ids, mask)]


def pack_tokens(
    token_lists: Sequence[Sequence[int]],
    seq_len: int,
    max_segments: int,
    pad_id: int,
    rows: int | None = None,
) -> Tuple[PackedBatch, int]:
    """Greedy next-fit packing of ``token_lists`` into ``[R, T]`` rows.

    Lists longer than ``seq_len`` are truncated.  With ``rows=None``
    every list is consumed; with explicit ``rows`` packing stops when
    they are full.  Returns ``(batch, n_consumed)``."""
    if max_segments < 1:
        raise ValueError(f"max_segments must be >= 1, got {max_segments}")
    if rows is not None and rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    row_ids: List[List[int]] = []
    row_segs: List[List[Tuple[int, int]]] = []  # per row: (owner, start)
    cur_ids: List[int] = []
    cur_segs: List[Tuple[int, int]] = []
    n_consumed = 0

    def flush():
        nonlocal cur_ids, cur_segs
        if cur_segs:
            row_ids.append(cur_ids)
            row_segs.append(cur_segs)
            cur_ids, cur_segs = [], []

    for owner_idx, toks in enumerate(token_lists):
        toks = list(toks[:seq_len])
        if not toks:
            toks = [pad_id]  # an empty text still owns a segment
        if len(cur_ids) + len(toks) > seq_len or len(cur_segs) >= max_segments:
            flush()
            if rows is not None and len(row_ids) >= rows:
                break
        cur_segs.append((owner_idx, len(cur_ids)))
        cur_ids.extend(toks)
        n_consumed += 1
    else:
        flush()  # natural end: keep the trailing partial row

    r = rows if rows is not None else max(1, len(row_ids))
    t, s = seq_len, max_segments
    ids = np.full((r, t), pad_id, dtype=np.int32)
    pos = np.full((r, t), pad_id, dtype=np.int32)
    seg = np.zeros((r, t), dtype=np.int32)
    cls_pos = np.zeros((r, s), dtype=np.int32)
    seg_valid = np.zeros((r, s), dtype=np.int32)
    owner = np.full((r, s), -1, dtype=np.int32)
    for i, (tok_row, segs) in enumerate(zip(row_ids[:r], row_segs[:r])):
        ids[i, : len(tok_row)] = tok_row
        bounds = [start for _, start in segs] + [len(tok_row)]
        for j, (owner_idx, start) in enumerate(segs):
            end = bounds[j + 1]
            seg[i, start:end] = j + 1
            pos[i, start:end] = pad_id + 1 + np.arange(end - start)
            cls_pos[i, j] = start
            seg_valid[i, j] = 1
            owner[i, j] = owner_idx
    return PackedBatch(ids, pos, seg, cls_pos, seg_valid, owner), n_consumed


class PackedSentimentEncoder(SentimentEncoder):
    """Packed-batch twin of :class:`SentimentEncoder` with the same
    parameters: ``(ids, pos_ids, seg [R, T], cls_pos [R, S])`` → logits
    ``[R, S, n_labels]``.  Attention keeps to the block diagonal of
    ``seg``; padding attends nothing and is never gathered."""

    def forward(self, ids, pos_ids, seg, cls_pos):  # type: ignore[override]
        cfg = self.cfg
        x = self.embed(ids, pos_ids)
        for block in self.blocks():
            # The kernel rebuilds the mask per tile from the [R, T] ids.
            x = block(x, segments=seg)
        index = cls_pos.long()[:, :, None].expand(-1, -1, cfg.hidden)
        return self.head(torch.gather(x, 1, index))
