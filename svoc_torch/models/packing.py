"""Sequence packing: several comments per fixed-length row.

Mirrors :mod:`svoc_tpu.models.packing` (``PackedBatch``,
``strip_padding``, ``pack_tokens``, ``pack_labels``,
``fill_ratios``, ``observe_fill_ratios``, ``pack_tokens_auto``,
``PackedSentimentEncoder``; ``packing.py:55-285``).  :func:`pack_tokens` is the Python
greedy next-fit packer and gives arrays identical to the reference's for
the same token lists; it is the plain version of the native C++ packer
(:mod:`svoc_torch.runtime`, ROADMAP A6), to which :func:`pack_tokens_auto`
routes every batch, with no fallback.

Positions restart per segment at ``pad_id + 1``; a packed segment sees
exactly the keys of its own comment, so its logits are those of the
unpacked forward.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from svoc_torch.models.encoder import SentimentEncoder, check_attention
from svoc_torch.ops.dense_attention import block_diagonal_bias
from svoc_torch.runtime import native_pack_tokens_raw


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


def fill_ratios(batch: PackedBatch) -> dict:
    """Occupancy of a packed batch: ``segments`` (segments used over
    ``R × S`` slots) and ``tokens`` (real tokens over ``R × T`` id
    slots)."""
    r, s = batch.seg_valid.shape
    t = batch.ids.shape[1]
    segments_used = int(batch.seg_valid.sum())
    real_tokens = int((batch.seg > 0).sum())
    return {
        "rows": int(r),
        "segments_used": segments_used,
        "segments": round(segments_used / float(max(r * s, 1)), 6),
        "tokens": round(real_tokens / float(max(r * t, 1)), 6),
    }


def observe_fill_ratios(batch: PackedBatch, registry=None) -> dict:
    """:func:`fill_ratios` plus the ``packing_fill_ratio{kind=}`` gauges
    (``kind`` ``segments`` and ``tokens``) that every pack-path caller
    (``SentimentPipeline.call_packed``, so the serving batcher) exports
    into ``registry`` (the process registry when None)."""
    if registry is None:
        from svoc_torch.utils.metrics import registry as registry
    ratios = fill_ratios(batch)
    for kind in ("segments", "tokens"):
        registry.gauge("packing_fill_ratio", labels={"kind": kind}).set(ratios[kind])
    return ratios


def pack_tokens_auto(
    token_lists: Sequence[Sequence[int]],
    seq_len: int,
    max_segments: int,
    pad_id: int,
    rows: int | None = None,
) -> Tuple[PackedBatch, int]:
    """:func:`pack_tokens` through the native C++ packer (GIL-free, the
    host hot stage of packed serving); bit-identical to it.  Raises when
    the native runtime cannot be built."""
    *arrays, n = native_pack_tokens_raw(token_lists, seq_len, max_segments, pad_id, rows)
    return PackedBatch(*arrays), n


def pack_labels(batch: PackedBatch, labels: np.ndarray) -> np.ndarray:
    """Scatter per-comment ``labels [N, ...]`` into the packed layout
    ``[R, S, ...]`` through the owner map (zeros where no segment): the
    label side of a packed fine-tuning batch
    (:func:`svoc_torch.train.trainer.make_packed_train_step`)."""
    labels = np.asarray(labels)
    if len(labels) == 0:  # all-padding batch (empty streaming tail)
        return np.zeros(batch.owner.shape + labels.shape[1:], labels.dtype)
    safe = np.where(batch.owner >= 0, batch.owner, 0)
    out = labels[safe]
    out[batch.seg_valid == 0] = 0
    return out


class PackedSentimentEncoder(SentimentEncoder):
    """Packed-batch twin of :class:`SentimentEncoder` with the same
    parameters: ``(ids, pos_ids, seg [R, T], cls_pos [R, S])`` → logits
    ``[R, S, n_labels]``.  Attention keeps to the block diagonal of
    ``seg``; padding is never gathered (under ``"flash"`` it attends
    nothing; under ``"dense"`` its additive bias is -1e9 on every key,
    so it averages the row uniformly)."""

    def forward(self, ids, pos_ids, seg, cls_pos):  # type: ignore[override]
        cfg = self.cfg
        check_attention(cfg)
        x = self.embed(ids, pos_ids)
        if cfg.attention == "flash":
            # The kernel rebuilds the mask per tile from the [R, T] ids:
            # no [R, 1, T, T] bias in device memory.
            x = self.encode(x, segments=seg)
        else:
            x = self.encode(x, bias=block_diagonal_bias(seg))
        index = cls_pos.long()[:, :, None].expand(-1, -1, cfg.hidden)
        return self.head(torch.gather(x, 1, index))
