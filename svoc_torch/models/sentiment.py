"""The sentiment stage: texts or token batches → normalized 6-D emotion
vectors.

Mirrors :mod:`svoc_tpu.models.sentiment` (``GO_EMOTIONS_LABELS``,
``TRACKED_INDICES``, ``scores_to_vectors`` and ``SentimentPipeline``;
``sentiment.py:26-59, 62-341``).  Not ported here: ``tokenizer_name`` (no
HF tokenizer files are in the repository, so the pipeline always runs
the native hashing tokenizer, which is also what the reference falls
back to).  The ``tokenize``, ``pack`` and ``forward`` spans sit where the
reference's do (``sentiment.py:276-278, 306, 331, 338``); ``forward``
covers the launch and the copy of the vectors to the host that was
already there, so it adds no sync.  ``data_mesh`` (a 1-D
:class:`~svoc_torch.parallel.mesh.Mesh`) splits every forward's rows
over its slots, each slot's rows through a copy of the module on its
slot's device (none where the slot is the pipeline's own device), as
the reference's ``data_mesh`` shards the batch
(``sentiment.py:84-89, 191-212, 246-251``).  ``quant="int8"`` serves the W8A8 forward
(:mod:`svoc_torch.models.quant`): a float state dict is folded once at
construction (no span of its own, as in the reference), a folded one is
used as it is, and the reference's validation errors are raised
(``sentiment.py:124-141``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from svoc_torch.device import resolve_device
from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, EncoderConfig
from svoc_torch.models.encoder import ATTENTIONS, init_params, load_encoder
from svoc_torch.models.forward import resolve_forward, validate_quant
from svoc_torch.models.packing import observe_fill_ratios, pack_tokens_auto, strip_padding
from svoc_torch.models.tokenizer import load_tokenizer
from svoc_torch.utils.metrics import stage_span

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
    ``max_segments`` comments a row.  ``quant="int8"`` swaps both
    modules for the W8A8 ones (dense attention only); the float tensors
    are dropped once folded."""

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
        quant: Optional[str] = None,
        data_mesh=None,
        device=None,
    ):
        # All config validation up front, before the weights are drawn
        # or moved.
        if data_mesh is not None:
            if len(data_mesh.axis_names) != 1:
                raise ValueError(f"data_mesh must be 1-D, got axes {data_mesh.axis_names}")
            if batch_size % data_mesh.size:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by the {data_mesh.size}-device data mesh"
                )
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
        validate_quant(cfg, quant)
        if quant is None and params is not None:
            from svoc_torch.models.quant import is_quantized_tree

            if is_quantized_tree(params):
                raise ValueError(
                    "params is a pre-quantized (int8) tree but quant is "
                    "None — pass quant='int8' to serve it, or load the "
                    "float checkpoint for the float forward"
                )
        if quant and params_dtype is not None:
            raise ValueError(
                "params_dtype is not meaningful under quant='int8' — "
                "the fold defines its own dtypes (int8 kernels, f32 "
                "scales/rest); casting a quantized tree would change "
                "its numerics"
            )
        unpacked_cls = resolve_forward(cfg, quant)
        packed_cls = resolve_forward(cfg, quant, packed=True)
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
        self.quant = quant
        self.device = resolve_device(device)
        if params is None:
            params = init_params(cfg, seed, self.device)
        params = {
            k: v.to(self.device, params_dtype if params_dtype and v.is_floating_point() else v.dtype)
            for k, v in params.items()
        }
        if quant == "int8":
            from svoc_torch.models.quant import is_quantized_tree, quantize_params

            if not is_quantized_tree(params):
                params = quantize_params(params, cfg)
            self.model = unpacked_cls(cfg, params)
            self.packed_model = packed_cls(cfg, params)
        else:
            self.model = load_encoder(unpacked_cls, cfg, params)
            self.packed_model = load_encoder(packed_cls, cfg, params)
        self.tokenizer = load_tokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=seq_len)
        self.data_mesh = data_mesh
        if data_mesh is not None:
            self._shard_forwards(data_mesh, params, unpacked_cls, packed_cls)

    def _shard_forwards(self, mesh, params, unpacked_cls, packed_cls) -> None:
        """The row-split forwards over ``mesh``: one (unpacked, packed)
        module pair a distinct slot device, replicated there once."""
        from svoc_torch.parallel.mesh import P, canonical_device
        from svoc_torch.parallel.sharded import current_device, shard_map

        replicas = {canonical_device(self.device): (self.model, self.packed_model)}
        for dev in set(mesh.devices.flat):
            if dev not in replicas:
                local = {k: v.to(dev) for k, v in params.items()}
                if self.quant == "int8":
                    replicas[dev] = (unpacked_cls(self.cfg, local), packed_cls(self.cfg, local))
                else:
                    replicas[dev] = (load_encoder(unpacked_cls, self.cfg, local),
                                     load_encoder(packed_cls, self.cfg, local))
        axis = mesh.axis_names[0]

        def rows(ids, mask):
            return self._vectors(replicas[current_device()][0](ids, mask))

        def packed_rows(ids, pos, seg, cls_pos):
            logits = replicas[current_device()][1](ids, pos, seg, cls_pos)
            r, s, n_labels = logits.shape
            return self._vectors(logits.reshape(r * s, n_labels)).reshape(r, s, self.dimension)

        self._rows = shard_map(rows, mesh=mesh, in_specs=(P(axis, None),) * 2,
                               out_specs=P(axis, None), collectives=False)
        self._packed_rows = shard_map(packed_rows, mesh=mesh, in_specs=(P(axis, None),) * 4,
                                      out_specs=P(axis, None, None), collectives=False)

    @property
    def dimension(self) -> int:
        return len(self.label_indices)

    def _vectors(self, logits: torch.Tensor) -> torch.Tensor:
        return scores_to_vectors(logits, self.label_indices, self.cfg.head == "sigmoid")

    @torch.inference_mode()
    def forward(self, ids, mask) -> torch.Tensor:
        """``[B, T]`` token ids and mask on the pipeline's device →
        vectors ``[B, M]`` (row-split over ``data_mesh`` when set)."""
        if self.data_mesh is not None:
            return self._rows(ids, mask)
        return self._vectors(self.model(ids, mask))

    @torch.inference_mode()
    def packed_forward(self, ids, pos, seg, cls_pos) -> torch.Tensor:
        """``[R, T]`` packed tensors (and ``cls_pos [R, S]``) on the
        pipeline's device → vectors ``[R, S, M]``.  Invalid segments give
        rows the caller masks with ``seg_valid``."""
        if self.data_mesh is not None:
            return self._packed_rows(ids, pos, seg, cls_pos)
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

    def call_packed(
        self, texts: Sequence[str], max_segments: int = 8, lineage: Optional[str] = None
    ) -> np.ndarray:
        """Packed equivalent of ``__call__``: the same ``[len(texts), M]``
        result from about packing-factor fewer forward rows.  The row
        count is padded to ``batch_size`` multiples by repeating the last
        row, so the forward's shapes stay fixed.  ``lineage`` tags the
        stage spans (inside a ``fetch`` span they inherit its lineage)."""
        if not len(texts):
            return np.zeros((0, self.dimension))
        with stage_span("tokenize", lineage=lineage):
            ids, mask = self.tokenizer(list(texts), self.seq_len)
        with stage_span("pack", lineage=lineage):
            batch, n = pack_tokens_auto(
                strip_padding(ids, mask), self.seq_len, max_segments, self.tokenizer.pad_id
            )
        # The packing_fill_ratio{kind=} gauges: how much of the segment
        # and token headroom this pack used (sentiment.py:286).
        observe_fill_ratios(batch)
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
            with stage_span("forward", lineage=lineage):
                vecs = self.packed_forward(*self._to_device(chunk)).cpu().numpy().astype(np.float64)  # svoclint: disable=SVOC001 -- the host copy the reference's suppressed np.asarray makes (sentiment.py:307): the span covers the launch and the fetch that was already here, no added sync
            valid = batch.seg_valid[sl] > 0
            out[batch.owner[sl][valid]] = vecs[:n_real][valid]
        return out

    def __call__(self, texts: Sequence[str], lineage: Optional[str] = None) -> np.ndarray:
        """``sentiment_analysis`` equivalent: pad the last chunk with
        ``""`` to ``batch_size``, run the forward per chunk, return
        ``[len(texts), M]`` float64.  ``lineage`` as in :meth:`call_packed`."""
        if self.packed:
            return self.call_packed(texts, self.max_segments, lineage=lineage)
        out = []
        b = self.batch_size
        for i in range(0, len(texts), b):
            chunk = list(texts[i : i + b])
            n_real = len(chunk)
            chunk += [""] * (b - n_real)
            with stage_span("tokenize", lineage=lineage):
                ids, mask = self.tokenizer(chunk, self.seq_len)
            with stage_span("forward", lineage=lineage):
                vecs = self.forward(*self._to_device((ids, mask)))
                out.append(vecs[:n_real].cpu().numpy().astype(np.float64))  # svoclint: disable=SVOC001 -- the host copy the reference's suppressed np.asarray makes (sentiment.py:340): the span covers the launch and the fetch that was already here, no added sync
        return np.concatenate(out, axis=0) if out else np.zeros((0, self.dimension))
