"""Data-parallel inference serving on the mesh.

Mirrors :mod:`svoc_tpu.parallel.serving` (``serving.py:1-315``:
``_traced_dispatch``, ``dp_serving_step_fn``, ``_packed_window_fn``,
``packed_serving_step_fn``, ``packed_serving_pipelined_step_fn``,
``fleet_step_fn``, ``batch_sharding``, ``serving_mesh``).

One mesh axis (``data``) carries both parallelisms of the serving step,
in one :func:`~svoc_torch.parallel.sharded.shard_map` body:

- the encoder forward runs **data-parallel**: the token rows split over
  the axis, each slot runs the forward on its rows on its device (the
  parameters replicated there once, :class:`_Replicas`), so a packed
  forward under ``attention="flash"`` launches the flash-attention
  kernel (B1) once a layer on every slot;
- the sentiment vectors are gathered (``all_gather``, in row order) and
  the window is their first ``window_size`` (valid) rows on every slot;
  the bootstrap fleet and the two-pass consensus then run
  **oracle-parallel** over the same axis (the bodies of
  :mod:`svoc_torch.parallel.sharded`: global-index keys, so the fleet
  is bitwise independent of the mesh size; the consensus is the psum
  body, plain torch ops, held to the reference at
  ``tests/test_parallel.py``'s bars).

``params`` is the encoder's state dict (float, or the folded int8 tree
with ``quant="int8"``) on any device; each slot's module holds a copy on
its slot's device, made on the first call with that dict and reused
while the same dict is passed.  Callers run the steps under
``torch.inference_mode()`` when they serve.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.device import resolve_device
from svoc_torch.models.configs import EncoderConfig
from svoc_torch.models.forward import resolve_forward
from svoc_torch.models.sentiment import TRACKED_INDICES, scores_to_vectors
from svoc_torch.ops.select import first_valid_window
from svoc_torch.parallel.mesh import DATA_AXIS, Mesh, NamedSharding, P, canonical_device
from svoc_torch.parallel.sharded import (
    _consensus_body,
    _fleet_body,
    all_gather,
    consensus_out_specs,
    current_device,
    fleet_consensus_shard_map,
    shard_map,
)
from svoc_torch.utils.metrics import stage_span


def _traced_dispatch(fn: Callable, stage: str, lineage=None) -> Callable:
    """``fn`` with each call recorded as a ``stage_seconds`` span (on the
    host: the span closes when the call returns, and nothing here waits
    for the device)."""

    @functools.wraps(fn)
    def dispatch(*args, **kwargs):
        with stage_span(stage, lineage=lineage):
            return fn(*args, **kwargs)

    return dispatch


class _Replicas:
    """The forward module on each slot's device, built from one state
    dict: made on the first call with that dict (a copy on the device,
    none when the dict already lies there) and reused while the same
    dict is passed."""

    def __init__(self, cfg: EncoderConfig, quant: Optional[str], packed: bool):
        self.cfg, self.quant = cfg, quant
        self.cls = resolve_forward(cfg, quant, packed=packed)
        self._modules: Dict[torch.device, tuple] = {}

    def on(self, params, device: torch.device):
        held = self._modules.get(device)
        if held is None or held[0] is not params:
            local = {k: v.to(device) for k, v in params.items()}
            if self.quant == "int8":
                module = self.cls(self.cfg, local)
            else:
                from svoc_torch.models.encoder import load_encoder

                module = load_encoder(self.cls, self.cfg, local)
            self._modules[device] = held = (params, module)
        return held[1]


def _check_labels(enc_cfg: EncoderConfig, label_indices: tuple) -> None:
    if max(label_indices) >= enc_cfg.n_labels:
        raise ValueError(
            f"label_indices {label_indices} out of range for a {enc_cfg.n_labels}-label head — "
            "the gather would read past the head; pass indices matching the model"
        )


def _fleet_tail(ccfg: ConsensusConfig, n_oracles: int, subset_size: int, axis: str, mesh: Mesh):
    """The fleet and consensus on a replicated window, inside a body."""
    if n_oracles % mesh.shape[axis]:
        raise ValueError(f"n_oracles={n_oracles} not divisible by mesh size {mesh.shape[axis]}")
    gen = _fleet_body(n_oracles, ccfg.n_failing, subset_size, axis)
    consensus = _consensus_body(ccfg, axis)

    def tail(key, window):
        values_local, honest_local = gen(key, window)
        return consensus(values_local), honest_local

    return tail


def dp_serving_step_fn(
    mesh: Mesh,
    enc_cfg: EncoderConfig,
    ccfg: ConsensusConfig,
    n_oracles: int,
    *,
    window_size: int = 50,
    subset_size: int = 10,
    label_indices: tuple = TRACKED_INDICES,
    axis: str = DATA_AXIS,
    quant: Optional[str] = None,
) -> Callable:
    """``(params, key, ids, mask) → (ConsensusOutput, honest)``: ``ids``
    and ``mask`` are ``[B, T]`` with ``B`` split over ``axis``; ``B`` and
    ``n_oracles`` must divide by the axis.  ``quant="int8"`` serves the
    W8A8 forward (pass the quantized tree as ``params``)."""
    _check_labels(enc_cfg, label_indices)
    replicas = _Replicas(enc_cfg, quant, packed=False)
    multi_label = enc_cfg.head == "sigmoid"
    tail = _fleet_tail(ccfg, n_oracles, subset_size, axis, mesh)

    def body(params, key, ids, mask):
        vecs = scores_to_vectors(replicas.on(params, current_device())(ids, mask), label_indices, multi_label)
        window = all_gather(vecs, axis)[:window_size]
        return tail(key, window)

    mapped = shard_map(body, mesh=mesh, in_specs=(P(), P(), P(axis, None), P(axis, None)),
                       out_specs=(consensus_out_specs(axis), P(axis)))

    def serve(params, key, ids, mask):
        if ids.shape[0] < window_size:
            raise ValueError(
                f"batch {ids.shape[0]} smaller than window_size {window_size} — the consensus "
                "window would be silently truncated"
            )
        return mapped(params, key, ids, mask)

    return _traced_dispatch(serve, "serving_step")


def _packed_window_fn(
    enc_cfg: EncoderConfig,
    window_size: int,
    label_indices: tuple,
    quant: Optional[str],
    axis: str,
) -> Callable:
    """The body's forward → window of the packed steps: ``(params, ids,
    pos, seg, cls_pos, valid)`` (this slot's rows) → the first
    ``window_size`` valid segment vectors in global row order,
    ``[window, M]`` on every slot.  One home so the plain and pipelined
    twins cannot drift."""
    _check_labels(enc_cfg, label_indices)
    replicas = _Replicas(enc_cfg, quant, packed=True)
    multi_label = enc_cfg.head == "sigmoid"

    def window_of(params, ids, pos, seg, cls_pos, valid):
        logits = replicas.on(params, current_device())(ids, pos, seg, cls_pos)  # [Rl, S, L]
        r, s, n_labels = logits.shape
        vecs = scores_to_vectors(logits.reshape(r * s, n_labels), label_indices, multi_label)
        return first_valid_window(all_gather(vecs, axis), all_gather(valid.reshape(-1), axis), window_size)

    return window_of


def _check_capacity(cls_pos, window_size: int) -> None:
    r, s = cls_pos.shape
    if r * s < window_size:
        raise ValueError(
            f"packed batch capacity {r}x{s} segments is smaller than window_size {window_size} — "
            "the consensus window would be silently truncated"
        )


def _row_specs(axis: str) -> tuple:
    """The packed rows' specs: ids, pos, seg, cls_pos and valid split over ``axis``."""
    return (P(axis, None),) * 5


def packed_serving_step_fn(
    mesh: Mesh,
    enc_cfg: EncoderConfig,
    ccfg: ConsensusConfig,
    n_oracles: int,
    *,
    window_size: int = 50,
    subset_size: int = 10,
    label_indices: tuple = TRACKED_INDICES,
    axis: str = DATA_AXIS,
    quant: Optional[str] = None,
) -> Callable:
    """Sequence-packed data-parallel serving: ``(params, key, ids, pos,
    seg, cls_pos, valid) → (ConsensusOutput, honest)`` with the packed
    rows (``[R, T]``, ``[R, S]``; ``valid`` is ``seg_valid > 0``) split
    over ``axis``.  The window is the first ``window_size`` valid
    segments in row order, as the unpacked step's ``vecs[:window]`` on the
    same texts; with fewer valid segments it is padded with zero vectors,
    so callers keep rows full.  ``quant="int8"`` swaps in the W8A8
    forward."""
    window_of = _packed_window_fn(enc_cfg, window_size, label_indices, quant, axis)
    tail = _fleet_tail(ccfg, n_oracles, subset_size, axis, mesh)

    def body(params, key, ids, pos, seg, cls_pos, valid):
        return tail(key, window_of(params, ids, pos, seg, cls_pos, valid))

    mapped = shard_map(body, mesh=mesh, in_specs=(P(), P()) + _row_specs(axis),
                       out_specs=(consensus_out_specs(axis), P(axis)))

    def serve(params, key, ids, pos, seg, cls_pos, valid):
        _check_capacity(cls_pos, window_size)
        return mapped(params, key, ids, pos, seg, cls_pos, valid)

    return _traced_dispatch(serve, "serving_step")


def packed_serving_pipelined_step_fn(
    mesh: Mesh,
    enc_cfg: EncoderConfig,
    ccfg: ConsensusConfig,
    n_oracles: int,
    *,
    window_size: int = 50,
    subset_size: int = 10,
    label_indices: tuple = TRACKED_INDICES,
    axis: str = DATA_AXIS,
    quant: Optional[str] = None,
) -> Callable:
    """The pipelined twin of :func:`packed_serving_step_fn`: ``(params,
    key, ids, pos, seg, cls_pos, valid, prev_window) → (window,
    ConsensusOutput, honest)``, the fleet and consensus of the previous
    batch's window (``key`` is that batch's) in the same body as this
    batch's forward.  The same windows and outputs, one step later;
    drain the last window with :func:`fleet_step_fn`."""
    window_of = _packed_window_fn(enc_cfg, window_size, label_indices, quant, axis)
    tail = _fleet_tail(ccfg, n_oracles, subset_size, axis, mesh)

    def body(params, key, ids, pos, seg, cls_pos, valid, prev_window):
        window = window_of(params, ids, pos, seg, cls_pos, valid)
        out, honest = tail(key, prev_window)
        return window, out, honest

    mapped = shard_map(body, mesh=mesh, in_specs=(P(), P()) + _row_specs(axis) + (P(),),
                       out_specs=(P(), consensus_out_specs(axis), P(axis)))

    def serve(params, key, ids, pos, seg, cls_pos, valid, prev_window):
        _check_capacity(cls_pos, window_size)
        return mapped(params, key, ids, pos, seg, cls_pos, valid, prev_window)

    return _traced_dispatch(serve, "serving_step")


def fleet_step_fn(
    mesh: Mesh,
    ccfg: ConsensusConfig,
    n_oracles: int,
    *,
    subset_size: int = 10,
    axis: str = DATA_AXIS,
    gate=None,
) -> Callable:
    """``(key, window) → (ConsensusOutput, honest)`` on the serving mesh:
    the pipelined loop's drain step.  ``gate=(lo, hi)`` adds the
    input-integrity quarantine and returns ``(ConsensusOutput, honest,
    admitted)``."""
    return _traced_dispatch(fleet_consensus_shard_map(mesh, ccfg, n_oracles, subset_size, axis, gate), "fleet")


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Token batches: the batch dimension split over ``axis``."""
    return NamedSharding(mesh, P(axis, None))


def serving_mesh(devices: Optional[list] = None, axis: str = DATA_AXIS, device=None) -> Mesh:
    """A 1-D serving mesh over ``devices`` (default: every visible card,
    one slot each, when ``device`` is CUDA, or ``device`` itself; pass a
    device several times for several slots of it)."""
    import numpy as np

    if devices is None:
        dev = resolve_device(device)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [canonical_device(d) for d in devices]
    return Mesh(grid, (axis,))
