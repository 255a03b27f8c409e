"""Single-device fine-tune steps for :class:`SentimentEncoder` and its
packed twin.

Mirrors the single-device part of :mod:`svoc_tpu.train.trainer`
(``TrainState``, ``Batch``, ``PackedTrainBatch``, ``_per_example_loss``,
``_loss_fn``, ``_packed_loss_fn``, ``_update_step``,
``make_packed_train_step``, ``make_train_step``, ``init_state``;
``trainer.py:25-127, 159-165``), in torch idiom:

- the state holds the model, whose float32 ``nn.Parameter``\\ s are the
  params, and a ``torch.optim.Optimizer``, whose state is optax's
  ``opt_state``.  A step updates both in place and returns a new
  :class:`TrainState` that shares them, with the step advanced (JAX
  returns new trees);
- the matmuls run in ``cfg.dtype``: :func:`svoc_torch.models.encoder.dense`
  casts each parameter per call, as flax's ``Dense(dtype=...)`` does;
- the model's ``cfg.attention`` picks the attention, so the caller who
  builds the model picks it: ``"flash"`` trains through
  :class:`svoc_torch.ops.flash_attention.FlashAttentionFunction` (the dq
  and dk/dv kernels on CUDA, the plain backward on the CPU), ``"dense"``
  through autograd of the plain einsum chain; ``cfg.remat`` reruns each
  block's forward inside the backward;
- the optimizer is the caller's, as ``tx`` is in JAX: a :data:`Tx` maps
  the parameters to an optimizer, and :func:`adamw`, :func:`adam` and
  :func:`sgd` give optax's defaults.  The step factories take neither
  model nor ``tx``: the state carries both;
- the metrics stay on the device: a step never waits for the host.

Not ported yet: the sharded, ZeRO-1 and sequence-parallel factories
(``trainer.py:130-156, 168-344``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from svoc_torch.device import resolve_device

#: ``tx``: the model's parameters → its optimizer.
Tx = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


def adamw(lr: float) -> Tx:
    """``optax.adamw(lr)``: betas (0.9, 0.999), eps 1e-8 and a decoupled
    weight decay of 1e-4 on every parameter (optax applies it with no
    mask)."""
    return functools.partial(
        torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


def adam(lr: float) -> Tx:
    """``optax.adam(lr)``: betas (0.9, 0.999), eps 1e-8."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def sgd(lr: float, momentum: "float | None" = None) -> Tx:
    """``optax.sgd(lr, momentum)``: heavy-ball momentum, no dampening."""
    return functools.partial(torch.optim.SGD, lr=lr, momentum=momentum or 0.0)


class TrainState(NamedTuple):
    step: int
    model: nn.Module  #: holds the float32 parameters
    optimizer: torch.optim.Optimizer


class Batch(NamedTuple):
    ids: torch.Tensor  #: [B, T] int
    mask: torch.Tensor  #: [B, T] int
    labels: torch.Tensor  #: [B, n_labels] float (multi-hot) or [B] int


class PackedTrainBatch(NamedTuple):
    """Sequence-packed fine-tuning batch (:mod:`svoc_torch.models.packing`
    shapes; ``labels`` through
    :func:`svoc_torch.models.packing.pack_labels`)."""

    ids: torch.Tensor  #: [R, T] int
    pos: torch.Tensor  #: [R, T] int
    seg: torch.Tensor  #: [R, T] int
    cls_pos: torch.Tensor  #: [R, S] int
    seg_valid: torch.Tensor  #: [R, S] int
    labels: torch.Tensor  #: [R, S, n_labels] float (multi-hot) or [R, S] int


def per_example_loss(head: str, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Multi-label BCE summed over labels (``"sigmoid"``, as
    ``optax.sigmoid_binary_cross_entropy``) or integer softmax CE (as
    ``optax.softmax_cross_entropy_with_integer_labels``); shape
    ``logits.shape[:-1]``."""
    if head == "sigmoid":
        return F.binary_cross_entropy_with_logits(
            logits, labels.to(logits.dtype), reduction="none"
        ).sum(dim=-1)
    n_labels = logits.shape[-1]
    return F.cross_entropy(
        logits.reshape(-1, n_labels), labels.reshape(-1).long(), reduction="none"
    ).reshape(labels.shape)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the l2 norm over every element of every
    tensor, as a 0-d fp32 tensor on their device."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


def _loss_fn(model: nn.Module, batch: Batch) -> torch.Tensor:
    logits = model(batch.ids, batch.mask)
    return per_example_loss(model.cfg.head, logits, batch.labels).mean()


def _packed_loss_fn(model: nn.Module, batch: PackedTrainBatch) -> torch.Tensor:
    """Per-segment loss over valid segments only, normalized by their
    count: the unpacked batch mean over the same comments."""
    logits = model(batch.ids, batch.pos, batch.seg, batch.cls_pos)  # [R, S, L]
    per_seg = per_example_loss(model.cfg.head, logits, batch.labels)
    w = batch.seg_valid.float()
    return (per_seg * w).sum() / torch.clamp(w.sum(), min=1.0)


StepFn = Callable[[TrainState, "Batch | PackedTrainBatch"], Tuple[TrainState, Dict]]


def _update_step(loss_fn) -> StepFn:
    """``(state, batch) → (state, {"loss", "grad_norm"})`` around a
    ``loss_fn(model, batch)``."""

    def step_fn(state: TrainState, batch):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch)
        loss.backward()
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
        state.optimizer.step()
        return TrainState(state.step + 1, state.model, state.optimizer), metrics

    return step_fn


def make_train_step() -> StepFn:
    """The unpacked step: ``state.model`` is a :class:`SentimentEncoder`
    and the batch a :class:`Batch`."""
    return _update_step(_loss_fn)


def make_packed_train_step() -> StepFn:
    """The packed fine-tune step: ``state.model`` is a
    :class:`PackedSentimentEncoder` (the same parameters as the unpacked
    model) and the batch a :class:`PackedTrainBatch`; the loss is the
    mean over valid segments."""
    return _update_step(_packed_loss_fn)


def init_state(
    model: nn.Module, params: Mapping[str, torch.Tensor], tx: Tx, device=None
) -> TrainState:
    """Step 0: ``model`` (built on any device, ``meta`` included) takes
    float32 copies of ``params`` on ``device`` as its parameters, and the
    optimizer is ``tx(model.parameters())``."""
    # float32 matmuls (the head's last projection, and every matmul of a
    # float32 config) stay full float32 on the card, as XLA's are: with
    # TF32 the card's steps would drift from the CPU's.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(device)
    model.load_state_dict(
        {k: v.detach().to(device, torch.float32, copy=True) for k, v in params.items()},
        assign=True,
    )
    return TrainState(0, model, tx(model.parameters()))
