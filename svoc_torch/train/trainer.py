"""Fine-tune steps for :class:`SentimentEncoder` and its packed twin, on
one device and on a mesh.

Mirrors :mod:`svoc_tpu.train.trainer`: the one-device part
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

And the mesh factories (``trainer.py:130-156, 168-344``):
:func:`make_sp_train_step` (the sequence-parallel forward of
:mod:`svoc_torch.parallel.sp_encoder`, dense only), and
:func:`make_sharded_train_step` and :func:`make_sharded_packed_train_step`
(tensor parallelism over ``model`` in the Megatron layout of
:func:`svoc_torch.models.encoder.param_shardings`, data parallelism over
``data``, optionally ZeRO-1), each returning ``(train_step, shard_state,
batch_sharding)``.  The reference jits one GSPMD program and lets XLA
insert the collectives; here the step runs a body on every slot of the
single-controller mesh (:func:`svoc_torch.parallel.sharded.shard_map`)
with the model axis's all-reduces as ``psum``, and takes one autograd
backward through every slot.  A :class:`ShardedTrainState` keeps each
tensor as one piece a slot on the slot's device, so
:func:`max_shard_fraction` reads the largest physical piece, as the
reference reads ``addressable_shards``.  The update is the unsharded
step's: one optimizer of the host state's class and hyperparameters runs
on every slot's pieces or slices, and torch's optimizers are
elementwise.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from svoc_torch.device import resolve_device
from svoc_torch.parallel.mesh import Mesh, NamedSharding, P, ShardedArray

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


def make_sp_train_step(cfg, mesh, seq_axis: str = "seq") -> StepFn:
    """The long-context step (``trainer.py:130-156``): the
    sequence-parallel forward (:mod:`svoc_torch.parallel.sp_encoder`, T
    split over ``seq_axis``, parameters replicated) differentiated end to
    end, then the state's optimizer.  ``state.model`` holds the
    parameters the forward reads.  Dense attention only: the flash
    inner's lse carries no gradient, so a flash config raises, as in the
    reference."""
    from svoc_torch.parallel.sp_encoder import sequence_parallel_forward_fn

    if cfg.attention != "dense":
        raise ValueError(
            "sequence-parallel training needs attention='dense': the ring's flash inner is inference only "
            f"(got {cfg.attention!r})"
        )
    sp_fwd = sequence_parallel_forward_fn(mesh, cfg, seq_axis=seq_axis)

    def loss_fn(model: nn.Module, batch: Batch) -> torch.Tensor:
        logits = sp_fwd(dict(model.named_parameters()), batch.ids, batch.mask)
        return per_example_loss(cfg.head, logits, batch.labels.to(logits.device)).mean()

    return _update_step(loss_fn)


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


# ---------------------------------------------------------------------------
# The mesh factories: tensor parallelism over "model", data parallelism over
# "data", and ZeRO-1
# ---------------------------------------------------------------------------


class ShardedTrainState(NamedTuple):
    """A :class:`TrainState` placed on a mesh by a factory's
    ``shard_state``.  Every tensor is a
    :class:`~svoc_torch.parallel.mesh.ShardedArray`, one piece a slot on
    the slot's device:

    - ``params``: the model's parameters in the Megatron layout of
      :func:`svoc_torch.models.encoder.param_shardings`; each piece is an
      autograd leaf, which the step's forward reads;
    - ``masters``: what the optimizer updates: the parameter itself
      (``masters[k] is params[k]``), or under ZeRO-1 each slot's ``1/D``
      slice of its piece along the first free dimension that divides
      (:func:`_zero1_spec`), copied back into every piece after a step;
    - ``optimizer``: one optimizer of the host state's class and
      hyperparameters over every slot's master pieces.  torch's
      optimizers are elementwise and keep their state by tensor, so a
      piece's moments lie beside it, placed as the masters are
      (:attr:`opt_state`).

    ``model_cls`` and ``cfg`` rebuild the module when the state is
    gathered whole (:func:`unshard_state`).  A step updates the pieces in
    place and returns a state that shares them, with the step advanced."""

    step: int
    params: Dict[str, ShardedArray]
    masters: Dict[str, ShardedArray]
    optimizer: torch.optim.Optimizer
    model_cls: type
    cfg: object

    @property
    def opt_state(self) -> Dict[str, Dict[str, ShardedArray]]:
        """Each parameter's optimizer tensors of its shape (Adam's
        ``exp_avg`` and ``exp_avg_sq``, SGD's ``momentum_buffer``), a
        piece a slot, placed as the masters are; empty before a fresh
        state's first step.  Step counts are left out."""
        out: Dict[str, Dict[str, ShardedArray]] = {}
        state = self.optimizer.state
        for name, master in self.masters.items():
            first = next(iter(master.pieces.values()))
            for key, value in state.get(first, {}).items():
                if isinstance(value, torch.Tensor) and value.shape == first.shape:
                    pieces = {k: state[piece][key] for k, piece in master.pieces.items()}
                    out.setdefault(name, {})[key] = ShardedArray(master.sharding, master.shape, pieces)
        return out


def max_shard_fraction(arr: ShardedArray) -> float:
    """The largest piece of ``arr`` as a fraction of its whole size: 1.0
    when replicated, about ``1/D`` when split ``D`` ways
    (``trainer.py:210``, which reads ``addressable_shards``)."""
    return max(piece.numel() for piece in arr.addressable_shards) / arr.size


def _zero1_spec(spec: P, shape, data_axis: str, data_size: int) -> P:
    """``spec`` with ``data_axis`` on the first dimension it leaves free
    whose size divides by ``data_size`` (``trainer.py:218``): ZeRO-1's
    split of the optimizer state.  A leaf with no such dimension keeps
    its spec, replicated over the data axis."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (axis, size) in enumerate(zip(parts, shape)):
        if axis is None and size > 0 and size % data_size == 0:
            parts[i] = data_axis
            return P(*parts)
    return spec


def _opt_state_shardings(p_shard: Dict[str, NamedSharding], params_template: Mapping[str, torch.Tensor],
                         zero1_axis=None) -> Dict[str, NamedSharding]:
    """Where each parameter's optimizer state lives (``trainer.py:233``):
    as the parameter, or with ``zero1_axis`` also split over that axis
    (:func:`_zero1_spec`).  torch's optimizers key their state by
    parameter, so the reference's match by tree-path suffix is a match
    by name."""
    out = {}
    for name, sharding in p_shard.items():
        mesh = sharding.mesh
        spec = sharding.spec
        if zero1_axis is not None and mesh.shape[zero1_axis] > 1 and params_template[name].dim() > 0:
            spec = _zero1_spec(spec, params_template[name].shape, zero1_axis, mesh.shape[zero1_axis])
        out[name] = NamedSharding(mesh, spec)
    return out


def _megatron_dense(model_axis: str):
    """``dense_fn`` of a model shard's block.  A row-split projection
    (marked ``row_split``) adds its partial products over ``model_axis``
    in float32, then its bias once.  A column-split one computes the
    shard's columns with the shard's slice of its replicated bias (the
    slice the reference's GSPMD partitioner takes)."""
    from svoc_torch.parallel.sharded import axis_index, psum

    def dense_fn(x, p, dtype):
        weight, bias = p["weight"], p["bias"]
        if p.get("row_split"):
            partial = F.linear(x.to(dtype), weight.to(dtype)).float()
            return (psum(partial, model_axis) + bias.float()).to(dtype)
        if bias.shape[0] != weight.shape[0]:
            n = weight.shape[0]
            bias = bias.narrow(0, axis_index(model_axis) * n, n)
        return F.linear(x.to(dtype), weight.to(dtype), bias.to(dtype))

    return dense_fn


def _shard_tree(params_local: Mapping[str, torch.Tensor], cfg):
    """A slot's pieces as the nested tree of ``encoder_math``, with the
    row-split projections marked."""
    from svoc_torch.parallel.encoder_math import param_tree

    tree = param_tree(params_local)
    for i in range(cfg.n_layers):
        block = tree[f"block_{i}"]
        block["attention"]["out"] = dict(block["attention"]["out"], row_split=True)
        block["ffn_out"] = dict(block["ffn_out"], row_split=True)
    return tree


def _tp_body(cfg, model_axis: str):
    """The unpacked forward on a model shard: ``(params, ids, mask) →
    logits``.  Each slot holds ``n_heads / M`` heads and ``1/M`` of the
    FFN; the attention (dense, or B1 with B4 and B5 through
    ``FlashAttentionFunction``) runs on the shard's heads."""
    from svoc_torch.parallel.encoder_math import cls_head, embed_tokens, encoder_block, local_position_ids

    dense_fn = _megatron_dense(model_axis)

    def body(params_local, ids, mask):
        p = _shard_tree(params_local, cfg)
        x = embed_tokens(ids, local_position_ids(mask, cfg), p, cfg)
        for i in range(cfg.n_layers):
            x = encoder_block(x, mask, p[f"block_{i}"], cfg, dense_fn=dense_fn)
        return cls_head(x[:, 0, :].to(cfg.dtype), p, cfg)

    return body


def _tp_packed_body(cfg, model_axis: str):
    """The packed forward on a model shard: ``(params, ids, pos, seg,
    cls_pos) → logits [R, S, n_labels]``, attention kept to the block
    diagonal of ``seg``."""
    from svoc_torch.ops.dense_attention import block_diagonal_bias, dense_attention
    from svoc_torch.ops.flash_attention import flash_attention
    from svoc_torch.parallel.encoder_math import cls_head, embed_tokens, encoder_block

    dense_fn = _megatron_dense(model_axis)

    def body(params_local, ids, pos, seg, cls_pos):
        p = _shard_tree(params_local, cfg)
        if cfg.attention == "flash":
            attention = lambda q, k, v, _seg: flash_attention(q, k, v, segment_ids=seg)  # noqa: E731
        else:
            bias = block_diagonal_bias(seg)
            attention = lambda q, k, v, _seg: dense_attention(q, k, v, bias, cfg.dtype)  # noqa: E731
        x = embed_tokens(ids, pos, p, cfg)
        for i in range(cfg.n_layers):
            x = encoder_block(x, seg, p[f"block_{i}"], cfg, attention_fn=attention, dense_fn=dense_fn)
        index = cls_pos.long()[:, :, None].expand(-1, -1, cfg.hidden)
        return cls_head(torch.gather(x, 1, index).to(cfg.dtype), p, cfg)

    return body


def _sharded_factory(cfg, body, batch_specs: Tuple, inputs_of, loss_of, mesh: Mesh, *, params_template,
                     model_axis: str, data_axis: str, zero1_axis=None):
    """The shared wiring (``trainer.py:279``): the parameters in the
    Megatron layout, the optimizer state as :func:`_opt_state_shardings`
    places it, ``body`` run on every slot with the batch split over
    ``data_axis``.

    A step: the forward on every slot; the logits assembled from the
    slots at model index 0 (an output spec that leaves the model axis
    out takes them there), so the value every model slot computes enters
    the loss once; the loss on the mesh's first slot's device, and one
    autograd backward through every slot.  A parameter's gradient is the
    sum over the slots that hold its piece: over the data axis, and over
    the model axis too for a replicated parameter, whose copy on each
    model slot took part of the forward.  The optimizer then updates
    every master from its slice of that sum, and under ZeRO-1 every piece
    is rebuilt from its data group's slices: the ZeRO-1 gather."""
    from svoc_torch.models.encoder import param_shardings
    from svoc_torch.parallel.mesh import slot_keys
    from svoc_torch.parallel.sharded import shard_map

    model_size = mesh.shape[model_axis]
    if cfg.n_heads % model_size or cfg.intermediate % model_size:
        raise ValueError(f"a model axis of {model_size} does not divide {cfg.n_heads} heads and "
                         f"{cfg.intermediate} FFN features: a model shard holds whole heads")
    p_shard = param_shardings(params_template, mesh, model_axis=model_axis)
    o_shard = _opt_state_shardings(p_shard, params_template, zero1_axis)
    names = list(p_shard)
    keys = slot_keys(mesh)
    axis_pos = {a: i for i, a in enumerate(mesh.axis_names)}
    mapped = shard_map(body, mesh=mesh, in_specs=({k: s.spec for k, s in p_shard.items()},) + batch_specs,
                       out_specs=P(data_axis))

    def zero1_dim(name: str):
        spec = tuple(o_shard[name].spec)
        return spec.index(zero1_axis) if zero1_axis is not None and zero1_axis in spec else None

    split = {name: zero1_dim(name) for name in names}
    named_axes = {name: [axis_pos[a] for a in p_shard[name].spec if a is not None] for name in names}

    def shard_state(state: TrainState) -> ShardedTrainState:
        named = dict(state.model.named_parameters())
        if set(named) != set(names):
            raise ValueError("the state's parameters are not those of params_template")
        host = state.optimizer
        if len(host.param_groups) != 1:
            raise ValueError("a sharded state takes an optimizer of one parameter group")
        group = {k: v for k, v in host.param_groups[0].items() if k != "params"}
        params = {k: ShardedArray.put(named[k], p_shard[k], requires_grad=True) for k in names}
        masters = {k: params[k] if split[k] is None else ShardedArray.put(named[k], o_shard[k], requires_grad=True)
                   for k in names}
        optimizer = type(host)([masters[k].pieces[key] for key in keys for k in names], lr=group["lr"])
        optimizer.param_groups[0].update(group)
        for name in names:
            saved = host.state.get(named[name], {})
            for key, piece in masters[name].pieces.items() if saved else ():
                coords = dict(zip(mesh.axis_names, key))
                optimizer.state[piece] = {
                    sk: (o_shard[name].local(sv, coords).clone()
                         if isinstance(sv, torch.Tensor) and sv.shape == named[name].shape
                         else sv.clone() if isinstance(sv, torch.Tensor) else sv)
                    for sk, sv in saved.items()
                }
        return ShardedTrainState(state.step, params, masters, optimizer, type(state.model), state.model.cfg)

    def reduced_grads(params: Dict[str, ShardedArray]) -> Dict[Tuple, torch.Tensor]:
        """Each distinct piece's gradient, keyed by ``(name, its
        coordinates along the axes its spec names)``: the sum, in slot
        order, over the slots that hold it (one multi-tensor add a slot;
        the first slot's gradient takes the sum in place), zeros for a
        piece no forward reached."""
        sums: Dict[Tuple, torch.Tensor] = {}
        for key in keys:
            targets, grads = [], []
            for name in names:
                grad = params[name].pieces[key].grad
                if grad is None:
                    continue
                group = (name, tuple(key[i] for i in named_axes[name]))
                if group in sums:
                    targets.append(sums[group])
                    grads.append(grad.to(sums[group].device))
                else:
                    sums[group] = grad.to(mesh.controller)
            if targets:
                torch._foreach_add_(targets, grads)
        for name in names:
            for key, piece in params[name].pieces.items():
                group = (name, tuple(key[i] for i in named_axes[name]))
                if group not in sums:
                    sums[group] = torch.zeros_like(piece, device=mesh.controller)
        return sums

    def train_step(state: ShardedTrainState, batch):
        for arr in state.params.values():
            for piece in arr.pieces.values():
                piece.grad = None
        logits = mapped(state.params, *inputs_of(batch))
        loss = loss_of(logits, batch)
        loss.backward()
        sums = reduced_grads(state.params)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(sums.values()))))
        metrics = {"loss": loss.detach(), "grad_norm": norm}
        d = axis_pos.get(zero1_axis)
        for name in names:
            z = split[name]
            for key, leaf in state.masters[name].pieces.items():
                grad = sums[(name, tuple(key[i] for i in named_axes[name]))]
                if z is not None:
                    chunk = leaf.shape[z]
                    grad = grad.narrow(z, key[d] * chunk, chunk).contiguous()
                leaf.grad = grad.to(leaf.device)
        state.optimizer.step()
        with torch.no_grad():
            # The ZeRO-1 gather: the first piece of each data group joins
            # the group's slices, and the others copy it (one multi-tensor
            # copy).
            dsts, srcs = [], []
            for name in names:
                z = split[name]
                if z is None:
                    continue
                masters, joined = state.masters[name].pieces, {}
                for key, piece in state.params[name].pieces.items():
                    group = key[:d] + key[d + 1:]
                    if group in joined:
                        dsts.append(piece)
                        srcs.append(joined[group].to(piece.device))
                        continue
                    owners = [masters[key[:d] + (i,) + key[d + 1:]] for i in range(mesh.shape[zero1_axis])]
                    torch.cat([o.to(piece.device) for o in owners], dim=z, out=piece)
                    joined[group] = piece
            if dsts:
                torch._foreach_copy_(dsts, srcs)
        state.optimizer.zero_grad(set_to_none=True)
        for arr in state.params.values():
            for piece in arr.pieces.values():
                piece.grad = None
        return state._replace(step=state.step + 1), metrics

    return train_step, shard_state


def make_sharded_train_step(cfg, mesh: Mesh, *, params_template: Mapping[str, torch.Tensor],
                            data_axis: str = "data", model_axis: str = "model", zero1: bool = False):
    """The step over a ``data × model`` mesh (``trainer.py:168``):
    ``(train_step, shard_state, batch_sharding)``.

    - ``train_step(state, batch)``: a :class:`ShardedTrainState` and a
      :class:`Batch` → the next state and ``{"loss", "grad_norm"}``, the
      update math of the unsharded step (the same optimizer, on slices);
    - ``shard_state(state)``: a :class:`TrainState` (fresh, or restored
      from a checkpoint, its moments included) placed on the mesh;
    - ``batch_sharding``: where a batch's tensors go (the step splits
      them itself).

    ``cfg.attention == "flash"`` runs B1, B4 and B5 on each model shard's
    heads through ``FlashAttentionFunction``.  ``zero1`` also splits the
    optimizer state over ``data_axis`` (ZeRO stage 1, arXiv:2004.13336):
    at rest each slot holds about ``1/D`` of it, and updates that slice
    of the weights.  ``params_template`` is a state dict of the model
    (its names and shapes).  The blocks are never rematerialized here."""
    from svoc_torch.models.encoder import check_attention

    check_attention(cfg)
    batch_sharding = Batch(ids=NamedSharding(mesh, P(data_axis, None)), mask=NamedSharding(mesh, P(data_axis, None)),
                           labels=NamedSharding(mesh, P(data_axis)))

    def loss_of(logits, batch: Batch):
        return per_example_loss(cfg.head, logits, batch.labels.to(logits.device)).mean()

    step, shard_state = _sharded_factory(
        cfg, _tp_body(cfg, model_axis), (P(data_axis, None),) * 2, lambda b: (b.ids, b.mask), loss_of, mesh,
        params_template=params_template, model_axis=model_axis, data_axis=data_axis,
        zero1_axis=data_axis if zero1 else None)
    return step, shard_state, batch_sharding


def make_sharded_packed_train_step(cfg, mesh: Mesh, *, params_template: Mapping[str, torch.Tensor],
                                   data_axis: str = "data", model_axis: str = "model", zero1: bool = False):
    """The packed twin of :func:`make_sharded_train_step`
    (``trainer.py:315``): rows split over ``data_axis``, the same
    parameter layout, a :class:`PackedTrainBatch` a step, the loss the
    mean over valid segments."""
    from svoc_torch.models.encoder import check_attention

    check_attention(cfg)
    row = NamedSharding(mesh, P(data_axis, None))
    batch_sharding = PackedTrainBatch(ids=row, pos=row, seg=row, cls_pos=row, seg_valid=row,
                                      labels=NamedSharding(mesh, P(data_axis)))

    def loss_of(logits, batch: PackedTrainBatch):
        per_seg = per_example_loss(cfg.head, logits, batch.labels.to(logits.device))
        w = batch.seg_valid.to(logits.device).float()
        return (per_seg * w).sum() / torch.clamp(w.sum(), min=1.0)

    step, shard_state = _sharded_factory(
        cfg, _tp_packed_body(cfg, model_axis), (P(data_axis, None),) * 4, lambda b: (b.ids, b.pos, b.seg, b.cls_pos),
        loss_of, mesh, params_template=params_template, model_axis=model_axis, data_axis=data_axis,
        zero1_axis=data_axis if zero1 else None)
    return step, shard_state, batch_sharding


def unshard_state(state: ShardedTrainState) -> TrainState:
    """The whole :class:`TrainState` on the mesh's first slot's device:
    a fresh ``model_cls(cfg)`` holding the gathered parameters, and an
    optimizer of the same class and hyperparameters holding the gathered
    moments and the step counts."""
    whole = {name: master.gather().clone() for name, master in state.masters.items()}
    with torch.device("meta"):
        model = state.model_cls(state.cfg)
    model.load_state_dict(whole, assign=True)
    group = {k: v for k, v in state.optimizer.param_groups[0].items() if k != "params"}
    named = dict(model.named_parameters())
    optimizer = type(state.optimizer)(model.parameters(), lr=group["lr"])
    optimizer.param_groups[0].update(group)
    moments = state.opt_state
    for name, master in state.masters.items():
        saved = state.optimizer.state.get(next(iter(master.pieces.values())), {})
        if saved:
            optimizer.state[named[name]] = {
                key: (moments[name][key].gather().clone() if key in moments.get(name, {})
                      else value.clone() if isinstance(value, torch.Tensor) else value)
                for key, value in saved.items()
            }
    return TrainState(state.step, model, optimizer)
