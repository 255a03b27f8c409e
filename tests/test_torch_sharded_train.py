"""The port's tensor-parallel, data-parallel and ZeRO-1 train steps against the JAX package's, on the CPU.

Twin of ``tests/test_train.py``'s sharded tests: TINY_TEST weights from
the flax init carried across by ``params_from_flax``; the reference's
GSPMD steps run on its 8 simulated CPU devices as a ``data(4) ×
model(2)`` mesh, the port's on 8 CPU slots of the same mesh, on the same
seeded numpy batches.  Bars are the reference's: the sharded step's
loss rtol 2e-4 and parameters 2e-4 (SGD, three steps); ZeRO-1's
parameters 2e-3 (SGD with momentum) with every moment leaf it can split
at most 1/4 of its whole on a slot; the sharded packed and flash steps
2e-5 of the reference's sharded steps and of the unsharded step.  ``param_shardings`` gives the reference's
spec for every leaf, transposed with the weight.  A sharded state saved
whole restores onto a ``data(2) × model(4)`` mesh with its values
exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from svoc_tpu.models.configs import TINY_TEST as REF_TINY  # noqa: E402
from svoc_tpu.models.encoder import SentimentEncoder as RefEncoder  # noqa: E402
from svoc_tpu.models.encoder import init_params as ref_init_params  # noqa: E402
from svoc_tpu.models.encoder import param_shardings as ref_param_shardings  # noqa: E402
from svoc_tpu.parallel.mesh import MeshSpec as RefMeshSpec  # noqa: E402
from svoc_tpu.parallel.mesh import make_mesh as ref_make_mesh  # noqa: E402
from svoc_tpu.train import trainer as jt  # noqa: E402

from svoc_torch.models.configs import TINY_TEST  # noqa: E402
from svoc_torch.models.encoder import SentimentEncoder, param_shardings  # noqa: E402
from svoc_torch.models.from_jax import params_from_flax  # noqa: E402
from svoc_torch.models.packing import PackedSentimentEncoder, pack_labels, pack_tokens_auto  # noqa: E402
from svoc_torch.parallel.mesh import MeshSpec, P, make_mesh  # noqa: E402
from svoc_torch.train.trainer import (  # noqa: E402
    Batch,
    PackedTrainBatch,
    ShardedTrainState,
    adamw,
    init_state,
    make_packed_train_step,
    make_sharded_packed_train_step,
    make_sharded_train_step,
    make_train_step,
    max_shard_fraction,
    sgd,
    unshard_state,
)
from svoc_torch.utils.checkpoint import restore_train_state, save_train_state  # noqa: E402


@pytest.fixture(scope="module")
def flax_params():
    return ref_init_params(RefEncoder(REF_TINY), seed=0)


@pytest.fixture(scope="module")
def params(flax_params):
    return params_from_flax(flax_params)


def mesh(data=4, model=2):
    return make_mesh(MeshSpec(("data", "model"), (data, model)), device="cpu")


def ref_mesh(data=4, model=2):
    return ref_make_mesh(RefMeshSpec(("data", "model"), (data, model)))


def arrays(seed, b=8, t=16, cfg=TINY_TEST):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.vocab_size, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, 9:] = 0
    mask[5, 3:] = 0
    labels = (rng.random((b, cfg.n_labels)) < 0.3).astype(np.float32)
    return ids, mask, labels


def torch_batch(a):
    return Batch(*(torch.from_numpy(x) for x in a))


def fresh(params, tx, cfg=TINY_TEST, cls=SentimentEncoder):
    with torch.device("meta"):
        model = cls(cfg)
    return init_state(model, params, tx, device="cpu")


def whole(state: ShardedTrainState):
    return {name: arr.gather() for name, arr in state.params.items()}


def ref_specs(flax_params):
    """The reference's spec of every leaf, under the port's name (a
    flax ``kernel`` is the port's ``weight``, ``scale`` a LayerNorm's
    ``weight``, ``embedding`` an embedding's)."""
    out = {}
    leaf_names = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}
    shardings = ref_param_shardings(flax_params, ref_mesh())
    for path, sharding in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        keys = [p.key for p in path][1:]  # past "params"
        out[".".join(keys[:-1] + [leaf_names[keys[-1]]])] = tuple(sharding.spec)
    return out


def test_param_shardings_are_the_references_leaf_by_leaf(flax_params, params):
    """The port's weight is flax's kernel transposed, so a split kernel's
    spec comes out reversed; every other leaf is replicated in both."""
    specs = param_shardings(params, mesh())
    ref = ref_specs(flax_params)
    assert set(ref) == set(specs)
    split = 0
    for name, sharding in specs.items():
        ours, theirs = tuple(sharding.spec), ref[name]
        if "model" in theirs:
            assert ours == tuple(reversed(theirs)), name
            split += 1
        else:
            assert ours == (), (name, ours, theirs)
    # Four column-split and two row-split weights a block.
    assert split == 6 * TINY_TEST.n_layers
    assert specs["block_0.attention.query.weight"].spec == P("model", None)
    assert specs["block_1.attention.out.weight"].spec == P(None, "model")
    assert specs["block_0.ffn_in.bias"].spec == P() and specs["tok_emb.weight"].spec == P()


@pytest.mark.parametrize("zero1", [False, True])
def test_sharded_step_matches_the_references_and_the_unsharded_step(flax_params, params, zero1):
    """Three steps on 4×2: SGD(0.1) at the reference's 2e-4, or
    SGD(0.1, momentum 0.9) under ZeRO-1 at its 2e-3, where every moment
    leaf with a dimension that divides by 4 holds at most 1/4 of its
    whole on a slot."""
    a = arrays(1)
    tx, ref_tx, bar = (sgd(0.1, momentum=0.9), optax.sgd(0.1, momentum=0.9), 2e-3) if zero1 else (
        sgd(0.1), optax.sgd(0.1), 2e-4)
    jbatch = jt.Batch(*(jnp.asarray(x) for x in a))
    ref_step, ref_shard, _ = jt.make_sharded_train_step(RefEncoder(REF_TINY), ref_tx, ref_mesh(),
                                                        params_template=flax_params, zero1=zero1)
    ref_state = ref_shard(jt.init_state(None, flax_params, ref_tx))
    step, shard_state, bshard = make_sharded_train_step(TINY_TEST, mesh(), params_template=params, zero1=zero1)
    assert bshard.ids.spec == P("data", None) and bshard.labels.spec == P("data")
    state = shard_state(fresh(params, tx))
    plain_state, plain_step = fresh(params, tx), make_train_step()
    for _ in range(3):
        ref_state, ref_metrics = ref_step(ref_state, jbatch)
        state, metrics = step(state, torch_batch(a))
        plain_state, plain_metrics = plain_step(plain_state, torch_batch(a))
    assert state.step == 3
    np.testing.assert_allclose(metrics["loss"].item(), float(ref_metrics["loss"]), rtol=2e-4)
    np.testing.assert_allclose(metrics["loss"].item(), plain_metrics["loss"].item(), rtol=2e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(), plain_metrics["grad_norm"].item(), rtol=2e-4)
    ref_params = params_from_flax(ref_state.params)
    plain = dict(plain_state.model.named_parameters())
    for name, value in whole(state).items():
        np.testing.assert_allclose(value.numpy(), ref_params[name].numpy(), atol=bar, err_msg=name)
        np.testing.assert_allclose(value.numpy(), plain[name].detach().numpy(), atol=bar, err_msg=name)
    moments = state.opt_state
    assert set(moments) == set(params) and all(set(m) == {"momentum_buffer"} for m in moments.values()) or not zero1
    if zero1:
        fractions = {name: max_shard_fraction(m["momentum_buffer"]) for name, m in moments.items()}
        for name, frac in fractions.items():
            spec = tuple(moments[name]["momentum_buffer"].spec)
            assert frac <= 0.25 + 1e-9 if "data" in spec else "data" not in spec, (name, spec, frac)
        # Only the position table (66 rows of 64: 64 divides by 4) and
        # the rest all split: every leaf of TINY_TEST has such a dimension.
        assert max(fractions.values()) <= 0.25 + 1e-9
        ref_mu = params_from_flax(ref_state.opt_state[0].trace)
        for name, m in moments.items():
            np.testing.assert_allclose(m["momentum_buffer"].gather().numpy(), ref_mu[name].numpy(), atol=bar)


def test_sharded_packed_and_flash_steps_match_the_references_and_the_unsharded_steps(flax_params, params):
    """One SGD(0.1) step each at the reference's 2e-5: the packed step
    (rows split 4 ways, 2 a slot), dense against the reference's
    ``make_sharded_packed_train_step`` and, with flash too, against the
    port's unsharded packed step; the unpacked flash step (B1, B4 and
    B5's plain versions on each model shard's 2 of the 4 heads) against
    the reference's sharded flash step (its Pallas kernels in interpret
    mode) and the port's unsharded one."""
    rng = np.random.default_rng(0)
    toks = [np.arange(4, 4 + n, dtype=np.int32) for n in rng.integers(3, 8, 40)]
    packed, n = pack_tokens_auto(toks, 16, 4, pad_id=TINY_TEST.pad_id, rows=8)
    labels = (rng.random((n, TINY_TEST.n_labels)) < 0.3).astype(np.float32)
    columns = [np.asarray(x) for x in (packed.ids, packed.pos, packed.seg, packed.cls_pos, packed.seg_valid,
                                       pack_labels(packed, labels))]
    pbatch = PackedTrainBatch(*(torch.from_numpy(x) for x in columns))
    ref_step, ref_shard, ref_bshard = jt.make_sharded_packed_train_step(REF_TINY, optax.sgd(0.1), ref_mesh(),
                                                                        params_template=flax_params)
    ref_state, ref_metrics = ref_step(ref_shard(jt.init_state(None, flax_params, optax.sgd(0.1))),
                                      jax.device_put(jt.PackedTrainBatch(*(jnp.asarray(x) for x in columns)), ref_bshard))
    for attention in ("dense", "flash"):
        cfg = dataclasses.replace(TINY_TEST, attention=attention)
        plain_state, plain_metrics = make_packed_train_step()(fresh(params, sgd(0.1), cfg, PackedSentimentEncoder),
                                                              pbatch)
        step, shard_state, _ = make_sharded_packed_train_step(cfg, mesh(), params_template=params)
        state, metrics = step(shard_state(fresh(params, sgd(0.1), cfg, PackedSentimentEncoder)), pbatch)
        np.testing.assert_allclose(metrics["loss"].item(), plain_metrics["loss"].item(), rtol=2e-4)
        plain = dict(plain_state.model.named_parameters())
        refs = params_from_flax(ref_state.params)
        for name, value in whole(state).items():
            np.testing.assert_allclose(value.numpy(), plain[name].detach().numpy(), atol=2e-5, err_msg=name)
            if attention == "dense":
                np.testing.assert_allclose(value.numpy(), refs[name].numpy(), atol=2e-5, err_msg=name)
        if attention == "dense":
            np.testing.assert_allclose(metrics["loss"].item(), float(ref_metrics["loss"]), rtol=2e-4)
    flash, ref_flash = (dataclasses.replace(c, attention="flash") for c in (TINY_TEST, REF_TINY))
    a = arrays(2)
    ref_step, ref_shard, ref_bshard = jt.make_sharded_train_step(RefEncoder(ref_flash), optax.sgd(0.1), ref_mesh(),
                                                                 params_template=flax_params)
    ref_state, _ = ref_step(ref_shard(jt.init_state(None, flax_params, optax.sgd(0.1))),
                            jax.device_put(jt.Batch(*(jnp.asarray(x) for x in a)), ref_bshard))
    plain_state, _ = make_train_step()(fresh(params, sgd(0.1), flash), torch_batch(a))
    step, shard_state, _ = make_sharded_train_step(flash, mesh(), params_template=params)
    state, _ = step(shard_state(fresh(params, sgd(0.1), flash)), torch_batch(a))
    plain, refs = dict(plain_state.model.named_parameters()), params_from_flax(ref_state.params)
    for name, value in whole(state).items():
        np.testing.assert_allclose(value.numpy(), plain[name].detach().numpy(), atol=2e-5, err_msg=name)
        np.testing.assert_allclose(value.numpy(), refs[name].numpy(), atol=2e-5, err_msg=name)


def test_zero1_adamw_is_the_replicated_update_and_saves_whole_onto_another_mesh(params, tmp_path):
    """AdamW under ZeRO-1 takes the replicated optimizer's steps bit for
    bit (the same elementwise update on slices); a sharded state saved
    whole restores onto data(2) × model(4) with every value equal, and
    the next steps' losses there equal those on 4×2."""
    a, b = arrays(3), arrays(4)
    runs = {}
    for zero1 in (False, True):
        step, shard_state, _ = make_sharded_train_step(TINY_TEST, mesh(), params_template=params, zero1=zero1)
        state = shard_state(fresh(params, adamw(3e-3)))
        for _ in range(2):
            state, _ = step(state, torch_batch(a))
        runs[zero1] = (step, state)
    for name, value in whole(runs[False][1]).items():
        assert torch.equal(value, whole(runs[True][1])[name]), name
    step, state = runs[True]
    path = str(tmp_path / "mid.pt")
    save_train_state(path, state)
    host = unshard_state(state)
    assert host.step == 2 and isinstance(host.model, SentimentEncoder)
    restored = restore_train_state(path, fresh(params, adamw(3e-3)))
    for name, value in restored.model.state_dict().items():
        assert torch.equal(value, whole(state)[name]), name
    step_b, shard_b, _ = make_sharded_train_step(TINY_TEST, mesh(2, 4), params_template=params, zero1=True)
    state_b = shard_b(restored)
    assert state_b.step == 2
    for name, value in whole(state_b).items():
        assert torch.equal(value, whole(state)[name]), name
    for name, m in state_b.opt_state.items():
        for key, arr in m.items():
            assert torch.equal(arr.gather(), state.opt_state[name][key].gather()), (name, key)
    # The losses of the next two steps agree; the parameters are not
    # compared, since Adam turns the float noise of gradients that are
    # zero in exact arithmetic (the key biases') into ±lr.
    for _ in range(2):
        state, m_a = step(state, torch_batch(b))
        state_b, m_b = step_b(state_b, torch_batch(b))
        np.testing.assert_allclose(m_b["loss"].item(), m_a["loss"].item(), rtol=1e-5)


def test_factories_refuse_what_they_cannot_shard(params):
    """An unknown attention, a batch that the data axis does not divide,
    and a model axis that does not divide the heads (a shard holds whole
    heads) each raise; nothing runs unsharded instead."""
    with pytest.raises(ValueError, match="dense"):
        make_sharded_train_step(dataclasses.replace(TINY_TEST, attention="ring"), mesh(), params_template=params)
    step, shard_state, _ = make_sharded_train_step(TINY_TEST, mesh(), params_template=params)
    with pytest.raises(ValueError, match="divide"):
        step(shard_state(fresh(params, sgd(0.1))), torch_batch(arrays(0, b=6)))
    with pytest.raises(ValueError, match="heads"):
        make_sharded_packed_train_step(dataclasses.replace(TINY_TEST, n_heads=2), mesh(2, 4), params_template=params)
