"""The port's fine-tune step against the JAX package's, on the CPU.

TINY_TEST weights come from the flax init and are carried across by
``params_from_flax``; a JAX gradient tree has the parameters' structure,
so it maps the same way.  JAX trains with ``attention="flash"`` (the
Pallas kernels in interpret mode, through their custom VJP); the port
with ``FlashAttentionFunction``'s plain backward.  The bars are those of
``tests/test_train.py``: loss rtol 1e-5 and gradients rtol 2e-3, atol
2e-5 (``:464-470``); one SGD step's parameters atol 2e-5; AdamW losses
over three steps rtol 1e-4, with the parameters not compared, since
Adam's first step turns float noise on near-zero gradients into ±lr
(``:251-256``).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import optax
import torch

from svoc_tpu.models import configs as jax_configs
from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder
from svoc_tpu.models.encoder import init_params as jax_init_params
from svoc_tpu.models.packing import PackedSentimentEncoder as JaxPacked
from svoc_tpu.models.packing import pack_labels as jax_pack_labels
from svoc_tpu.train import trainer as jt

from svoc_torch.models.configs import TINY_TEST
from svoc_torch.models.encoder import SentimentEncoder
from svoc_torch.models.from_jax import params_from_flax
from svoc_torch.models.packing import PackedSentimentEncoder, pack_labels, pack_tokens, strip_padding
from svoc_torch.models.tokenizer import HashingTokenizer
from svoc_torch.train.trainer import (
    Batch,
    PackedTrainBatch,
    _packed_loss_fn,
    adam,
    adamw,
    global_norm,
    init_state,
    make_packed_train_step,
    make_train_step,
    per_example_loss,
    sgd,
)
from svoc_torch.utils.checkpoint import restore_train_state, save_train_state

JCFG = dataclasses.replace(jax_configs.TINY_TEST, attention="flash")
FLASH = dataclasses.replace(TINY_TEST, attention="flash")  # the same choice in the port


@pytest.fixture(scope="module")
def flax_params():
    return jax_init_params(JaxEncoder(jax_configs.TINY_TEST), seed=0)


@pytest.fixture(scope="module")
def batches():
    """Matching numpy (unpacked, packed) batches over the same 12 texts
    and labels, as ``tests/test_train.py::_packed_pair`` makes them."""
    seq = 24
    tok = HashingTokenizer(TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=seq)
    rng = np.random.default_rng(5)
    texts = [
        " ".join(rng.choice(["aa", "bb", "cc", "dd"], size=int(rng.integers(2, 8))))
        for _ in range(12)
    ]
    ids, mask = tok(texts, seq)
    labels = (rng.random((12, TINY_TEST.n_labels)) < 0.3).astype(np.float32)
    pk, n = pack_tokens(strip_padding(ids, mask), seq, 4, pad_id=TINY_TEST.pad_id)
    assert n == 12
    unpacked = (ids, mask, labels)
    packed = (pk.ids, pk.pos, pk.seg, pk.cls_pos, pk.seg_valid, pack_labels(pk, labels))
    return unpacked, packed


def _state(flax_params, cls, tx):
    with torch.device("meta"):
        model = cls(FLASH)
    return init_state(model, params_from_flax(flax_params), tx, device="cpu")


def _torch_batch(kind, arrays):
    return kind(*(torch.from_numpy(np.asarray(a)) for a in arrays))


def _jax_batch(kind, arrays):
    return kind(*(jnp.asarray(a) for a in arrays))


def _assert_params_close(model, flax_tree, atol):
    ref = params_from_flax(flax_tree)
    got = dict(model.named_parameters())
    assert set(got) == set(ref)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=atol, err_msg=name)


def test_packed_loss_and_grads_match_jax(flax_params, batches):
    _, packed = batches
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jt._packed_loss_fn(JaxPacked(JCFG), p, _jax_batch(jt.PackedTrainBatch, packed))
    ))(flax_params)
    state = _state(flax_params, PackedSentimentEncoder, sgd(0.1))
    loss = _packed_loss_fn(state.model, _torch_batch(PackedTrainBatch, packed))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref = params_from_flax(ref_grads)
    for name, p in state.model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=2e-3, atol=2e-5,
                                   err_msg=name)
    assert all(
        state.model.get_submodule(f"block_{i}.attention.{w}").weight.grad.abs().sum() > 0
        for i in range(TINY_TEST.n_layers) for w in ("query", "key", "value")
    )


@pytest.mark.parametrize("packed_step", [True, False], ids=["packed", "unpacked"])
def test_one_sgd_step_matches_jax(flax_params, batches, packed_step):
    unpacked, packed = batches
    if packed_step:
        jstep = jt.make_packed_train_step(JCFG, optax.sgd(0.1))
        jbatch, tbatch = _jax_batch(jt.PackedTrainBatch, packed), _torch_batch(PackedTrainBatch, packed)
        state, step = _state(flax_params, PackedSentimentEncoder, sgd(0.1)), make_packed_train_step()
    else:
        jstep = jt.make_train_step(JaxEncoder(JCFG), optax.sgd(0.1))
        jbatch, tbatch = _jax_batch(jt.Batch, unpacked), _torch_batch(Batch, unpacked)
        state, step = _state(flax_params, SentimentEncoder, sgd(0.1)), make_train_step()
    jstate, jmetrics = jstep(jt.init_state(None, flax_params, optax.sgd(0.1)), jbatch)
    state, metrics = step(state, tbatch)
    assert state.step == int(jstate.step) == 1
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]), rtol=1e-4)
    _assert_params_close(state.model, jstate.params, atol=2e-5)


def test_adamw_losses_match_optax(flax_params, batches):
    _, packed = batches
    jstep = jt.make_packed_train_step(JCFG, optax.adamw(1e-3))
    jstate = jt.init_state(None, flax_params, optax.adamw(1e-3))
    state, step = _state(flax_params, PackedSentimentEncoder, adamw(1e-3)), make_packed_train_step()
    jbatch, tbatch = _jax_batch(jt.PackedTrainBatch, packed), _torch_batch(PackedTrainBatch, packed)
    for _ in range(3):
        jstate, jmetrics = jstep(jstate, jbatch)
        state, metrics = step(state, tbatch)
        np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-4)


def test_train_step_reduces_loss(flax_params):
    """``tests/test_train.py::test_train_step_reduces_loss``: 20 Adam
    steps on one batch take the loss below 0.8 of where it started."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY_TEST.vocab_size, (8, 16)).astype(np.int32)
    labels = (rng.random((8, TINY_TEST.n_labels)) < 0.2).astype(np.float32)
    batch = _torch_batch(Batch, (ids, np.ones((8, 16), np.int32), labels))
    state, step = _state(flax_params, SentimentEncoder, adam(1e-3)), make_train_step()
    losses = []
    for _ in range(20):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    assert losses[-1] < losses[0] * 0.8, losses[:3] + losses[-3:]
    assert state.step == 20


def test_pack_labels_matches_jax():
    """Multi-hot and integer labels, and the empty-labels case, on a
    batch with empty segments and empty rows."""
    rng = np.random.default_rng(1)
    tok = HashingTokenizer(TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=16)
    texts = [" ".join(["ab"] * int(n)) for n in rng.integers(1, 9, 10)]
    pk, _ = pack_tokens(strip_padding(*tok(texts, 16)), 16, 3, pad_id=1, rows=8)
    for labels in (
        (rng.random((10, 5)) < 0.4).astype(np.float32),
        rng.integers(0, 5, 10).astype(np.int32),
        np.zeros((0, 5), np.float32),
    ):
        got = pack_labels(pk, labels)
        ref = jax_pack_labels(pk, labels)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    assert pk.seg_valid[-1].sum() == 0 and (pk.seg_valid == 0).any(axis=1).all()


@pytest.mark.parametrize("head", ["sigmoid", "softmax"])
def test_per_example_loss_matches_optax(head):
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((4, 3, 7))).astype(np.float32)
    if head == "sigmoid":
        labels = (rng.random((4, 3, 7)) < 0.3).astype(np.float32)
    else:
        labels = rng.integers(0, 7, (4, 3)).astype(np.int32)
    ref = jt._per_example_loss(head, jnp.asarray(logits), jnp.asarray(labels))
    got = per_example_loss(head, torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_global_norm_matches_optax():
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 5))]
    ref = optax.global_norm([jnp.asarray(a) for a in arrays])
    got = global_norm([torch.from_numpy(a) for a in arrays])
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_save_restore_replays_exactly(flax_params, batches, tmp_path):
    """Two AdamW steps, a checkpoint, one more step; the checkpoint
    restored onto a fresh state and stepped once gives the same
    parameters bit for bit."""
    _, packed = batches
    tbatch = _torch_batch(PackedTrainBatch, packed)
    step = make_packed_train_step()
    state = _state(flax_params, PackedSentimentEncoder, adamw(1e-3))
    for _ in range(2):
        state, _ = step(state, tbatch)
    save_train_state(str(tmp_path / "state.pt"), state)
    state, metrics = step(state, tbatch)

    template = _state(flax_params, PackedSentimentEncoder, adamw(1e-3))
    restored = restore_train_state(str(tmp_path / "state.pt"), template)
    assert restored.step == 2
    restored, replay = step(restored, tbatch)
    assert restored.step == state.step == 3
    assert torch.equal(replay["loss"], metrics["loss"])
    ref = dict(state.model.named_parameters())
    for name, p in restored.model.named_parameters():
        assert torch.equal(p, ref[name]), name
