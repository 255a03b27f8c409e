"""The port's sequence-parallel encoder and its train step against the JAX package's, on the CPU.

Twin of ``tests/test_sp_encoder.py`` and of ``tests/test_train.py``'s
sequence-parallel tests: TINY_TEST weights from the flax init carried
across by ``params_from_flax``; the reference runs on its 8 simulated
CPU devices, the port on 8 CPU slots of a ``seq`` mesh, on the same
seeded numpy ids.  Bars are the reference's: logits 2e-4 (the flash
inner too), gradients 5e-5, the SP step's loss rtol 1e-4 and parameters
5e-5; a flash SP trainer is refused.
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
from svoc_tpu.parallel.mesh import MeshSpec as RefMeshSpec  # noqa: E402
from svoc_tpu.parallel.mesh import make_mesh as ref_make_mesh  # noqa: E402
from svoc_tpu.parallel.sp_encoder import sequence_parallel_forward_fn as ref_sp_forward  # noqa: E402
from svoc_tpu.train import trainer as jt  # noqa: E402

from svoc_torch.models.configs import TINY_TEST  # noqa: E402
from svoc_torch.models.encoder import SentimentEncoder, load_encoder  # noqa: E402
from svoc_torch.models.from_jax import params_from_flax  # noqa: E402
from svoc_torch.parallel.mesh import MeshSpec, make_mesh  # noqa: E402
from svoc_torch.parallel.sp_encoder import sequence_parallel_forward_fn  # noqa: E402
from svoc_torch.train.trainer import Batch, init_state, make_sp_train_step, make_train_step, sgd  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    flax_params = ref_init_params(RefEncoder(REF_TINY), seed=0)
    mesh = make_mesh(MeshSpec(("seq",), (8,)), device="cpu")
    ref_mesh = ref_make_mesh(RefMeshSpec(("seq",), (8,)))
    return flax_params, params_from_flax(flax_params), mesh, ref_mesh


def batch(seed, b=2, t=64, lengths=None):
    ids = np.random.default_rng(seed).integers(4, TINY_TEST.vocab_size, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    for i, n in enumerate(lengths or ()):
        mask[i, n:] = 0
        ids[i, n:] = TINY_TEST.pad_id
    return ids, mask


@pytest.mark.parametrize("case", ["full", "padding", "one_token_a_shard_beyond_one_block", "flash"])
def test_sp_forward_matches_the_reference_and_the_unsharded_encoder(setup, case):
    """Padding that spans shard boundaries (the global position ids and
    the ring's masks); ``max_len`` tokens; the flash inner (B1's plain
    version once a hop) against the reference's dense-inner SP forward
    and its flax encoder."""
    flax_params, params, mesh, ref_mesh = setup
    cfg, ref_cfg = TINY_TEST, REF_TINY
    ids, mask = batch(0)
    if case == "padding":
        ids, mask = batch(1, b=3, lengths=[64, 23, 5])
    if case == "one_token_a_shard_beyond_one_block":
        ids, mask = batch(2, b=1, t=cfg.max_len)
    if case == "flash":
        ids, mask = batch(2, b=3, lengths=[64, 30, 9])
        cfg = dataclasses.replace(cfg, attention="flash")
    out = sequence_parallel_forward_fn(mesh, cfg)(params, torch.from_numpy(ids), torch.from_numpy(mask))
    ref = ref_sp_forward(ref_mesh, ref_cfg)(flax_params, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
    flax_ref = RefEncoder(ref_cfg).apply(flax_params, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(flax_ref), atol=2e-4)
    with torch.no_grad():
        plain = load_encoder(SentimentEncoder, TINY_TEST, params)(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=2e-4)


def test_sp_gradient_matches_the_references(setup):
    """Differentiable end to end (autograd through the ring): the
    parameter gradients of ``sum(logits²)`` equal the reference's SP
    gradients and the unsharded encoder's."""
    flax_params, params, mesh, ref_mesh = setup
    ids, mask = batch(3)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    out = sequence_parallel_forward_fn(mesh, TINY_TEST)(leaves, torch.from_numpy(ids), torch.from_numpy(mask))
    (out ** 2).sum().backward()
    ref_fwd = ref_sp_forward(ref_mesh, REF_TINY)
    jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
    g_ref = params_from_flax(jax.grad(lambda p: jnp.sum(ref_fwd(p, jids, jmask) ** 2))(flax_params))
    model = load_encoder(SentimentEncoder, TINY_TEST, {k: v.clone().requires_grad_() for k, v in params.items()})
    (model(torch.from_numpy(ids), torch.from_numpy(mask)) ** 2).sum().backward()
    plain = dict(model.named_parameters())
    assert set(g_ref) == set(leaves)
    for name, leaf in leaves.items():
        np.testing.assert_allclose(leaf.grad.numpy(), g_ref[name].numpy(), atol=5e-5, err_msg=name)
        np.testing.assert_allclose(leaf.grad.numpy(), plain[name].grad.numpy(), atol=5e-5, err_msg=name)


def test_sp_train_step_matches_the_references_and_the_unsharded_step(setup):
    """One SGD(0.1) SP step (T = 64 over 8 slots) against the
    reference's ``make_sp_train_step`` and the port's unsharded step."""
    flax_params, params, mesh, ref_mesh = setup
    ids, mask = batch(1)
    labels = (np.random.default_rng(1).random((2, TINY_TEST.n_labels)) < 0.3).astype(np.float32)
    jbatch = jt.Batch(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels))
    ref_step = jt.make_sp_train_step(REF_TINY, optax.sgd(0.1), ref_mesh)
    ref_state, ref_metrics = ref_step(jt.init_state(None, flax_params, optax.sgd(0.1)), jbatch)
    ref_params = params_from_flax(ref_state.params)
    tbatch = Batch(*(torch.from_numpy(a) for a in (ids, mask, labels)))
    results = []
    for step in (make_sp_train_step(TINY_TEST, mesh), make_train_step()):
        with torch.device("meta"):
            model = SentimentEncoder(TINY_TEST)
        state, metrics = step(init_state(model, params, sgd(0.1), device="cpu"), tbatch)
        results.append((state, metrics))
    (sp_state, sp_metrics), (plain_state, plain_metrics) = results
    np.testing.assert_allclose(sp_metrics["loss"].item(), float(ref_metrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(sp_metrics["loss"].item(), plain_metrics["loss"].item(), rtol=1e-4)
    np.testing.assert_allclose(sp_metrics["grad_norm"].item(), float(ref_metrics["grad_norm"]), rtol=1e-4)
    plain = dict(plain_state.model.named_parameters())
    assert sp_state.step == 1
    for name, p in sp_state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name].numpy(), atol=5e-5, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), plain[name].detach().numpy(), atol=5e-5, err_msg=name)


def test_sp_trainer_refuses_flash(setup):
    with pytest.raises(ValueError, match="dense"):
        make_sp_train_step(dataclasses.replace(TINY_TEST, attention="flash"), setup[2])
