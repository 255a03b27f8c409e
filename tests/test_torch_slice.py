"""The port's serving slice against the JAX package's, on the CPU.

- ``first_valid_window`` is an exact gather in both packages.
- ``assemble_fleet`` fed with the draws JAX makes from
  ``split(key, 3)`` equals ``gen_oracle_predictions`` within 1e-6 (the
  bootstrap means are summed in another order).
- The tiny slice end to end, from texts to the consensus essence, with
  flax's TINY_TEST weights and an identical fleet, against the same
  chain in JAX (Pallas kernels in interpret mode): vectors within 1e-4,
  the reliable mask exact, essence and reliabilities within 1e-5; first
  with JAX's draws fed in, then keyed (``step(batch, key)``, the port's
  own threefry draws from the same key, no JAX draws fed in), where the
  honest mask is exact too.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.consensus.kernel import ConsensusConfig as JaxConfig
from svoc_tpu.models import configs as jax_configs
from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder
from svoc_tpu.models.encoder import init_params as jax_init_params
from svoc_tpu.models.packing import PackedSentimentEncoder as JaxPacked
from svoc_tpu.models.sentiment import scores_to_vectors as jax_scores_to_vectors
from svoc_tpu.ops.pallas_consensus import fused_consensus as jax_fused
from svoc_tpu.ops.select import first_valid_window as jax_first_valid_window
from svoc_tpu.sim.oracle import gen_oracle_predictions as jax_gen_oracle_predictions

from svoc_torch.flagship import FlagshipStep
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import TINY_TEST
from svoc_torch.models.from_jax import params_from_flax
from svoc_torch.ops.select import first_valid_window
from svoc_torch.sim.oracle import FleetDraws, assemble_fleet, draw_fleet
from svoc_torch.sim.prng import PRNGKey


def _jax_draws(key, w, m, n_oracles, n_failing, subset):
    """The random numbers ``svoc_tpu.sim.oracle.gen_oracle_predictions``
    draws, in its split order ``k_fail, k_boot, k_perm``."""
    k_fail, k_boot, k_perm = jax.random.split(key, 3)
    failing = jax.random.uniform(k_fail, (n_failing, m))
    boot = jax.vmap(lambda k: jax.random.choice(k, w, shape=(subset,), replace=False))(
        jax.random.split(k_boot, n_oracles - n_failing)
    )
    perm = jax.random.permutation(k_perm, n_oracles)
    return FleetDraws(*(torch.from_numpy(np.array(a)) for a in (failing, boot, perm)))


@pytest.mark.parametrize("n,w,valid_p", [(40, 12, 0.6), (30, 25, 0.5), (16, 16, 1.0)])
def test_first_valid_window_is_exact(n, w, valid_p):
    rng = np.random.default_rng(n)
    vecs = rng.uniform(size=(n, 6)).astype(np.float32)
    valid = rng.uniform(size=n) < valid_p
    ref = np.asarray(jax_first_valid_window(jnp.asarray(vecs), jnp.asarray(valid), w))
    out = first_valid_window(torch.from_numpy(vecs), torch.from_numpy(valid), w).numpy()
    np.testing.assert_array_equal(out, ref)
    assert np.all(out[valid.sum():] == 0.0)  # a short window pads with zeros


@pytest.mark.parametrize("n_oracles,n_failing,subset", [(64, 8, 10), (7, 2, 3)])
def test_assemble_fleet_matches_gen_oracle_predictions(n_oracles, n_failing, subset):
    window = np.random.default_rng(2).uniform(size=(20, 6)).astype(np.float32)
    key = jax.random.PRNGKey(n_oracles)
    ref_vals, ref_honest = jax_gen_oracle_predictions(
        key, jnp.asarray(window), n_oracles, n_failing, subset_size=subset
    )
    draws = _jax_draws(key, 20, 6, n_oracles, n_failing, subset)
    vals, honest = assemble_fleet(torch.from_numpy(window), *draws)
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals), atol=1e-6)
    np.testing.assert_array_equal(honest.numpy(), np.asarray(ref_honest))


def test_torch_draws_make_a_well_formed_fleet():
    window = torch.rand(12, 6, generator=torch.Generator().manual_seed(0))
    draws = draw_fleet(PRNGKey(0, "cpu"), 12, 6, 40, 5, subset_size=10)
    assert draws.boot_idx.shape == (35, 10)
    assert all(len(set(row.tolist())) == 10 for row in draws.boot_idx)  # no repeats
    assert sorted(draws.perm.tolist()) == list(range(40))
    vals, honest = assemble_fleet(window, *draws)
    assert vals.shape == (40, 6) and int(honest.sum()) == 35
    assert torch.all((vals >= 0) & (vals <= 1))


def test_tiny_slice_end_to_end_matches_jax():
    rows, seq, max_seg, n_oracles, subset = 16, 32, 4, 64, 10
    flax_params = jax_init_params(JaxEncoder(jax_configs.TINY_TEST), seed=1)
    step = FlagshipStep(
        TINY_TEST, rows=rows, seq=seq, max_seg=max_seg, n_oracles=n_oracles,
        subset_size=subset, params=params_from_flax(flax_params), params_dtype=None,
        device="cpu",
    )
    batch, n = next(step.comments(SyntheticSource(batch=rows, seed=0)))
    assert n == int(batch.seg_valid.sum()) and step.window_size == rows

    # JAX: packed flash forward -> vectors -> window -> fleet -> fused consensus
    # (the port's default variant, "packed_flash", sets flash itself).
    assert step.pipe.cfg.attention == "flash"
    jcfg = dataclasses.replace(jax_configs.TINY_TEST, attention="flash")
    batch = type(batch)(*(np.asarray(a) for a in batch))  # the feed's CPU tensors, as numpy
    logits = JaxPacked(jcfg).apply(
        flax_params, *map(jnp.asarray, (batch.ids, batch.pos, batch.seg, batch.cls_pos))
    )
    vecs = jax_scores_to_vectors(logits.reshape(rows * max_seg, -1))
    jwindow = jax_first_valid_window(vecs, jnp.asarray(batch.seg_valid > 0).reshape(-1), rows)
    key = jax.random.PRNGKey(4)
    jvals, jhonest = jax_gen_oracle_predictions(key, jwindow, n_oracles, step.ccfg.n_failing, subset)
    ref = jax_fused(jvals, JaxConfig(n_failing=step.ccfg.n_failing), interpret=True)

    # The port on the same fleet draws.
    window = step.window(batch)
    np.testing.assert_allclose(window.numpy(), np.asarray(jwindow), atol=1e-4)
    fed, _ = step.consensus(window, _jax_draws(key, rows, 6, n_oracles, step.ccfg.n_failing, subset))
    keyed, honest = step(batch, PRNGKey(4, "cpu"))
    np.testing.assert_array_equal(honest.numpy(), np.asarray(jhonest))
    for out in (fed, keyed):
        np.testing.assert_array_equal(out.reliable.numpy(), np.asarray(ref.reliable))
        for field in ("essence", "essence_first_pass", "reliability_first_pass",
                      "reliability_second_pass"):
            np.testing.assert_allclose(
                np.asarray(getattr(out, field)), np.asarray(getattr(ref, field)), atol=1e-5,
                err_msg=field,
            )
