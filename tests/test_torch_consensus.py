"""The port's consensus against the JAX package's, on the CPU.

``svoc_torch.ops.fused_consensus`` (plain version) is held against
``svoc_tpu.ops.pallas_consensus.fused_consensus(interpret=True)`` and
``svoc_torch.consensus.kernel.consensus_step`` against the XLA
``consensus_step``, on the same numpy fleets.  Bars are those of
``tests/test_pallas_consensus.py``: the reliable mask and the Cairo tie
order exact; essence, risk and reliabilities within 1e-5; skewness
within 1e-4; kurtosis within 1e-3.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.consensus.kernel import ConsensusConfig as JaxConfig
from svoc_tpu.consensus.kernel import consensus_step as jax_consensus_step
from svoc_tpu.ops import sort as jax_sort
from svoc_tpu.ops import stats as jax_stats
from svoc_tpu.ops.pallas_consensus import fused_consensus as jax_fused

from svoc_torch.consensus.kernel import ConsensusConfig, consensus_step
from svoc_torch.ops import sort as torch_sort
from svoc_torch.ops import stats as torch_stats
from svoc_torch.ops.fused_consensus import fused_consensus, fused_consensus_plain

CASES = [
    (7, 2, 6, True),
    (7, 2, 2, False),
    (64, 16, 6, True),
    (256, 64, 6, True),
    (256, 64, 3, False),
]
STEP_CASES = [(7, 2, 6, True), (64, 16, 6, False), (256, 64, 6, True)]


def _fleet(n, dim, constrained, seed):
    rng = np.random.default_rng(seed)
    if constrained:
        return rng.uniform(0.01, 0.99, size=(n, dim)).astype(np.float32)
    return (20.0 + 3.0 * rng.standard_normal((n, dim))).astype(np.float32)


def _tie_fleet(n, dim, seed):
    """Values quantised to 1e-2 with whole rows repeated: exact ties in
    both the columns and the risks."""
    rng = np.random.default_rng(seed)
    base = np.round(rng.uniform(0.2, 0.8, size=(n // 4 + 1, dim)), 2)
    return base[rng.integers(0, base.shape[0], size=n)].astype(np.float32)


def _assert_matches(out, ref, check_interval=False):
    np.testing.assert_array_equal(np.asarray(out.reliable), np.asarray(ref.reliable))
    for field in ("essence", "essence_first_pass", "quadratic_risk"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, field)), np.asarray(getattr(ref, field)), atol=1e-5,
            err_msg=field,
        )
    for field in ("reliability_first_pass", "reliability_second_pass"):
        assert float(getattr(out, field)) == pytest.approx(
            float(getattr(ref, field)), abs=1e-5
        ), field
    np.testing.assert_allclose(np.asarray(out.skewness), np.asarray(ref.skewness), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.kurtosis), np.asarray(ref.kurtosis), atol=1e-3)
    if check_interval:
        assert bool(out.interval_valid) == bool(ref.interval_valid)


@pytest.mark.parametrize("n,f,dim,constrained", CASES)
def test_fused_consensus_matches_pallas_kernel(n, f, dim, constrained):
    values = _fleet(n, dim, constrained, seed=n * dim)
    ref = jax_fused(jnp.asarray(values), JaxConfig(n_failing=f, constrained=constrained), interpret=True)
    out = fused_consensus(torch.from_numpy(values), ConsensusConfig(n_failing=f, constrained=constrained))
    _assert_matches(out, ref)


@pytest.mark.parametrize("n,f,dim,constrained", STEP_CASES)
def test_consensus_step_matches_xla(n, f, dim, constrained):
    values = _fleet(n, dim, constrained, seed=n + dim)
    ref = jax_consensus_step(jnp.asarray(values), JaxConfig(n_failing=f, constrained=constrained))
    out = consensus_step(torch.from_numpy(values), ConsensusConfig(n_failing=f, constrained=constrained))
    _assert_matches(out, ref, check_interval=True)


@pytest.mark.parametrize("n,f,dim", [(64, 8, 6), (256, 32, 1)])
def test_tie_fleet_mask_is_exact(n, f, dim):
    values = _tie_fleet(n, dim, seed=n + f)
    jcfg, tcfg = JaxConfig(n_failing=f), ConsensusConfig(n_failing=f)
    ref = jax_fused(jnp.asarray(values), jcfg, interpret=True)
    _assert_matches(fused_consensus(torch.from_numpy(values), tcfg), ref)
    _assert_matches(
        consensus_step(torch.from_numpy(values), tcfg),
        jax_consensus_step(jnp.asarray(values), jcfg),
    )


def test_tie_order_of_the_reference_fixture():
    """Three identical outliers, two masked: ties rank by descending
    index, so the two lowest indices of the tie are the ones masked
    (``tests/test_pallas_consensus.py``)."""
    values = np.array([[0.5], [0.5], [0.9], [0.9], [0.9], [0.5], [0.5]], np.float32)
    ref = jax_consensus_step(jnp.asarray(values), JaxConfig(n_failing=2))
    out = fused_consensus(torch.from_numpy(values), ConsensusConfig(n_failing=2))
    np.testing.assert_array_equal(out.reliable.numpy(), np.asarray(ref.reliable))
    assert out.reliable.tolist() == [True, True, False, False, True, True, True]


@pytest.mark.parametrize("seed", range(4))
def test_argsort_cairo_matches_reference_and_merge_sort(seed):
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 5, size=33)
    ours = torch_sort.argsort_cairo(torch.from_numpy(values)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_sort.argsort_cairo(jnp.asarray(values))))
    assert ours.tolist() == [i for i, _ in jax_sort.indexed_sort_host(values.tolist())]
    ranks = torch_sort.cairo_rank(torch.from_numpy(values)).numpy()
    np.testing.assert_array_equal(ours[ranks], np.arange(values.size))


def test_n_failing_guard_marks_invalid():
    """``n - n_failing < 2`` is no consensus (``kernel.py:114``)."""
    values = _fleet(7, 3, True, seed=1)
    for f in (6, 7):
        ref = jax_consensus_step(jnp.asarray(values), JaxConfig(n_failing=f))
        out = consensus_step(torch.from_numpy(values), ConsensusConfig(n_failing=f))
        assert not bool(out.interval_valid) and not bool(ref.interval_valid)


def test_plain_version_is_what_the_dispatcher_runs_on_cpu():
    values = torch.from_numpy(_fleet(64, 6, True, seed=3))
    cfg = ConsensusConfig(n_failing=8)
    a, b = fused_consensus(values, cfg), fused_consensus_plain(values, cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["cairo", "true"])
@pytest.mark.parametrize("n", [8, 9])
def test_smooth_medians_match(mode, n):
    rng = np.random.default_rng(n)
    values = np.round(rng.uniform(size=(n, 4)), 1).astype(np.float32)  # with ties
    mask = rng.uniform(size=n) > 0.3
    tv, tm, jv, jm = torch.from_numpy(values), torch.from_numpy(mask), jnp.asarray(values), jnp.asarray(mask)
    np.testing.assert_array_equal(
        torch_stats.masked_smooth_median(tv, tm, mode).numpy(),
        np.asarray(jax_stats.masked_smooth_median(jv, jm, mode)),
    )
