"""The port's mesh runner and oracle-sharded consensus and fleet step
against the JAX package's, on the CPU.

Twin of ``tests/test_parallel.py``: the reference runs
:mod:`svoc_tpu.parallel.sharded` on its 8 simulated CPU devices, the
port :mod:`svoc_torch.parallel.sharded` on an 8-slot CPU mesh, on the
same seeded numpy inputs.  Bars: ``tests/test_parallel.py``'s (rtol 1e-5
on essences, reliabilities and risks; skewness and kurtosis rtol 1e-4,
atol 1e-5; the reliable mask exact): the psum body adds its partials in
slot order, which is not XLA's all-reduce order bit for bit.  The fleet
is bitwise the reference's, and bitwise the same on every mesh.  Then
the runner itself: its splitting and assembly, collectives in lockstep,
the one-body-along-an-unnamed-axis rule, and its refusals.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svoc_tpu.consensus.kernel import ConsensusConfig as RefConfig  # noqa: E402
from svoc_tpu.consensus.kernel import consensus_step as ref_consensus_step  # noqa: E402
from svoc_tpu.parallel import mesh as ref_mesh  # noqa: E402
from svoc_tpu.parallel import sharded as ref_sharded  # noqa: E402

from svoc_torch.consensus.kernel import ConsensusConfig, consensus_step  # noqa: E402
from svoc_torch.parallel import sharded  # noqa: E402
from svoc_torch.parallel.mesh import MeshSpec, P, best_mesh, make_mesh  # noqa: E402
from svoc_torch.sim import prng  # noqa: E402

CFGS = [ConsensusConfig(n_failing=2, constrained=True),
        ConsensusConfig(n_failing=3, constrained=False, max_spread=10.0)]
REF_CFGS = [RefConfig(n_failing=2, constrained=True), RefConfig(n_failing=3, constrained=False, max_spread=10.0)]


@pytest.fixture(scope="module")
def mesh():
    return best_mesh("oracle", device="cpu")


def oracle_mesh(n):
    return make_mesh(MeshSpec(("oracle",), (n,)), device="cpu")


def assert_parallel_bars(out, ref):
    """``tests/test_parallel.py``'s bars."""
    for field in ("essence", "essence_first_pass", "reliability_first_pass", "reliability_second_pass",
                  "quadratic_risk"):
        np.testing.assert_allclose(getattr(out, field).numpy(), np.asarray(getattr(ref, field)), rtol=1e-5,
                                   err_msg=field)
    assert np.array_equal(out.reliable.numpy(), np.asarray(ref.reliable))
    np.testing.assert_allclose(out.skewness.numpy(), np.asarray(ref.skewness), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.kurtosis.numpy(), np.asarray(ref.kurtosis), rtol=1e-4, atol=1e-5)
    assert bool(out.interval_valid) == bool(ref.interval_valid)


@pytest.mark.parametrize("index", [0, 1], ids=["constrained", "unconstrained"])
def test_sharded_matches_single_device_and_the_reference(mesh, index):
    values = np.array(jax.random.uniform(jax.random.PRNGKey(7), (64, 6)))
    out = sharded.sharded_consensus_fn(mesh, CFGS[index])(torch.from_numpy(values))
    assert_parallel_bars(out, consensus_step(torch.from_numpy(values), CFGS[index]))
    ref = ref_sharded.sharded_consensus_fn(ref_mesh.best_mesh("oracle"), REF_CFGS[index])(jnp.asarray(values))
    assert_parallel_bars(out, ref)
    assert_parallel_bars(out, ref_consensus_step(jnp.asarray(values), REF_CFGS[index]))


@pytest.mark.parametrize("gate", [None, (0.0, 1.0)])
def test_fleet_step_equals_the_reference(mesh, gate):
    """The fleet is the reference's bit for bit (``honest``, the
    admission mask); the consensus at the bars."""
    cfg = ConsensusConfig(n_failing=8, constrained=True)
    window = np.array(jax.random.uniform(jax.random.PRNGKey(11), (50, 6)))
    if gate is not None:
        window[3, 2] = np.nan  # a poisoned window row reaches some oracles' means
    ours = sharded.sharded_fleet_step_fn(mesh, cfg, 64, gate=gate)(prng.PRNGKey(3, "cpu"), torch.from_numpy(window))
    theirs = ref_sharded.sharded_fleet_step_fn(ref_mesh.best_mesh("oracle"), RefConfig(n_failing=8), 64, gate=gate)(
        jax.random.PRNGKey(3), jnp.asarray(window))
    assert np.array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    if gate is not None:
        assert np.array_equal(ours[2].numpy(), np.asarray(theirs[2])) and not bool(ours[2].all())
    assert_parallel_bars(ours[0], theirs[0])


def test_fleet_step_sharding_invariance(mesh):
    """Keyed by global oracle index: a 1-slot and an 8-slot mesh give the
    same fleet bit for bit, and the configured number of failures."""
    cfg = ConsensusConfig(n_failing=8, constrained=True)
    window = torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(11), (50, 6))))
    key = prng.PRNGKey(3, "cpu")
    out8, honest8 = sharded.sharded_fleet_step_fn(mesh, cfg, 64)(key, window)
    out1, honest1 = sharded.sharded_fleet_step_fn(oracle_mesh(1), cfg, 64)(key, window)
    assert torch.equal(honest8, honest1) and torch.equal(out8.reliable, out1.reliable)
    torch.testing.assert_close(out8.essence, out1.essence, rtol=1e-6, atol=0)
    assert int((~honest8).sum()) == cfg.n_failing
    rows = sharded.oracle_rows(key, window, 64, 8, 10, 0, 64)
    for n in (2, 4):
        parts = [sharded.oracle_rows(key, window, 64, 8, 10, i * 64 // n, 64 // n) for i in range(n)]
        assert torch.equal(torch.cat([p[0] for p in parts]), rows[0])


def test_fleet_step_detects_failures(mesh):
    cfg = ConsensusConfig(n_failing=8, constrained=True)
    window = torch.from_numpy(np.clip(0.5 + 0.01 * np.asarray(jax.random.normal(jax.random.PRNGKey(0), (50, 6))),
                                      0.0, 1.0).astype(np.float32))
    fn = sharded.sharded_fleet_step_fn(mesh, cfg, 64)
    hits = 0
    for t in range(10):
        out, honest = fn(prng.PRNGKey(100 + t, "cpu"), window)
        hits += int(torch.equal(out.reliable, honest))
    assert hits >= 8, f"only {hits}/10 exact identifications"


def test_fleet_rejects_an_indivisible_fleet(mesh):
    with pytest.raises(ValueError, match="not divisible"):
        sharded.fleet_consensus_shard_map(mesh, CFGS[0], 60)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def grid_mesh(a=2, b=4):
    return make_mesh(MeshSpec(("x", "y"), (a, b)), device="cpu")


def test_runner_splits_and_assembles_by_spec():
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    seen = []

    def body(t):
        seen.append((sharded.axis_index("x"), sharded.axis_index("y"), tuple(t.shape)))
        return t * 2, t.sum()

    out, total = sharded.shard_map(body, mesh=grid_mesh(), in_specs=(P("x", "y"),),
                                   out_specs=(P("x", "y"), P()), collectives=False)(x)
    assert torch.equal(out, x * 2)
    assert float(total) == float(x[:4, :3].sum())  # a replicated output is slot (0, 0)'s
    assert seen == [(i, j, (4, 3)) for i in range(2) for j in range(4)]


def test_collectives_run_in_lockstep_in_axis_order():
    x = torch.arange(8, dtype=torch.float64) + 1.0
    order = []

    def body(t, u):
        order.append(("pre", sharded.axis_index("x"), sharded.axis_index("y")))
        gathered = sharded.all_gather(t, "y")
        doubled = sharded.psum(t, "x")
        order.append(("post", sharded.axis_index("x"), sharded.axis_index("y")))
        return gathered, doubled, sharded.psum(1, "y") + u

    gathered, doubled, size = sharded.shard_map(body, mesh=grid_mesh(), in_specs=(P("y"), P("x")),
                                                out_specs=(P(), P("y"), P("x")))(x, torch.zeros(2))
    # Every slot reached the first collective before any went on.
    assert order[:8] == [("pre", i, j) for i in range(2) for j in range(4)]
    assert [o[0] for o in order] == ["pre"] * 8 + ["post"] * 8
    assert torch.equal(gathered, x)  # the y-group's pieces in axis order
    assert torch.equal(doubled, 2 * x) and size.tolist() == [4.0, 4.0]


def test_unnamed_axes_run_one_body_and_refuse_collectives():
    calls = []
    fn = sharded.shard_map(lambda t: calls.append(1) or t + 1, mesh=grid_mesh(), in_specs=(P("x"),),
                           out_specs=P("x"))
    assert torch.equal(fn(torch.zeros(4)), torch.ones(4)) and len(calls) == 2
    bad = sharded.shard_map(lambda t: sharded.psum(t, "y"), mesh=grid_mesh(), in_specs=(P("x"),), out_specs=P("x"))
    with pytest.raises(ValueError, match="named by no spec"):
        bad(torch.zeros(4))
    quiet = sharded.shard_map(lambda t: sharded.psum(t, "x"), mesh=grid_mesh(), in_specs=(P("x"),),
                              out_specs=P("x"), collectives=False)
    with pytest.raises(RuntimeError, match="collectives=False"):
        quiet(torch.zeros(4))


def test_runner_refusals_and_errors():
    with pytest.raises(ValueError, match="does not divide"):
        sharded.shard_map(lambda t: t, mesh=grid_mesh(), in_specs=(P("y"),), out_specs=P("y"))(torch.zeros(6))
    with pytest.raises(ValueError, match="lacks"):
        sharded.shard_map(lambda t: t, mesh=grid_mesh(), in_specs=(P("z"),), out_specs=P("z"))
    with pytest.raises(RuntimeError, match="inside a shard_map"):
        sharded.axis_index("x")

    def boom(t):
        if sharded.axis_index("y") == 2:
            raise KeyError("slot 2 fails")
        return sharded.psum(t, "y")

    # The runner keeps its slot threads between runs: after a run that
    # started them, a failing run starts none and leaves none behind.
    sharded.shard_map(lambda t: sharded.psum(t, "y"), mesh=grid_mesh(1, 4), in_specs=(P("y"),),
                      out_specs=P())(torch.zeros(4))
    threads, idle = threading.active_count(), len(sharded._idle_workers)
    with pytest.raises(KeyError, match="slot 2 fails"):
        sharded.shard_map(boom, mesh=grid_mesh(1, 4), in_specs=(P("y"),), out_specs=P())(torch.zeros(4))
    assert threading.active_count() == threads  # no slot thread started or left running
    assert len(sharded._idle_workers) == idle  # every slot thread back among the idle ones


def test_threads_keep_the_callers_modes():
    def body(t):
        sharded.psum(t, "y")
        return torch.tensor(torch.is_inference_mode_enabled()), torch.tensor(torch.is_grad_enabled())

    fn = sharded.shard_map(body, mesh=grid_mesh(1, 4), in_specs=(P("y"),), out_specs=(P(), P()))
    with torch.inference_mode():
        inference, _grad = fn(torch.zeros(4))
    assert bool(inference)
    with torch.no_grad():
        _inference, grad = fn(torch.zeros(4))
    assert not bool(grad)
