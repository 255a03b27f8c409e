"""Keyed fleets on the CPU, with no JAX draws fed in.

- ``ClaimServingStep.fleets`` against the reference ``Session``'s key
  chain (``PRNGKey(claim_seed)`` or ``PRNGKey(spec.seed)``, one
  ``split`` a fetch, ``gen_oracle_predictions`` on the fetch's key):
  every fed claim's block bit for bit over three fetches.
- The batched build (one ``fleet_block`` pass per bucket) equals the
  one-claim builds bit for bit; claims of two buckets in one step.
- Sibling isolation: a claim's fleets do not depend on which other
  claims were fed, skipped or batched with it.

The keyed TINY_TEST flagship step against the JAX flagship body is in
``tests/test_torch_slice.py``, beside the same step with JAX's draws
fed in (one flax init serves both).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.sim.generators import claim_seed as jax_claim_seed
from svoc_tpu.sim.oracle import gen_oracle_predictions as jax_gen_oracle_predictions

from svoc_torch.apps.session import fleet_block, request_window
from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.models.configs import TINY_TEST
from svoc_torch.serving.batcher import Request
from svoc_torch.serving.tier import ClaimServingStep
from svoc_torch.sim import prng
from svoc_torch.sim.generators import claim_seed

_gen = jax.jit(jax_gen_oracle_predictions, static_argnums=(2, 3, 4))

def _step(specs, seed=0):
    return ClaimServingStep(specs, TINY_TEST, rows=4, seq=16, max_seg=2, seed=seed,
                            params_dtype=None, device="cpu")


def _feed(counts, rng):
    """Requests of each claim (``{claim: n}``) in round-robin order, and
    their vectors."""
    requests = []
    left = dict(counts)
    while any(left.values()):
        for cid in counts:
            if left[cid]:
                requests.append(Request(cid, "text"))
                left[cid] -= 1
    vectors = rng.uniform(size=(len(requests), 6)).astype(np.float32)
    return requests, torch.from_numpy(vectors)


def _blocks(groups):
    return {cid: block for g in groups for cid, block in zip(g.claims, g.blocks)}


def _reference_window(previous, new, cap=50):
    """``svoc_tpu/apps/session.py:558-589`` in numpy."""
    window = new if previous is None else np.concatenate([previous, new])
    kept = window[-cap:]
    bucket = 1 << max(0, kept.shape[0] - 1).bit_length()
    return kept, np.resize(kept, (bucket, kept.shape[1])), min(10, max(1, bucket // 2))


def test_claim_fleets_follow_the_reference_session_key_chain():
    specs = [ClaimSpec("alpha", n_oracles=16, n_failing=4),
             ClaimSpec("beta", seed=3_000_000_000, n_oracles=16, n_failing=4),
             ClaimSpec("gamma", n_oracles=24, n_failing=6)]
    step = _step(specs, seed=7)
    keys = {s.claim_id: jax.random.PRNGKey(jax_claim_seed(7, s.claim_id) if s.seed is None else s.seed)
            for s in specs}
    windows = dict.fromkeys(keys)
    rng = np.random.default_rng(0)
    for counts in ({"alpha": 3, "beta": 1, "gamma": 5}, {"alpha": 2, "gamma": 1},
                   {"alpha": 4, "beta": 6, "gamma": 2}):
        requests, vectors = _feed(counts, rng)
        blocks = _blocks(step.fleets(requests, vectors))
        assert sorted(blocks) == sorted(counts)
        for spec in specs:
            cid = spec.claim_id
            if cid not in counts:
                continue
            feed = vectors.numpy()[[i for i, r in enumerate(requests) if r.claim == cid]]
            windows[cid], tiled, subset = _reference_window(windows[cid], feed)
            keys[cid], sub = jax.random.split(keys[cid])
            want, _ = _gen(sub, jnp.asarray(tiled), spec.n_oracles, spec.n_failing, subset)
            np.testing.assert_array_equal(blocks[cid].numpy(), np.asarray(want), err_msg=cid)
        assert step.keys.tolist() == [np.asarray(keys[s.claim_id]).astype(np.int64).tolist()
                                      for s in specs]


def test_batched_build_equals_one_claim_builds():
    spec = ClaimSpec("alpha", n_oracles=64, n_failing=8)
    keys = prng.split(prng.PRNGKey(1, "cpu"), 12)
    windows = torch.from_numpy(np.random.default_rng(1).uniform(size=(12, 16, 6)).astype(np.float32))
    values, honest = fleet_block(keys, windows, spec, 8)
    assert values.shape == (12, 64, 6) and honest.shape == (12, 64)
    for c in range(12):
        one, one_honest = fleet_block(keys[c], windows[c], spec, 8)
        assert torch.equal(values[c], one) and torch.equal(honest[c], one_honest)
    with pytest.raises(ValueError, match="one claim's block"):
        fleet_block(keys, windows, spec, 8, tamper=lambda cycle, block: block)


def test_two_buckets_in_one_step_build_apart_and_match_one_by_one():
    """Claims fed 1, 3 and 5 rows fall into buckets 1, 4 and 8: three
    batches in one step, each claim's block its one-claim build."""
    specs = [ClaimSpec(cid, n_oracles=16, n_failing=4) for cid in ("a", "b", "c", "d")]
    step = _step(specs)
    requests, vectors = _feed({"a": 1, "b": 3, "c": 5, "d": 5}, np.random.default_rng(2))
    keys = step.keys.clone()
    blocks = _blocks(step.fleets(requests, vectors))
    for j, spec in enumerate(specs):
        feed = vectors[[i for i, r in enumerate(requests) if r.claim == spec.claim_id]]
        _, tiled, subset = request_window(None, feed)
        sub = prng.split(keys[j])[1]
        one, _ = fleet_block(sub, tiled, spec, subset)
        assert torch.equal(blocks[spec.claim_id], one), spec.claim_id
    assert {tuple(b.shape) for b in blocks.values()} == {(16, 6)}


def test_sibling_isolation_when_feeding_or_skipping_a_claim():
    specs = [ClaimSpec(cid, n_oracles=16, n_failing=4) for cid in ("a", "b", "c")]
    all_fed, b_skipped = _step(specs), _step(specs)
    rng = np.random.default_rng(3)
    for step_no in range(3):
        requests, vectors = _feed({"a": 2, "b": 2, "c": 2}, rng)
        full = _blocks(all_fed.fleets(requests, vectors))
        keep = [i for i, r in enumerate(requests) if r.claim != "b" or step_no == 2]
        part = _blocks(b_skipped.fleets([requests[i] for i in keep], vectors[keep]))
        for cid in ("a", "c"):
            assert torch.equal(full[cid], part[cid]), (step_no, cid)
        if step_no < 2:
            assert "b" not in part
            assert b_skipped.keys[1].tolist() == [0, claim_seed(0, "b")]  # no fetch, no split
    assert all_fed.cycles == {"a": 3, "b": 3, "c": 3} and b_skipped.cycles["b"] == 1
