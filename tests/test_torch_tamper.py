"""The scenario tamper hook under the reference's contract, on the CPU.

The reference hands ``ClaimSpec.tamper`` the claim's fleet block fetched
to the host as float64 numpy and casts the hook's return to float32
(``svoc_tpu/apps/session.py:622-633``, through
``svoc_tpu/fabric/router.py:494-497``).  The fabric scenario's own hook
(``svoc_tpu/fabric/scenario.py:140-152``, :func:`_scenario_hook` here in
its form: ``np.array(block, copy=True)``, numpy writes, a numpy return)
must run unchanged in the port's ``fleet_block`` and
``ClaimServingStep``, give the block the reference's cast gives, and
leave the block bit for bit as it was when it returns it unchanged.
"""

import numpy as np
import pytest
import torch

from svoc_torch.apps.session import fleet_block
from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.models.configs import TINY_TEST
from svoc_torch.serving.batcher import Request
from svoc_torch.serving.tier import ClaimServingStep
from svoc_torch.sim.prng import PRNGKey

N_ORACLES, SLOT = 16, 15
KINDS = [None, "nan", "inf", "range"]


def _scenario_hook(kinds, slot=SLOT):
    """The fabric scenario's ``tamper(cycle, block)`` in the reference's
    form, with the cycles it saw."""
    seen = []

    def tamper(cycle: int, block: np.ndarray) -> np.ndarray:
        seen.append((cycle, type(block), block.dtype, block.shape))
        kind = kinds[cycle] if cycle < len(kinds) else None
        if kind is None:
            return block
        block = np.array(block, copy=True)
        if kind == "nan":
            block[slot, 0] = np.nan
        elif kind == "inf":
            block[slot, :] = np.inf
        else:  # out of the constrained [0, 1] domain
            block[slot, :] = 7.5
        return block

    return tamper, seen


def _fleet(tamper=None, cycle=0):
    spec = ClaimSpec("alpha", n_oracles=N_ORACLES, n_failing=4)
    window = torch.from_numpy(np.random.default_rng(3).uniform(size=(8, 6)).astype(np.float32))
    return fleet_block(PRNGKey(5, "cpu"), window, spec, 4, tamper, cycle)


@pytest.mark.parametrize("cycle,kind", list(enumerate(KINDS)))
def test_fleet_block_runs_the_reference_hook(cycle, kind):
    """The hook gets the host float64 block; the result is what the
    reference's cast gives; an unchanged return is the untampered block
    bit for bit."""
    clean, honest = _fleet()
    tamper, seen = _scenario_hook(KINDS)
    got, got_honest = _fleet(tamper, cycle)
    assert seen == [(cycle, np.ndarray, np.float64, (N_ORACLES, 6))]
    assert got.dtype == torch.float32 and got.device == clean.device
    assert torch.equal(got_honest, honest)
    ref, _ = _scenario_hook(KINDS)
    want = np.asarray(ref(cycle, clean.numpy().astype(np.float64)), np.float64).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)  # NaN where NaN
    if kind is None:
        assert torch.equal(got, clean)
    else:
        assert torch.equal(got[:SLOT], clean[:SLOT]) and not torch.equal(got[SLOT], clean[SLOT])


def test_fleet_block_takes_any_array_the_hook_returns():
    """The return is read as float64 (a list, an integer array) and cast to
    float32, as ``np.asarray(..., np.float64).astype(np.float32)`` does."""
    clean, _ = _fleet()
    as_list, _ = _fleet(lambda cycle, block: block.tolist())
    assert torch.equal(as_list, clean)
    ones, _ = _fleet(lambda cycle, block: np.ones(block.shape, dtype=np.int64))
    assert torch.equal(ones, torch.ones(N_ORACLES, 6))


def test_claim_serving_step_runs_the_reference_hook():
    """Three claims through ``ClaimServingStep`` on the CPU, the last one
    tampered in rotation by the scenario's hook: its slot 15 is
    quarantined on every tampered cycle, and the two siblings' outputs
    are bit for bit those of a run without the hook."""
    names = ("alpha", "beta", "gamma")
    tamper, seen = _scenario_hook(KINDS)

    def run(hook):
        specs = [ClaimSpec(cid, seed=i, n_oracles=N_ORACLES, n_failing=4,
                           tamper=hook if cid == names[-1] else None)
                 for i, cid in enumerate(names)]
        step = ClaimServingStep(specs, TINY_TEST, rows=8, seq=32, max_seg=4, params_dtype=None,
                                device="cpu")
        return [step([Request(cid, f"{cid} says {c} {i}") for i in range(2) for cid in names])[0]
                for c in range(len(KINDS))]

    tampered, clean = run(tamper), run(None)
    assert [s[0] for s in seen] == list(range(len(KINDS)))
    for kind, res, ref in zip(KINDS, tampered, clean):
        assert res.claims == names
        assert bool(res.ok[-1, SLOT]) == (kind is None) and bool(res.ok[:, :SLOT].all())
        assert torch.isfinite(res.out.essence).all()
        for field in res.out._fields:
            assert torch.equal(getattr(res.out, field)[:-1], getattr(ref.out, field)[:-1]), field
