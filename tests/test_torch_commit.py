"""The port's contract simulator and its certified batched commit against
the JAX package's, on the CPU.

- The three Cairo fixture scenarios of ``tests/test_cairo_fixtures.py``
  (deploy, the inactive zero state, seven predictions, the consensus,
  the replacement vote) on the port's contract: its state equals the
  reference contract's after every step.
- The batched commit against the sequential tx loop on twin port
  contracts, mirroring ``tests/test_batch_commit.py`` case for case,
  with the reference's batched contract beside them: the same final
  state, the same committed count and panic, and the same route
  (certified, or the same ``BatchNotCertified`` reason under
  ``on_uncertified="raise"``).
- ``prefix_margins_sweep`` against the reference's jitted sweep: rel₁,
  rel₂ and both sqrt arguments within 1e-5, the min variance and the
  boundary gap within 1e-6 absolute, and ``certify``'s booleans
  identical, also where ``boundary_gap`` rejects prefixes (N = 256).
- The contract's ``device``: ``None`` means CUDA, and without a card the
  first sweep raises before any state changes; nothing sweeps on the
  CPU unless asked.
"""

import copy

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp

from svoc_tpu.consensus import batch as ref_batch
from svoc_tpu.consensus.kernel import ConsensusConfig as RefConfig
from svoc_tpu.consensus.state import BatchTxError as RefBatchTxError
from svoc_tpu.consensus.state import OracleConsensusContract as RefContract
from test_cairo_fixtures import (
    ADMINS as FIXTURE_ADMINS,
    CONSTRAINED_2D,
    CONSTRAINED_6D,
    ORACLES as FIXTURE_ORACLES,
    UNCONSTRAINED_2D,
)

from svoc_torch.consensus import batch
from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.consensus.state import (
    BatchNotCertified,
    BatchTxError,
    ContractError,
    OracleConsensusContract,
)

ADMINS = ["a0", "a1", "a2"]


def contract_state(c):
    """Every field of a contract, as plain Python values."""
    return {
        "consensus_active": c.consensus_active,
        "value": list(c.consensus_value),
        "rel1": c.reliability_first_pass,
        "rel2": c.reliability_second_pass,
        "skew": list(c.skewness),
        "kurt": list(c.kurtosis),
        "oracles": [(o.address, o.enabled, o.reliable, list(o.value)) for o in c.oracles],
        "n_active": c.n_active_oracles,
        "admins": list(c.admins),
        "votes": dict(c.vote_matrix),
        "propositions": list(c.replacement_propositions),
    }


def outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # the exception is what is compared
        return ("raise", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# The Cairo fixture scenarios (test_contract.cairo), step by step.
# ---------------------------------------------------------------------------

SCENARIOS = {
    "constrained_2d": (CONSTRAINED_2D, dict(constrained=True, dimension=2)),
    "unconstrained_2d": (UNCONSTRAINED_2D, dict(constrained=False, unconstrained_max_spread=10.0,
                                                dimension=2)),
    "constrained_6d": (CONSTRAINED_6D, dict(constrained=True, dimension=6)),
}


def _fixture_pair(kw):
    common = dict(admins=FIXTURE_ADMINS, oracles=list(FIXTURE_ORACLES), enable_oracle_replacement=True,
                  required_majority=2, n_failing_oracles=2, **kw)
    return RefContract(**common), OracleConsensusContract(**common, device="cpu")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cairo_fixture_scenario_state_after_every_step(scenario):
    predictions, kw = SCENARIOS[scenario]
    ref, port = _fixture_pair(kw)
    steps = [("deploy", None)]
    steps += [("update_prediction", (FIXTURE_ORACLES[i], p)) for i, p in enumerate(predictions)]
    # The replacement vote (test_contract.cairo:192-213), then its refusals.
    steps += [
        ("update_proposition", ("Akashi", (6, "oracle_XX"))),
        ("vote_for_a_proposition", ("Akashi", 0, True)),
        ("vote_for_a_proposition", ("Ozu", 0, True)),
        ("update_proposition", ("nobody", (1, "oracle_YY"))),
        ("update_proposition", ("Ozu", (99, "oracle_YY"))),
        ("update_proposition", ("Ozu", (1, "oracle_XX"))),
        ("update_proposition", ("Higuchi", (2, "oracle_ZZ"))),
        ("vote_for_a_proposition", ("Ozu", 2, False)),
        ("update_proposition", ("Higuchi", None)),
        ("vote_for_a_proposition", ("Akashi", 2, True)),
        ("vote_for_a_proposition", ("Ozu", 2, True)),
        ("update_prediction", ("oracle_XX", predictions[6])),
        ("update_prediction", ("oracle_06", predictions[6])),
        ("update_prediction", (FIXTURE_ORACLES[0], predictions[0][:1])),
    ]
    for name, args in steps:
        if name == "update_prediction":
            caller, pred = args
            r = outcome(ref.update_prediction, caller, pred, encoding="wsad")
            p = outcome(port.update_prediction, caller, pred, encoding="wsad")
        elif name != "deploy":
            r, p = outcome(getattr(ref, name), *args), outcome(getattr(port, name), *args)
        else:
            r = p = ("ok", None)
        assert r == p, (name, args)
        assert contract_state(ref) == contract_state(port), (name, args)
        for getter in ("get_consensus_value", "get_skewness", "get_kurtosis",
                       "get_first_pass_consensus_reliability", "get_second_pass_consensus_reliability"):
            assert getattr(ref, getter)(as_floats=True) == getattr(port, getter)(as_floats=True)
    assert port.consensus_active and port.get_oracle_list()[6] == "oracle_XX"
    assert port.get_oracle_value_list("Akashi") == ref.get_oracle_value_list("Akashi")
    assert outcome(port.get_oracle_value_list, "oracle_00") == outcome(ref.get_oracle_value_list, "oracle_00")


def test_contract_refusals_equal_reference():
    ref, port = _fixture_pair(dict(constrained=True, dimension=2))
    for caller, pred, encoding in [
        ("oracle_00", [1_500_000, 0], "wsad"),  # interval
        ("eve", [1, 2], "wsad"),  # not an oracle
        ("oracle_00", [1, 2, 3], "wsad"),  # wrong dimension
        ("oracle_00", [0.5, 0.25], "hex"),  # unknown encoding
        ("oracle_00", [2**127, 0], "felt"),  # the dead zone between the felt windows
        ("oracle_00", [0.5, 0.25], "float"),
    ]:
        assert outcome(ref.update_prediction, caller, pred, encoding=encoding) == outcome(
            port.update_prediction, caller, pred, encoding=encoding), (caller, pred, encoding)
        assert contract_state(ref) == contract_state(port)
    disabled = [RefContract(ADMINS, ["o0"], enable_oracle_replacement=False),
                OracleConsensusContract(ADMINS, ["o0"], enable_oracle_replacement=False)]
    for fn in ("get_replacement_propositions",):
        assert outcome(getattr(disabled[0], fn)) == outcome(getattr(disabled[1], fn))
    assert outcome(disabled[0].vote_for_a_proposition, "a0", 0, True) == outcome(
        disabled[1].vote_for_a_proposition, "a0", 0, True)
    with pytest.raises(ContractError, match="replacement disabled"):
        disabled[1].get_a_specific_proposition(0)


# ---------------------------------------------------------------------------
# Batched against sequential (tests/test_batch_commit.py), beside the
# reference's batched contract.
# ---------------------------------------------------------------------------


def make_trio(n_oracles, n_failing, dimension=3, constrained=True, spread=10.0):
    """Port sequential, port batched, reference batched."""
    kw = dict(required_majority=2, n_failing_oracles=n_failing, constrained=constrained,
              unconstrained_max_spread=spread, dimension=dimension)
    oracles = [f"o{i}" for i in range(n_oracles)]
    return (OracleConsensusContract(ADMINS, oracles, device="cpu", **kw),
            OracleConsensusContract(ADMINS, oracles, device="cpu", **kw),
            RefContract(ADMINS, oracles, **kw))


def fleet(rng, n, m, lo=0.05, hi=0.95):
    return rng.uniform(lo, hi, size=(n, m))


def run_sequential(c, callers, preds):
    for k, (caller, p) in enumerate(zip(callers, preds)):
        try:
            c.update_prediction(caller, p)
        except Exception as e:
            return k, e
    return len(callers), None


def run_batch(c, callers, preds):
    try:
        return c.update_predictions_batch(callers, preds), None
    except (BatchTxError, RefBatchTxError) as e:
        return e.index, e


def route(c, callers, preds):
    """What ``on_uncertified="raise"`` does on a copy of ``c``: the
    route, or the ``BatchNotCertified`` reason."""
    twin = copy.deepcopy(c)
    try:
        twin.update_predictions_batch(callers, preds, on_uncertified="raise")
    except Exception as e:
        if type(e).__name__ == "BatchNotCertified":
            return ("uncertified", str(e))
        return ("tx error", type(e).__name__, getattr(e, "index", None))
    return ("certified",)


def cycle(trio, callers, preds):
    """One commit cycle on all three contracts; checks they agree and
    returns the route and the sequential result."""
    seq, bat, ref = trio
    routes = route(bat, callers, preds), route(ref, callers, preds)
    assert routes[0] == routes[1]
    rs, rb, rr = (run_sequential(seq, callers, preds), run_batch(bat, callers, preds),
                  run_batch(ref, callers, preds))
    assert rs[0] == rb[0] == rr[0]
    assert (rs[1] is None) == (rb[1] is None) == (rr[1] is None)
    if rb[1] is not None:
        assert type(rb[1].cause).__name__ == type(rr[1].cause).__name__ == type(rs[1]).__name__
        assert rb[1].index == rr[1].index and rb[1].oracle_address == rr[1].oracle_address
    assert contract_state(seq) == contract_state(bat) == contract_state(ref)
    return routes[0], rs, rb


@pytest.mark.parametrize("n,n_failing", [(7, 2), (13, 4), (8, 0)])
@pytest.mark.parametrize("constrained", [True, False])
def test_batch_equals_sequential_two_cycles(n, n_failing, constrained):
    rng = np.random.default_rng(n * 100 + n_failing + constrained)
    trio = make_trio(n, n_failing, constrained=constrained)
    callers = [f"o{i}" for i in range(n)]
    routes = [cycle(trio, callers, fleet(rng, n, 3))[0] for _ in range(3)]
    assert routes[1:] == [("certified",)] * 2


def test_fast_path_is_actually_taken(monkeypatch):
    rng = np.random.default_rng(0)
    _, bat, _ = make_trio(7, 2)
    callers = [f"o{i}" for i in range(7)]
    sweeps = []
    real_sweep = batch.prefix_margins_sweep
    monkeypatch.setattr(batch, "prefix_margins_sweep",
                        lambda *a, **k: sweeps.append(a[-1].shape) or real_sweep(*a, **k))

    def boom(*a, **k):
        raise AssertionError("fell back to the sequential path")

    monkeypatch.setattr(bat, "_sequential_batch", boom)
    bat.update_predictions_batch(callers, fleet(rng, 7, 3))  # activation: no sweep
    bat.update_predictions_batch(callers, fleet(rng, 7, 3))  # 6 prefixes, bucketed to 8
    assert bat.consensus_active and sweeps == [torch.Size([8])]


def test_validation_failure_mid_batch_commits_prefix():
    rng = np.random.default_rng(1)
    trio = make_trio(7, 2)
    callers = [f"o{i}" for i in range(7)]
    preds = fleet(rng, 7, 3)
    preds[4] = [1.5, 0.5, 0.5]
    _, rs, rb = cycle(trio, callers, preds)
    assert rs[0] == 4 and rb[1].oracle_address == "o4" and "interval" in str(rb[1].cause)


def test_unknown_caller_mid_batch():
    rng = np.random.default_rng(2)
    trio = make_trio(7, 2)
    _, rs, rb = cycle(trio, [f"o{i}" for i in range(6)] + ["eve"], fleet(rng, 7, 3))
    assert rs[0] == 6 and "not an oracle" in str(rb[1].cause)


def test_final_recompute_panic_reverts_last_tx():
    trio = make_trio(7, 2)
    preds = [[0.5 + i * 1e-6, 0.5, 0.5] for i in range(7)]
    _, rs, rb = cycle(trio, [f"o{i}" for i in range(7)], preds)
    assert rs[0] == 6 and isinstance(rb[1].cause, ZeroDivisionError)
    assert trio[1].consensus_active is False and trio[1].n_active_oracles == 6


def test_intermediate_panic_falls_back_to_exact():
    rng = np.random.default_rng(3)
    trio = make_trio(7, 2, dimension=2)
    callers = [f"o{i}" for i in range(7)]
    cycle(trio, callers, fleet(rng, 7, 2))
    routed, rs, rb = cycle(trio, callers, [[1.0, 1.0]] * 5 + [[0.0, 0.0]] * 2)
    assert routed == ("uncertified", "device certification failed")
    assert rs[0] == 4 and isinstance(rb[1].cause, ZeroDivisionError)


def test_final_panic_after_intermediates_leaves_prefix_consensus(monkeypatch):
    rng = np.random.default_rng(9)
    trio = make_trio(7, 2)
    callers = [f"o{i}" for i in range(7)]
    c0 = [0.4, 0.5, 0.6]
    base = fleet(rng, 7, 3)
    for c in trio:
        for i in range(1, 7):
            c.update_prediction(f"o{i}", base[i])
    preds = [list(base[0]), list(base[1]), c0, c0, c0, c0, c0]
    boom = AssertionError("fell back to the sequential path")
    monkeypatch.setattr(trio[1], "_sequential_batch", lambda *a, **k: (_ for _ in ()).throw(boom))
    routed, rs, rb = cycle(trio, callers, preds)
    assert routed == ("tx error", "BatchTxError", 6)
    assert rs[0] == 6 and isinstance(rb[1].cause, ZeroDivisionError)
    assert trio[1].consensus_active is True


def test_malformed_element_is_a_tx_failure():
    rng = np.random.default_rng(10)
    trio = make_trio(7, 2)
    preds = [list(p) for p in fleet(rng, 7, 3)]
    preds[5][0] = "not-a-number"
    _, rs, rb = cycle(trio, [f"o{i}" for i in range(7)], preds)
    assert rs[0] == 5 and isinstance(rb[1].cause, (TypeError, ValueError))
    for c in trio[1:]:
        with pytest.raises(ValueError):
            c.update_predictions_batch(["o0"], fleet(rng, 1, 3), encoding="hex")
        with pytest.raises(ValueError):
            c.update_predictions_batch(["o0"], fleet(rng, 1, 3), on_uncertified="skip")


def test_tiny_reliable_subset_panics_at_the_right_tx():
    rng = np.random.default_rng(11)
    trio = make_trio(6, 3)
    routed, rs, rb = cycle(trio, [f"o{i}" for i in range(6)], fleet(rng, 6, 3))
    assert routed == ("uncertified", "reliable subset <= 3")
    assert rs[0] == 5 and isinstance(rb[1].cause, ZeroDivisionError)


def test_large_magnitude_unconstrained_falls_back():
    n = 64
    trio = make_trio(n, 8, constrained=False, spread=1e9)
    callers = [f"o{i}" for i in range(n)]
    rng = np.random.default_rng(13)
    cycle(trio, callers, 12000.0 + fleet(rng, n, 3))
    routed, rs, rb = cycle(trio, callers, [[12000.0 + i * 1e-6, 0.5, 0.5] for i in range(n)])
    assert routed == ("uncertified", "value magnitude beyond f32 guard bands")
    assert isinstance(rb[1].cause, ZeroDivisionError)


def test_rederive_failure_never_masks_the_tx_error(monkeypatch):
    n = 7
    _, bat, _ = make_trio(n, 2)
    callers = [f"o{i}" for i in range(n)]
    rng = np.random.default_rng(14)
    run_batch(bat, callers, fleet(rng, n, 3))
    monkeypatch.setattr(batch, "certify", lambda *a, **k: np.ones(10_000, dtype=bool))
    committed, err = run_batch(bat, callers, [[0.5 + i * 1e-6, 0.5, 0.5] for i in range(n)])
    assert committed == n - 1 and isinstance(err.cause, ZeroDivisionError)


def test_duplicate_caller_falls_back():
    rng = np.random.default_rng(4)
    trio = make_trio(7, 2)
    cycle(trio, [f"o{i}" for i in range(7)], fleet(rng, 7, 3))
    routed, rs, _ = cycle(trio, ["o0", "o1", "o1", "o3", "o4", "o5", "o6"], fleet(rng, 7, 3))
    assert routed == ("uncertified", "duplicate caller") and rs[0] == 7


def test_gate_never_opens_and_partial_batches():
    rng = np.random.default_rng(16)
    trio = make_trio(13, 4)
    callers = [f"o{i}" for i in range(13)]
    preds = fleet(rng, 13, 3)
    assert cycle(trio, callers[:9], preds[:9])[0] == ("certified",)  # under the gate
    assert trio[1].consensus_active is False
    cycle(trio, callers[9:], preds[9:])  # opens the gate on its last tx
    cycle(trio, callers[3:8], fleet(rng, 5, 3))  # a partial cycle: 4 swept prefixes
    assert cycle(trio, [], [])[1] == (0, None)


def test_batch_equals_sequential_fleet_64():
    rng = np.random.default_rng(5)
    n = 64
    trio = make_trio(n, 16, dimension=6)
    callers = [f"o{i}" for i in range(n)]
    for _ in range(2):
        routed, rs, rb = cycle(trio, callers, fleet(rng, n, 6))
        assert routed == ("certified",) and rs == (n, None) and rb == (n, None)


# ---------------------------------------------------------------------------
# The sweep against the reference's.
# ---------------------------------------------------------------------------


def _sweep_inputs(seed, n, lo=0.05, hi=0.95, shuffle=True):
    rng = np.random.default_rng(seed)
    old = rng.uniform(lo, hi, (n, 6)).astype(np.float32)
    new = rng.uniform(lo, hi, (n, 6)).astype(np.float32)
    pos = (rng.permutation(n) if shuffle else np.arange(n)).astype(np.int32)
    ks = np.arange(1, n, dtype=np.int32)
    k_bucket = 8
    while k_bucket < ks.size:
        k_bucket *= 2
    ks = np.concatenate([ks, np.full(k_bucket - ks.size, ks[-1], np.int32)])
    return old, new, pos, ks


def compare_sweeps(old, new, pos, ks, n_failing, constrained=True, max_spread=10.0,
                   strict_interval=True):
    ref_cfg = RefConfig(n_failing=n_failing, constrained=constrained, max_spread=max_spread,
                        smooth_mode="cairo")
    cfg = ConsensusConfig(n_failing=n_failing, constrained=constrained, max_spread=max_spread,
                          smooth_mode="cairo")
    ref = ref_batch.prefix_margins_sweep(*(jnp.asarray(a) for a in (old, new, pos)), ref_cfg,
                                         jnp.asarray(ks))
    got = batch.prefix_margins_sweep(*(torch.from_numpy(a) for a in (old, new, pos)), cfg,
                                     torch.from_numpy(ks))
    for name, bar in [("rel1", 1e-5), ("rel2", 1e-5), ("sqrt_arg1", 1e-5), ("sqrt_arg2", 1e-5),
                      ("min_variance", 1e-6), ("boundary_gap", 1e-6)]:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert b.dtype == np.float32 and b.shape == (ks.size,)
        finite = np.isfinite(a)
        assert np.array_equal(finite, np.isfinite(b)), name
        assert np.max(np.abs(a[finite] - b[finite]), initial=0.0) <= bar, name
    safe_ref = ref_batch.certify(ref, ref_cfg, strict_interval)
    safe = batch.certify(got, cfg, strict_interval)
    assert safe.dtype == bool and np.array_equal(safe_ref, safe)
    return safe, got


@pytest.mark.parametrize("n,n_failing,constrained", [(7, 2, True), (64, 16, True), (64, 8, False),
                                                     (64, 0, True), (100, 25, False)])
def test_sweep_equals_reference(n, n_failing, constrained):
    old, new, pos, ks = _sweep_inputs(n, n)
    if not constrained:  # signed values of O(1), as the absolute bars assume
        old, new = old * 3 - 1.5, new * 3 - 1.5
    compare_sweeps(old, new, pos, ks, n_failing, constrained, max_spread=2.0)


@pytest.mark.parametrize("seed", [0, 5])
def test_boundary_gap_rejects_as_the_reference_does_at_256(seed):
    """Uniform fleets at N = 256, n_failing 32: the gap at the cut falls
    under 1e-5 on some prefixes, and both packages reject the same ones."""
    old, new, pos, ks = _sweep_inputs(seed, 256, shuffle=False)
    safe, got = compare_sweeps(old, new, pos, ks, 32)
    rejected = ~safe
    assert 0 < rejected.sum() < ks.size
    assert np.all(got.boundary_gap.numpy()[rejected] <= 1e-5)


@pytest.mark.parametrize("case", ["zero_spread", "lenient", "degenerate"])
def test_certify_bands_equal_reference(case):
    old, new, pos, ks = _sweep_inputs(7, 32)
    kw = dict(n_failing=8)
    if case == "zero_spread":
        kw.update(constrained=False, max_spread=0.0)
    elif case == "lenient":
        kw.update(strict_interval=False)
    else:  # every row one value: zero variance, sqrt arguments 0
        new[:] = 0.5
        old[:] = 0.5
    safe, _ = compare_sweeps(old, new, pos, ks, **kw)
    assert (not safe.any()) == (case != "lenient")


# ---------------------------------------------------------------------------
# The device the sweep runs on.
# ---------------------------------------------------------------------------


def test_default_device_is_cuda_and_the_first_sweep_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sweeps = []
    monkeypatch.setattr(batch, "prefix_margins_sweep", lambda *a, **k: sweeps.append(a))
    rng = np.random.default_rng(17)
    n = 13
    callers = [f"o{i}" for i in range(n)]
    c = OracleConsensusContract(ADMINS, callers, n_failing_oracles=4, dimension=3)
    assert c.device is None
    c.update_predictions_batch(callers, fleet(rng, n, 3))  # activation: golden only
    for i in range(n):  # the per-tx loop: golden only
        c.update_prediction(callers[i], fleet(rng, 1, 3)[0])
    small = OracleConsensusContract(ADMINS, callers[:6], n_failing_oracles=3, dimension=3)
    with pytest.raises(BatchTxError):  # a reliable subset of 3 never sweeps
        small.update_predictions_batch(callers[:6], fleet(rng, 6, 3))
    before = contract_state(c)
    with pytest.raises(RuntimeError, match="CUDA"):
        c.update_predictions_batch(callers, fleet(rng, n, 3))
    assert contract_state(c) == before and sweeps == []


def test_the_sweep_runs_on_the_contract_device(monkeypatch):
    seen = []
    real = batch.prefix_margins_sweep

    def spy(old, new, pos, cfg, ks):
        seen.append({t.device.type for t in (old, new, pos, ks)})
        return real(old, new, pos, cfg, ks)

    monkeypatch.setattr(batch, "prefix_margins_sweep", spy)
    rng = np.random.default_rng(18)
    callers = [f"o{i}" for i in range(13)]
    c = OracleConsensusContract(ADMINS, callers, n_failing_oracles=4, dimension=3,
                                device=torch.device("cpu"))
    for _ in range(2):
        c.update_predictions_batch(callers, fleet(rng, 13, 3))
    assert seen == [{"cpu"}]
    with pytest.raises(BatchNotCertified):
        c.update_predictions_batch(["o0", "o0"], fleet(rng, 2, 3), on_uncertified="raise")
