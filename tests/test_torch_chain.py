"""The port's chain adapter, deployment calldata and Starknet backend
against the JAX package's, on the CPU; and the tiny slice from comments
to chain state.

- The adapter over ``LocalChainBackend`` against the reference's adapter
  after the same per-tx, batched and one-RPC commits: every ``call_*``
  read, ``resume``, ``ChainCommitError``'s accounting on a codec failure
  and on a panic, the auto threshold (63 against 64 oracles), the
  fall-through to the per-tx loop when a batch is not certified, the
  counters ``chain_commit_rpcs{mode}`` and ``commit_batch_fallback``,
  the WAL hooks, and the ``fault_point`` names an armed controller sees.
- Constructor calldata both ways, and ``simulator_from_calldata``.
- ``StarknetBackend`` against the fake ``starknet_py`` of
  ``tests/test_starknet_backend.py``: the same calls, calldata felts,
  resource bounds and per-oracle tx order as the reference's.
- The tiny flagship (flax's TINY_TEST weights, the fleet keyed from one
  key): the vectors within 1e-4 of JAX's, the fleet equal to
  ``gen_oracle_predictions`` on the same window bit for bit, and that
  fleet committed through both packages' adapters (N = 64, n_failing =
  16, so the batched route and its sweep run) to identical chain state.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

import svoc_tpu.durability.faultspace as ref_faultspace
import svoc_tpu.io.chain as ref_chain
import svoc_tpu.io.deploy as ref_deploy
from svoc_tpu.consensus.state import OracleConsensusContract as RefContract
from svoc_tpu.utils.metrics import registry as ref_registry
from test_starknet_backend import (  # the reference's fake starknet_py
    FakeAccount,
    FakeFullNodeClient,
    FakeFunction,
    FakeKeyPair,
    FakeResourceBounds,
    RESOURCE_BOUND,
    _write_sepolia_json,
    fake_starknet,  # noqa: F401  (a fixture)
)

import svoc_torch.durability.faultspace as faultspace
import svoc_torch.io.chain as chain
import svoc_torch.io.deploy as deploy
from svoc_torch.consensus.state import OracleConsensusContract
from svoc_torch.ops.fixedpoint import FELT_PRIME
from svoc_torch.utils.metrics import registry

ADMINS = [0xA0, 0xA1, 0xA2]
PACKAGES = {"ref": (ref_chain, RefContract, ref_registry), "port": (chain, OracleConsensusContract, registry)}


def build(pkg, n, n_failing=None, dimension=3, **kw):
    """An adapter over a fresh local contract of ``n`` oracles."""
    chain_mod, contract_cls, _ = PACKAGES[pkg]
    if pkg == "port":
        kw["device"] = "cpu"
    contract = contract_cls(ADMINS, [0x10 + i for i in range(n)],
                            n_failing_oracles=max(2, n // 8) if n_failing is None else n_failing,
                            dimension=dimension, **kw)
    return chain_mod.ChainAdapter(chain_mod.LocalChainBackend(contract))


def counters(pkg):
    reg = PACKAGES[pkg][2]
    return {f"{name}{labels}": reg.counter(name, labels=labels).count
            for name, labels in [("chain_commit_rpcs", {"mode": "tx"}),
                                 ("chain_commit_rpcs", {"mode": "batch"}),
                                 ("commit_batch_fallback", {"reason": "uncertified"})]}


def reads(adapter):
    """Every read of the adapter, with the cache it leaves."""
    out = {name: getattr(adapter, name)() for name in (
        "call_consensus", "call_skewness", "call_kurtosis", "call_first_pass_consensus_reliability",
        "call_second_pass_consensus_reliability", "peek_second_pass_reliability",
        "call_consensus_active", "call_admin_list", "call_oracle_list", "call_dimension",
        "call_replacement_propositions", "get_the_predictions")}
    out["value_list"] = adapter.call_oracle_value_list(ADMINS[1])
    out["value_list_wsad"] = adapter.call_oracle_value_list_wsad(ADMINS[2])
    out["resume"] = adapter.resume()
    out["slot"] = adapter.get_the_prediction(len(out["call_oracle_list"]) - 1)
    out["index"] = (adapter.address_to_oracle_index(0x11), adapter.oracle_index_to_address(2),
                    adapter.address_to_admin_index(0xA2), adapter.admin_index_to_address(0))
    out["trend"] = {k: v for k, v in adapter.rel2_trend().items() if k != "delta"}
    out["cache"] = adapter.cache_snapshot()
    with pytest.raises(IndexError):
        adapter.get_the_prediction(10_000)
    return out


def outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # the exception is what is compared
        fields = ("committed", "total", "failed_oracle", "sent_count", "reason")
        return ("raise", type(e).__name__, {f: getattr(e, f, None) for f in fields},
                type(getattr(e, "cause", None)).__name__)


def commit(adapter, mode, preds, **kw):
    if mode == "plane":
        return adapter.update_predictions_batched(preds, **kw)
    return adapter.update_all_the_predictions(preds, batch={"tx": False, "batch": True, "auto": None}[mode], **kw)


def both(fn):
    """``fn(pkg)`` for both packages, with the counters' deltas."""
    results = {}
    for pkg in PACKAGES:
        before = counters(pkg)
        result = fn(pkg)
        after = counters(pkg)
        results[pkg] = (result, {k: after[k] - before[k] for k in after})
    return results["ref"], results["port"]


@pytest.mark.parametrize("n,mode", [(7, "tx"), (7, "batch"), (64, "batch"), (64, "auto"), (64, "plane"),
                                    (13, "plane")])
def test_adapter_reads_after_commits_equal_reference(n, mode):
    rng = np.random.default_rng(n)
    cycles = [rng.uniform(0.05, 0.95, (n, 3)) for _ in range(2)]

    def run(pkg):
        a = build(pkg, n)
        sent = [outcome(commit, a, mode, preds) for preds in cycles]
        return sent, reads(a)

    ref, port = both(run)
    assert ref == port
    assert port[0][0] == [("ok", n), ("ok", n)]
    rpcs = port[1]
    assert rpcs["chain_commit_rpcs{'mode': 'tx'}"] == (2 * n if mode == "tx" or (mode == "auto" and n < 64) else 0)


@pytest.mark.parametrize("mode", ["tx", "batch", "plane"])
@pytest.mark.parametrize("fault", ["codec", "panic", "interval"])
def test_commit_error_accounting_equals_reference(mode, fault):
    n = 64
    rng = np.random.default_rng(15)
    good = rng.uniform(0.05, 0.95, (n, 3))
    bad = good.copy()
    if fault == "codec":
        bad[40, 0] = np.nan
    elif fault == "interval":
        bad[4] = [1.5, 0.5, 0.5]
    else:  # identical rows: the golden engine divides by a zero variance
        bad[:] = 0.5

    def run(pkg):
        a = build(pkg, n, n_failing=8)
        first = outcome(commit, a, mode, good)
        second = outcome(commit, a, mode, bad, start=2)
        return first, second, reads(a), a.backend.contract.n_active_oracles

    ref, port = both(run)
    assert ref == port
    assert port[0][1][0] == "raise"


@pytest.mark.parametrize("n", [63, 64])
def test_auto_threshold_equals_reference(n):
    rng = np.random.default_rng(8)
    preds = rng.uniform(0.05, 0.95, (n, 3))

    def run(pkg):
        a = build(pkg, n, n_failing=8)
        calls = []
        contract = a.backend.contract
        orig = contract.update_predictions_batch
        contract.update_predictions_batch = lambda *a_, **k: (calls.append("batch"), orig(*a_, **k))[1]
        return a.update_all_the_predictions(preds), calls, reads(a)

    ref, port = both(run)
    assert ref == port
    assert port[0][1] == ([] if n == 63 else ["batch"])
    assert chain.ChainAdapter.BATCH_COMMIT_THRESHOLD == ref_chain.ChainAdapter.BATCH_COMMIT_THRESHOLD == 64


@pytest.mark.parametrize("mode", ["batch", "plane"])
def test_uncertified_batch_falls_through_as_reference(mode):
    """After a varied activation cycle, 64 identical rows: late prefixes
    have a zero-variance reliable subset, so certification fails; the
    adapter runs the per-tx loop (counted) and raises the loop's error,
    and the one-RPC plane runs the exact engine inside its one call."""
    n = 64
    rng = np.random.default_rng(12)
    base = rng.uniform(0.05, 0.95, (n, 3))
    preds = np.tile(rng.uniform(0.2, 0.8, size=3), (n, 1))

    def run(pkg):
        a = build(pkg, n, n_failing=8)
        return outcome(commit, a, mode, base), outcome(commit, a, mode, preds), reads(a)

    ref, port = both(run)
    assert ref == port
    assert port[0][1][:2] == ("raise", "ChainCommitError")
    fallbacks = port[1]["commit_batch_fallback{'reason': 'uncertified'}"]
    assert fallbacks == (1 if mode == "batch" else 0)


def test_plane_refusals_equal_reference():
    def run(pkg):
        chain_mod = PACKAGES[pkg][0]
        a = build(pkg, 7)
        preds = np.full((7, 3), 0.5)
        skip = outcome(a.update_predictions_batched, preds, skip=[3])
        raising = chain_mod.LocalChainBackend(a.backend.contract)
        raising.update_predictions_batched = lambda c, p: raising.invoke_update_predictions_batch(c, p)
        a.backend = raising
        rng = np.random.default_rng(1)
        a.update_all_the_predictions(rng.uniform(0.05, 0.95, (7, 3)))
        uncertified = outcome(a.update_predictions_batched, [[0.5, 0.5, 0.5]] * 7)
        a.backend = type("NoBatch", (), {"call": a.backend.call, "invoke": a.backend.invoke})()
        unsupported = outcome(a.update_predictions_batched, preds)
        bad_start = outcome(build(pkg, 7).update_predictions_batched, preds, start=9)
        misuse = [outcome(build(pkg, 7).update_all_the_predictions, preds, **kw) for kw in (
            dict(batch=True, skip=[1]), dict(batch=True, on_intent=lambda *a: None),
            dict(skip=[99]), dict(start=-1))]
        no_batch = build(pkg, 7)
        no_batch.backend = type("NoBatch", (), {"call": no_batch.backend.call,
                                                "invoke": no_batch.backend.invoke})()
        misuse.append(outcome(no_batch.update_all_the_predictions, preds, batch=True))
        return skip, uncertified, unsupported, bad_start, misuse

    ref, port = both(run)
    assert ref == port
    assert [r[2]["reason"] for r in port[0][:3]] == ["skip_slots", "uncertified", "unsupported"]


def test_skip_start_and_wal_hooks_equal_reference():
    n = 13
    rng = np.random.default_rng(19)
    preds = rng.uniform(0.05, 0.95, (n, 3))

    class Wal:
        def __init__(self, log):
            self.log = log

        def intent_batch(self, slots):
            self.log.append(("intent_batch", list(slots)))

        def landed_batch(self, slots):
            self.log.append(("landed_batch", list(slots)))

    def run(pkg):
        a = build(pkg, n)
        log = []
        sent = [
            a.update_all_the_predictions(preds, skip=[2, 5]),
            a.update_all_the_predictions(preds, start=4, on_intent=lambda i, o, f: log.append(("intent", i, o, f)),
                                         on_landed=lambda i: log.append(("landed", i))),
            a.update_predictions_batched(preds, start=3, wal=Wal(log)),
        ]
        bad = preds.copy()
        bad[9] = [1.5, 0.5, 0.5]
        sent.append(outcome(a.update_predictions_batched, bad, wal=Wal(log)))
        bad[9, 0] = np.nan
        sent.append(outcome(a.update_all_the_predictions, bad, on_intent=lambda i, o, f: log.append(i)))
        return sent, log, reads(a)

    ref, port = both(run)
    assert ref == port
    assert port[0][0][:3] == [n - 2, n - 4, n - 3]


def test_fault_points_seen_by_an_armed_controller_equal_reference():
    class Stub:
        """Records every firing; raises at the ``fail_at``-th."""

        def __init__(self, fail_at=None):
            self.seen, self.fail_at, self.closed = [], fail_at, False

        def fire(self, name, *, payload=None, torn=None):
            self.seen.append((name, payload))
            if len(self.seen) == self.fail_at:
                raise ConnectionError(f"injected at {name}")

        def close(self):
            self.closed = True

    rng = np.random.default_rng(20)
    small, large = rng.uniform(0.05, 0.95, (7, 3)), rng.uniform(0.05, 0.95, (64, 3))

    def run(pkg):
        space = ref_faultspace if pkg == "ref" else faultspace
        results = []
        for fail_at in (None, 4, 10):
            stub = space.arm(Stub(fail_at))
            try:
                assert space.armed()
                a7, a64 = build(pkg, 7), build(pkg, 64)
                results.append([
                    outcome(a7.update_all_the_predictions, small),
                    outcome(a7.update_all_the_predictions, small, on_intent=lambda *x: None),
                    outcome(a64.update_all_the_predictions, large, batch=True),
                    outcome(a64.update_predictions_batched, large),
                    outcome(a7.invoke_update_prediction, 0x10, small[0]),
                ])
            finally:
                space.disarm()
            assert stub.closed and not space.armed()
            results.append(stub.seen)
        return results

    ref, port = both(run)
    assert ref == port
    seen = port[0][1]
    assert [name for name, _ in seen] == ["chain.tx.pre_invoke"] * 14 + ["chain.batch.pre_rpc"] + [
        "chain.tx.pre_invoke"]
    # The durability package declares its whole surface on import; the
    # adapter's two points are among it, with the reference's specs.
    assert {"chain.tx.pre_invoke", "chain.batch.pre_rpc"} <= set(faultspace.surface())
    assert set(faultspace.surface()) == set(faultspace.load_surface())
    for name, spec in faultspace.surface().items():
        ref_spec = ref_faultspace.surface()[name]
        assert (spec.actions, spec.smokes, spec.modes, spec.stage, spec.invariant) == (
            ref_spec.actions, ref_spec.smokes, ref_spec.modes, ref_spec.stage, ref_spec.invariant)
    with pytest.raises(RuntimeError, match="already armed"):
        faultspace.arm(Stub())
        faultspace.arm(Stub())
    faultspace.disarm()


def test_replacement_vote_through_the_adapter_equals_reference():
    def run(pkg):
        a = build(pkg, 7)
        steps = [
            outcome(a.invoke_update_proposition, 0xA0, 6, 0x99),
            outcome(a.invoke_vote_for_a_proposition, 0xA0, 0, True),
            outcome(a.call_replacement_propositions),
            outcome(a.invoke_vote_for_a_proposition, 0xA1, 0, True),
            outcome(a.call_oracle_list),
            outcome(a.invoke_update_proposition, 0xA1, 1, None),
            outcome(a.invoke_update_proposition, 0x10, 1, 0x98),
            outcome(a.invoke_update_proposition, 0xA2),
            outcome(a.invoke_vote_for_a_proposition, 0xA2, 2, True),
            outcome(a.invoke_vote_for_a_proposition, 0xA0, 2, True),
        ]
        disabled = build(pkg, 7, enable_oracle_replacement=False)
        return steps, reads(a), disabled.resume()["replacement_propositions"]

    ref, port = both(run)
    assert ref == port
    assert port[0][1]["call_oracle_list"][6] == 0x99


@pytest.mark.parametrize("constrained,spread", [(True, 0.0), (False, 10.0), (False, 0.25)])
def test_deploy_calldata_round_trips_as_reference(constrained, spread):
    kw = dict(admins=[1, 2, 3], oracles=list(range(10, 17)), enable_oracle_replacement=not constrained,
              required_majority=2, n_failing_oracles=2, constrained=constrained,
              unconstrained_max_spread=spread, dimension=2)
    cfg, ref_cfg = deploy.DeployConfig(**kw), ref_deploy.DeployConfig(**kw)
    calldata = deploy.constructor_calldata(cfg)
    assert calldata == ref_deploy.constructor_calldata(ref_cfg)
    assert deploy.constructor_args(cfg) == ref_deploy.constructor_args(ref_cfg)
    assert dataclasses.asdict(deploy.parse_constructor_calldata(calldata)) == dataclasses.asdict(
        ref_deploy.parse_constructor_calldata(calldata))
    assert deploy.constructor_calldata(deploy.parse_constructor_calldata(calldata)) == calldata
    port = deploy.simulator_from_calldata(calldata, device="cpu")
    ref = ref_deploy.simulator_from_calldata(calldata)
    assert port.device == "cpu" and deploy.simulator_from_calldata(calldata).device is None
    for attr in ("admins", "n_failing_oracles", "constrained", "unconstrained_max_spread", "dimension",
                 "enable_oracle_replacement", "required_majority"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.get_oracle_list() == ref.get_oracle_list()
    for bad in (calldata + [0], calldata[:-1]):
        a, b = outcome(deploy.parse_constructor_calldata, bad), outcome(ref_deploy.parse_constructor_calldata, bad)
        assert a[:2] == b[:2]


# ---------------------------------------------------------------------------
# StarknetBackend against the reference's fake starknet_py.
# ---------------------------------------------------------------------------


def _normal(entry):
    """A log entry with providers named by their address or node URL."""

    def name(x):
        if isinstance(x, (FakeAccount, FakeFullNodeClient)):
            return (type(x).__name__, getattr(x, "address", None) or getattr(x, "node_url", None))
        return x

    return tuple(name(x) for x in entry)


def _starknet_flow(chain_mod, deploy_mod, fake, tmp_path, flaky):
    """The reference's StarknetBackend tests as one flow: reads, a signed
    invoke, the adapter's per-oracle commit, an RPC failure mid-loop, the
    files bootstrap and declare/deploy."""
    oracle_addrs = [0x10, 0x11, 0x12, 0x13]
    accounts = {a: FakeAccount(None, hex(a), FakeKeyPair("k"), "SN_SEPOLIA") for a in oracle_addrs}
    backend = chain_mod.StarknetBackend("https://rpc.example", 0xDE9, accounts,
                                        client=FakeFullNodeClient("https://rpc.example"))
    fake.views.update(get_predictions_dimension=6, get_oracle_list=oracle_addrs)
    out = [backend.call("get_predictions_dimension")]
    backend.invoke(0x10, "update_prediction", prediction=[1, 2, 3])
    adapter = chain_mod.ChainAdapter(backend)
    out.append(adapter.update_all_the_predictions([[0.25, -0.5], [1.0, 2.5], [-0.000001, 0.0], [0.1, 0.2]]))
    flaky["at"] = 2
    out.append(outcome(adapter.update_all_the_predictions, [[0.1, 0.2]] * 4))
    flaky["at"] = None
    out.append(adapter.update_all_the_predictions([[0.1, 0.2]] * 4, start=2))
    out.append(outcome(adapter.update_all_the_predictions, [[0.1, 0.2]] * 4, batch=True))

    info = tmp_path / "contract_info.json"
    info.write_text('{"rpc": "https://rpc.example/sepolia", "declared_address": "0x123", '
                    '"deployed_address": "0x456"}')
    sepolia = tmp_path / "sepolia.json"
    _write_sepolia_json(sepolia)
    out.append(chain_mod.load_account_data(str(sepolia)))
    out.append(chain_mod.load_contract_info(str(info)))
    files = chain_mod.starknet_backend_from_files(str(info), str(sepolia))
    out.append((files.deployed_address, files.client.node_url, sorted(files.accounts)))
    accts = chain_mod.build_starknet_accounts(FakeFullNodeClient("u"), [{"address": "0xa0", "private_key": "0x1"}],
                                              [{"address": "0x10", "private_key": "0x2"}])
    out.append({k: (v.address, v.key_pair.key, v.chain) for k, v in accts.items()})

    log = fake.log

    class DeclareResult:
        class_hash = 0xC1A55

        async def wait_for_acceptance(self):
            log.append(("wait_for_acceptance", "declare"))

        async def deploy_v3(self, constructor_args, auto_estimate):
            log.append(("deploy_v3", constructor_args, auto_estimate))

            class DeployResult:
                deployed_contract = type("C", (), {"address": 0xDE9107})

                async def wait_for_acceptance(self):
                    log.append(("wait_for_acceptance", "deploy"))

            return DeployResult()

    async def declare_v3(account, compiled_contract, compiled_contract_casm, auto_estimate):
        log.append(("declare_v3", compiled_contract, compiled_contract_casm, auto_estimate))
        return DeclareResult()

    fake.declare_v3 = declare_v3
    cfg = deploy_mod.DeployConfig(admins=[1, 2, 3], oracles=list(range(10, 17)), constrained=False,
                                  unconstrained_max_spread=10.0)
    result = chain_mod.declare_and_deploy(object(), cfg, "SIERRA_JSON", "CASM_JSON")
    out.append(result.contract_info("https://rpc.example"))
    out.append((chain_mod.to_hex(255), chain_mod.from_hex("0xff"), chain_mod.RESOURCE_BOUND_L1_GAS))
    return out


def test_starknet_backend_equals_reference(fake_starknet, tmp_path, monkeypatch):  # noqa: F811
    flaky = {"at": None, "n": 0}
    orig = FakeFunction.invoke_v3

    async def flaky_invoke(self, **kwargs):
        if self._name == "update_prediction" and flaky["at"] is not None:
            flaky["n"] += 1
            if flaky["n"] == flaky["at"] + 1:
                raise ConnectionError("RPC node dropped the request")
        return await orig(self, **kwargs)

    monkeypatch.setattr(FakeFunction, "invoke_v3", flaky_invoke)
    runs = {}
    for pkg, (chain_mod, deploy_mod) in {"ref": (ref_chain, ref_deploy), "port": (chain, deploy)}.items():
        fake_starknet.log = []
        fake_starknet.views = {}
        flaky["n"] = 0
        out = _starknet_flow(chain_mod, deploy_mod, fake_starknet, tmp_path, flaky)
        runs[pkg] = (out, [_normal(e) for e in fake_starknet.log])
    assert runs["ref"] == runs["port"]
    out, log = runs["port"]
    invokes = [e for e in log if e[0] == "invoke_v3"]
    assert invokes[0][3] == {"prediction": [1, 2, 3], "l1_resource_bounds": FakeResourceBounds(*RESOURCE_BOUND)}
    sent = [e[3]["prediction"] for e in invokes[1:5]]
    assert sent[0] == [250000, FELT_PRIME - 500000] and sent[2] == [FELT_PRIME - 1, 0]
    assert [e[1][1] for e in invokes[1:5]] == ["0x10", "0x11", "0x12", "0x13"]
    assert out[2][2]["committed"] == 2 and out[4][1] == "ValueError"


# ---------------------------------------------------------------------------
# The tiny slice: comments → vectors → keyed fleet → chain state.
# ---------------------------------------------------------------------------


def test_tiny_slice_fleet_on_chain_equals_reference(monkeypatch):
    from svoc_tpu.models import configs as jax_configs
    from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder
    from svoc_tpu.models.packing import PackedSentimentEncoder as JaxPacked
    from svoc_tpu.models.sentiment import scores_to_vectors as jax_scores_to_vectors
    from svoc_tpu.ops.select import first_valid_window as jax_first_valid_window
    from svoc_tpu.sim.oracle import gen_oracle_predictions

    from svoc_torch.flagship import FlagshipStep, pack_stream, token_lists
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.models.from_jax import params_from_flax
    from svoc_torch.sim import prng
    from svoc_torch.sim.oracle import assemble_fleet, draw_fleet

    rows, seq, max_seg, n, n_failing, subset = 16, 32, 4, 64, 16, 10
    ids = jnp.ones((2, 16), jnp.int32)  # svoc_tpu.models.encoder.init_params, jitted
    flax_params = jax.jit(JaxEncoder(jax_configs.TINY_TEST).init)(jax.random.PRNGKey(1), ids, ids)
    jax_forward = jax.jit(JaxPacked(jax_configs.TINY_TEST).apply)
    step = FlagshipStep(TINY_TEST, variant="packed", rows=rows, seq=seq, max_seg=max_seg, n_oracles=n,
                        subset_size=subset, params=params_from_flax(flax_params), params_dtype=None,
                        device="cpu")
    tok = step.pipe.tokenizer
    feed = pack_stream(token_lists(tok, SyntheticSource(batch=rows, seed=0), seq), rows, seq, max_seg, tok.pad_id)
    key, jkey = prng.PRNGKey(0, "cpu"), jax.random.PRNGKey(0)
    adapters = {pkg: build(pkg, n, n_failing=n_failing, dimension=6) for pkg in PACKAGES}
    routes = {pkg: [] for pkg in PACKAGES}
    for pkg, a in adapters.items():
        contract = a.backend.contract
        orig = contract.update_predictions_batch

        def spy(*args, _orig=orig, _log=routes[pkg], **kw):
            try:
                return _orig(*args, **kw)
            except Exception as e:
                _log.append(type(e).__name__)
                raise
            finally:
                _log.append("batch")

        contract.update_predictions_batch = spy
    sweeps = []
    from svoc_torch.consensus import batch as port_batch

    real_sweep = port_batch.prefix_margins_sweep
    monkeypatch.setattr(port_batch, "prefix_margins_sweep",
                        lambda *a, **k: sweeps.append(a[-1].numel()) or real_sweep(*a, **k))
    # The activation cycle opens the gate on its last tx and panics there
    # (the tiny model's honest oracles agree to under a wsad unit), so the
    # second opens it on its last tx again; the third sweeps 63 prefixes.
    for s in range(3):
        batch, _ = next(feed)
        key, jkey = prng.fold_in(key, s), jax.random.fold_in(jkey, s)
        window = step.window(batch)
        logits = jax_forward(flax_params, *map(jnp.asarray, (batch.ids, batch.pos, batch.seg, batch.cls_pos)))
        vecs = jax_scores_to_vectors(logits.reshape(rows * max_seg, -1))
        jwindow = jax_first_valid_window(vecs, jnp.asarray(batch.seg_valid > 0).reshape(-1), step.window_size)
        np.testing.assert_allclose(window.numpy(), np.asarray(jwindow), atol=1e-4)
        values, honest = assemble_fleet(window, *draw_fleet(key, step.window_size, 6, n, n_failing, subset))
        ref_values, ref_honest = gen_oracle_predictions(jkey, jnp.asarray(window.numpy()), n, n_failing, subset)
        assert np.array_equal(values.numpy(), np.asarray(ref_values))
        assert np.array_equal(honest.numpy(), np.asarray(ref_honest))
        fleet = values.numpy().astype(np.float64)
        results = {pkg: (outcome(a.update_all_the_predictions, fleet), reads(a)) for pkg, a in adapters.items()}
        assert results["ref"] == results["port"]
    assert routes["ref"] == routes["port"] and routes["port"].count("batch") == 3
    assert sweeps == [64]  # 63 intermediate prefixes, bucketed
    assert adapters["port"].call_consensus_active()
