"""The port's claim-sharded cube against its unsharded cube and the JAX
package's sharded cube, on the CPU.

Twin of ``tests/test_claim_shard.py``: the reference runs on its 8
simulated CPU devices, the port on 8-slot CPU meshes
(:func:`svoc_torch.parallel.mesh.claim_mesh` with ``device="cpu"``), on
the same seeded numpy inputs.

Tolerance: none where the reference's test has none.  The port's
claim-sharded dispatch is ``array_equal`` (NaN-aware) to its unsharded
cube on every mesh and config, its sharded fleet is bitwise the same on
every factorization, and its fleet draws (``claim_fleet_keys``,
``fleet_claims_reference``) are the reference's bit for bit.  Against
the reference's sharded outputs the port's CPU cube (torch's reductions,
not XLA's) is held at ``tests/test_torch_claims.py``'s bars: the reliable
mask and ``interval_valid`` exact, essences, reliabilities and finite
risks within 1e-5 (infinite risks equal), skewness within 1e-4,
kurtosis within 1e-3; its journal fingerprints, which round to 6
decimals, equal the reference's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svoc_tpu.consensus.batch import _claims_consensus_gated_xla  # noqa: E402
from svoc_tpu.consensus.batch import _claims_consensus_sanitized_xla  # noqa: E402
from svoc_tpu.consensus.kernel import ConsensusConfig as RefConfig  # noqa: E402
from svoc_tpu.parallel import claim_shard as ref_shard  # noqa: E402
from svoc_tpu.parallel import mesh as ref_mesh  # noqa: E402
from svoc_tpu.sim.generators import FLEET_CLAIM_SALT as REF_SALT  # noqa: E402
from svoc_tpu.sim.generators import claim_fleet_keys as ref_claim_fleet_keys  # noqa: E402

from svoc_torch.consensus.batch import claims_consensus_gated, claims_consensus_sanitized, pad_claim_cube  # noqa: E402
from svoc_torch.consensus.kernel import ConsensusConfig  # noqa: E402
from svoc_torch.parallel import claim_shard  # noqa: E402
from svoc_torch.parallel.mesh import MeshConfigError, claim_mesh, parse_claim_mesh, resolve_claim_mesh  # noqa: E402
from svoc_torch.sim import FLEET_CLAIM_SALT, claim_fleet_keys, prng  # noqa: E402
from svoc_torch.utils.metrics import MetricsRegistry  # noqa: E402

CFGS = [
    ConsensusConfig(n_failing=2, constrained=True),
    ConsensusConfig(n_failing=3, constrained=False, max_spread=10.0),
]
REF_CFGS = [RefConfig(n_failing=2, constrained=True), RefConfig(n_failing=3, constrained=False, max_spread=10.0)]
MESHES = ["1x1", "2x1", "4x1", "8x1", "1x8", "2x4", "4x2", "2x2"]


def mesh(spec):
    return claim_mesh(spec, device="cpu")


def exact_eq(a, b) -> bool:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and bool(np.array_equal(a, b, equal_nan=True))


def assert_outputs_exact(out, ref, context=""):
    for field in out._fields:
        assert exact_eq(getattr(out, field), getattr(ref, field)), f"{context}: field {field} diverged"


def assert_matches_reference(out, ref):
    """``tests/test_torch_claims.py``'s bars against a JAX output."""
    assert exact_eq(out.reliable, ref.reliable) and exact_eq(out.interval_valid, ref.interval_valid)
    for field in ("essence", "essence_first_pass", "reliability_first_pass", "reliability_second_pass"):
        np.testing.assert_allclose(getattr(out, field).numpy(), np.asarray(getattr(ref, field)), atol=1e-5,
                                   rtol=0, err_msg=field)
    qr, ref_qr = out.quadratic_risk.numpy(), np.asarray(ref.quadratic_risk)
    finite = np.isfinite(ref_qr)
    assert np.array_equal(np.isfinite(qr), finite) and np.array_equal(qr[~finite], ref_qr[~finite])
    np.testing.assert_allclose(qr[finite], ref_qr[finite], atol=1e-5, rtol=0, err_msg="risk")
    np.testing.assert_allclose(out.skewness.numpy(), np.asarray(ref.skewness), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.kurtosis.numpy(), np.asarray(ref.kurtosis), atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def fixture_cube():
    """The reference test's cube: a quarantined slot with a NaN, an
    all-quarantined claim, a single survivor, padding claims with
    hostile filler."""
    rng = np.random.default_rng(0)
    c, n, m = 8, 16, 6
    values = rng.uniform(0, 1, size=(c, n, m)).astype(np.float32)
    ok = np.ones((c, n), dtype=bool)
    ok[1, -1] = False
    ok[2, :] = False
    ok[3, 1:] = False
    claim_mask = np.ones(c, dtype=bool)
    claim_mask[-2:] = False
    values[6] = 777.0
    values[1, 0, 0] = np.nan
    ok[1, 0] = False
    return values, ok, claim_mask


def tensors(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


class TestShardedDispatchParity:
    @pytest.mark.parametrize("index", [0, 1], ids=["constrained", "unconstrained"])
    @pytest.mark.parametrize("spec", MESHES)
    def test_gated_bitwise_parity(self, fixture_cube, index, spec):
        values, ok, claim_mask = fixture_cube
        cfg = CFGS[index]
        unsharded = claims_consensus_gated(*tensors(values, ok, claim_mask), cfg)
        out = claim_shard.sharded_claims_consensus_fn(mesh(spec), cfg)(*tensors(values, ok, claim_mask))
        assert_outputs_exact(out, unsharded, f"gated mesh {spec}")
        ref = ref_shard.sharded_claims_consensus_fn(ref_mesh.claim_mesh(spec), REF_CFGS[index])(
            values, ok, claim_mask)
        assert_matches_reference(out, ref)

    @pytest.mark.parametrize("index", [0, 1], ids=["constrained", "unconstrained"])
    def test_sanitized_bitwise_parity(self, fixture_cube, index):
        values, _ok, claim_mask = fixture_cube
        cfg = CFGS[index]
        lo, hi = (0.0, 1.0) if cfg.constrained else (None, None)
        unsharded, unsharded_ok = claims_consensus_sanitized(*tensors(values, claim_mask), cfg, lo, hi)
        ref, ref_ok = _claims_consensus_sanitized_xla(jnp.asarray(values), jnp.asarray(claim_mask),
                                                      REF_CFGS[index], lo, hi)
        for spec in ("2x4", "4x1"):
            out, out_ok = claim_shard.sharded_claims_sanitized_fn(mesh(spec), cfg, lo, hi)(
                *tensors(values, claim_mask))
            assert_outputs_exact(out, unsharded, f"sanitized mesh {spec}")
            assert exact_eq(out_ok, unsharded_ok) and exact_eq(out_ok, ref_ok)
            assert_matches_reference(out, ref)

    @pytest.mark.parametrize("seed,shape", [(1, (4, 64, 6)), (2, (16, 8, 2)), (3, (2, 128, 3))])
    def test_random_shapes_sweep(self, seed, shape):
        c, n, m = shape
        rng = np.random.default_rng(seed)
        values = rng.uniform(0, 1, size=(c, n, m)).astype(np.float32)
        ok = rng.random((c, n)) > 0.1
        claim_mask = np.ones(c, dtype=bool)
        claim_mask[-1] = False
        for cfg, ref_cfg in zip(CFGS, REF_CFGS):
            unsharded = claims_consensus_gated(*tensors(values, ok, claim_mask), cfg)
            ref = _claims_consensus_gated_xla(jnp.asarray(values), jnp.asarray(ok), jnp.asarray(claim_mask),
                                              ref_cfg)
            for spec in ("2x2", "1x8"):
                mc, mo = parse_claim_mesh(spec)
                if c % mc or n % mo:
                    continue
                out = claim_shard.sharded_claims_consensus_fn(mesh(spec), cfg)(*tensors(values, ok, claim_mask))
                assert_outputs_exact(out, unsharded, f"sweep seed {seed} mesh {spec}")
                assert_matches_reference(out, ref)

    def test_padded_rows_stay_inactive_through_sharded_path(self, fixture_cube):
        values, ok, claim_mask = fixture_cube
        out = claim_shard.sharded_claims_consensus_fn(mesh("2x4"), CFGS[0])(*tensors(values, ok, claim_mask))
        pad = torch.from_numpy(~claim_mask)
        assert not out.interval_valid[pad].any()
        assert (out.essence[pad] == 0.0).all()
        assert not out.reliable[pad].any()

    def test_one_body_a_claim_shard_and_no_collective(self, fixture_cube, monkeypatch):
        """The runner runs the body once a claim shard (the oracle-axis
        slots share its result), and the body has no collective."""
        values, ok, claim_mask = fixture_cube
        seen = []
        real = claim_shard.claims_consensus_gated
        monkeypatch.setattr(claim_shard, "claims_consensus_gated",
                            lambda v, *a: seen.append(v.shape[0]) or real(v, *a))
        claim_shard.sharded_claims_consensus_fn(mesh("2x4"), CFGS[0])(*tensors(values, ok, claim_mask))
        assert seen == [4, 4]


class TestShardedFleet:
    def test_claim_fleet_keys_equal_jax(self):
        assert FLEET_CLAIM_SALT == REF_SALT
        for seed, c in ((3, 4), (7, 2), (2**31 + 9, 64)):
            ours = claim_fleet_keys(prng.PRNGKey(seed, "cpu"), c)
            theirs = np.asarray(jax.random.key_data(ref_claim_fleet_keys(jax.random.PRNGKey(seed), c)))
            assert ours.tolist() == theirs.astype(np.int64).tolist()

    def test_fleet_bitwise_invariant_across_meshes(self):
        cfg = ConsensusConfig(n_failing=4, constrained=True)
        c, n, w, m = 4, 32, 50, 6
        keys = claim_fleet_keys(prng.PRNGKey(3, "cpu"), c)
        windows = torch.from_numpy(np.random.default_rng(11).uniform(size=(c, w, m)).astype(np.float32))
        base = None
        for spec in ("1x1", "2x4", "4x2", "1x8", "4x1"):
            out, honest = claim_shard.sharded_fleet_claims_fn(mesh(spec), cfg, n)(keys, windows)
            fields = dict(out._asdict(), honest=honest)
            if base is None:
                base = fields
                continue
            for name, arr in fields.items():
                assert exact_eq(arr, base[name]), f"fleet field {name} not sharding-invariant at {spec}"
        _vref, href = claim_shard.fleet_claims_reference(keys, windows, n, cfg.n_failing)
        assert exact_eq(base["honest"], href)
        assert int((~base["honest"]).sum()) == c * cfg.n_failing

    def test_fleet_draws_and_consensus_equal_the_reference(self):
        """The port's fleet cube is the reference generator's bit for bit;
        the sharded fleet's consensus is the reference's at its own test's
        bar (atol 1e-6 on the essence), masks exact."""
        c, n, w, m = 2, 16, 30, 4
        windows = np.random.default_rng(13).uniform(size=(c, w, m)).astype(np.float32)
        ref_keys = ref_claim_fleet_keys(jax.random.PRNGKey(7), c)
        keys = claim_fleet_keys(prng.PRNGKey(7, "cpu"), c)
        vref, href = ref_shard.fleet_claims_reference(ref_keys, jnp.asarray(windows), n, 2)
        values, honest = claim_shard.fleet_claims_reference(keys, torch.from_numpy(windows), n, 2)
        assert exact_eq(values, vref) and exact_eq(honest, href)
        one = claim_shard.one_claim_fleet(keys[1], torch.from_numpy(windows[1]), n, 2, 10, range(4, 12))
        assert exact_eq(one[0], values[1, 4:12]) and exact_eq(one[1], honest[1, 4:12])
        out, _ = claim_shard.sharded_fleet_claims_fn(mesh("2x4"), CFGS[0], n)(keys, torch.from_numpy(windows))
        ref_out, _ = ref_shard.sharded_fleet_claims_fn(ref_mesh.claim_mesh("2x4"), REF_CFGS[0], n)(
            ref_keys, jnp.asarray(windows))
        np.testing.assert_allclose(out.essence.numpy(), np.asarray(ref_out.essence), rtol=0, atol=1e-6)
        assert exact_eq(out.reliable, ref_out.reliable) and exact_eq(out.interval_valid, ref_out.interval_valid)

    def test_gated_fleet_quarantines_in_graph(self):
        cfg = ConsensusConfig(n_failing=2, constrained=True)
        c, n, w, m = 2, 16, 30, 4
        keys = claim_fleet_keys(prng.PRNGKey(1, "cpu"), c)
        windows = torch.from_numpy(np.random.default_rng(2).uniform(size=(c, w, m)).astype(np.float32))
        out, honest, admitted = claim_shard.sharded_fleet_claims_fn(mesh("2x2"), cfg, n, gate=(0.0, 1.0))(
            keys, windows)
        assert admitted.shape == (c, n) and bool(admitted.all())
        assert bool(out.interval_valid.all())
        with pytest.raises(ValueError, match="not divisible"):
            claim_shard.sharded_fleet_claims_fn(mesh("2x4"), cfg, 18)


class TestMeshConfig:
    def test_parse_claim_mesh(self):
        for spec in (None, "", "none", "off", "2x4", "8X1", (4, 2)):
            assert parse_claim_mesh(spec) == ref_mesh.parse_claim_mesh(spec)
        for bad in ("2x", "x4", "2x4x1", "ax2", "0x4", "-1x2", (3,)):
            with pytest.raises(MeshConfigError):
                parse_claim_mesh(bad)
            with pytest.raises(ref_mesh.MeshConfigError):
                ref_mesh.parse_claim_mesh(bad)

    def test_claim_mesh_device_budget(self):
        m = mesh("2x4")
        assert dict(m.shape) == {"claim": 2, "oracle": 4} == dict(ref_mesh.claim_mesh("2x4").shape)
        assert {str(d) for d in m.devices.flat} == {"cpu"}
        assert mesh("none") is None
        with pytest.raises(MeshConfigError) as err:
            mesh("64x64")
        assert "needs 4096 slots" in str(err.value)  # the error names the inventory
        assert claim_mesh("64x64", devices=["cpu"] * 4096).size == 4096

    def test_resolve_claim_mesh_env(self, monkeypatch):
        monkeypatch.delenv("SVOC_MESH", raising=False)
        assert resolve_claim_mesh() is None  # the committed decision: none
        monkeypatch.setenv("SVOC_MESH", "2x4")
        assert resolve_claim_mesh() == "2x4"
        monkeypatch.setenv("SVOC_MESH", "off")
        assert resolve_claim_mesh() is None

    def test_pad_claim_cube_multiple_of(self):
        padded, ok, claim_mask = pad_claim_cube(np.full((3, 4, 2), 0.25, dtype=np.float32), multiple_of=8)
        assert padded.shape[0] == 8
        assert claim_mask.tolist() == [True] * 3 + [False] * 5
        assert ok.shape == (8, 4) and bool(ok.all())


class TestDispatcher:
    def test_unshardable_cube_counts_fallback(self, fixture_cube):
        values, ok, claim_mask = fixture_cube
        reg = MetricsRegistry()
        d = claim_shard.ClaimShardDispatcher(mesh("2x4"), metrics=reg)
        cfg = CFGS[0]
        cube = tensors(values[:, :15], ok[:, :15], claim_mask)
        out = d.dispatch_gated(*cube, cfg)
        assert_outputs_exact(out, claims_consensus_gated(*cube, cfg), "fallback path")
        ref = _claims_consensus_gated_xla(jnp.asarray(values[:, :15]), jnp.asarray(ok[:, :15]),
                                          jnp.asarray(claim_mask), REF_CFGS[0])
        assert_matches_reference(out, ref)
        series = {tuple(sorted(labels.items())): count for labels, count in reg.family_series("claim_shard_fallback")}
        assert series == {(("reason", "oracle_indivisible"),): 1.0}
        assert reg.family_total("claim_shard_dispatches") == 0
        d.dispatch_gated(*tensors(values, ok, claim_mask), cfg)
        assert reg.family_total("claim_shard_dispatches") == 1
        assert reg.family_total("claim_shard_fallback") == 1
        # Three claims do not divide over the claim axis: counted, unsharded.
        out, ok3 = d.dispatch_sanitized(*tensors(values[:3], claim_mask[:3]), cfg, 0.0, 1.0)
        ref, ref_ok = _claims_consensus_sanitized_xla(jnp.asarray(values[:3]), jnp.asarray(claim_mask[:3]),
                                                      REF_CFGS[0], 0.0, 1.0)
        assert_matches_reference(out, ref)
        assert exact_eq(ok3, ref_ok)
        series = {tuple(sorted(labels.items())): count for labels, count in reg.family_series("claim_shard_fallback")}
        assert series[(("reason", "claim_indivisible"),)] == 1.0
        assert d.spec_str == "2x4" and (d.claim_size, d.oracle_size) == (2, 4)

    def test_consensus_impl_is_refused_as_in_the_single_device_path(self):
        with pytest.raises(ValueError, match="one route per device"):
            claim_shard.ClaimShardDispatcher(mesh("2x4"), consensus_impl="pallas")
        with pytest.raises(ValueError, match="needs axes"):
            claim_shard.ClaimShardDispatcher(claim_mesh("2x4", device="cpu").__class__(
                np.array(["cpu"], dtype=object), ("data",)))


class TestRouterIntegration:
    def test_meshed_fabric_fingerprints_equal_unmeshed_and_the_reference(self):
        from svoc_tpu.fabric.scenario import run_fabric_scenario as ref_run

        from svoc_torch.fabric.scenario import run_fabric_scenario

        plain = run_fabric_scenario(0, cycles=4, n_oracles=8, device="cpu")
        reg = MetricsRegistry()
        meshed = run_fabric_scenario(0, cycles=4, n_oracles=8, mesh="2x4", metrics=reg, device="cpu")
        ref = ref_run(0, cycles=4, n_oracles=8, mesh="2x4")
        for cid in plain["claims"]:
            assert plain["claims"][cid]["fingerprint"] == meshed["claims"][cid]["fingerprint"] \
                == ref["claims"][cid]["fingerprint"]
        assert plain["journal_fingerprint"] == meshed["journal_fingerprint"] == ref["journal_fingerprint"]
        assert reg.family_total("claim_shard_dispatches") >= 4
        assert reg.family_total("claim_shard_fallback") == 0

    @pytest.mark.parametrize("resident,sanitized", [(True, False), (False, True), (True, True)])
    def test_staged_and_sanitized_meshed_routers_equal_the_reference(self, resident, sanitized):
        """The resident staging and the sanitized dispatch through the
        mesh: the same per-claim fingerprints as the reference's meshed
        router, every dispatch sharded."""
        ours, theirs = _meshed_router_fingerprints(resident, sanitized)
        assert ours == theirs
        assert ours[1] == [3, 0]  # a sharded dispatch a cycle, no fallback

    @pytest.mark.parametrize("leak", ["port", "reference"])
    def test_an_event_in_one_process_journal_leaves_the_meshed_fingerprints_equal(self, leak, monkeypatch):
        """An event that an earlier test emitted into one package's
        process journal, and not the other's, shifts that journal's
        global seqs: the routers journal into journals of their own, so
        the per-claim fingerprints stay equal.  The leak goes into a
        fresh process journal, which the test takes away again."""
        from svoc_tpu.utils import events as ref_events

        from svoc_torch.utils import events

        mod = events if leak == "port" else ref_events
        monkeypatch.setattr(mod, "journal", mod.EventJournal())
        mod.emit_event("test.leak", lineage="blkmsh-a")
        ours, theirs = _meshed_router_fingerprints(True, True)
        assert ours == theirs
        assert ours[1] == [3, 0]

    def test_multisession_snapshot_surfaces_mesh(self):
        from svoc_torch.fabric.session import MultiSession

        snap = MultiSession(mesh="2x1", device="cpu").snapshot()
        assert snap["mesh"] == "2x1" and snap["consensus_impl"] == "plain" and snap["pipelined"] is False
        assert MultiSession(mesh="off", device="cpu").snapshot()["mesh"] is None

    def test_router_pins_mesh_once_from_env(self, monkeypatch):
        from svoc_torch.fabric.registry import ClaimRegistry
        from svoc_torch.fabric.router import ClaimRouter

        monkeypatch.setenv("SVOC_MESH", "2x1")
        router = ClaimRouter(ClaimRegistry(), device="cpu")
        assert router.mesh_spec == "2x1"
        monkeypatch.delenv("SVOC_MESH")
        assert router.mesh_spec == "2x1"
        assert ClaimRouter(ClaimRegistry(), device="cpu").mesh_spec is None


def _meshed_router_fingerprints(resident, sanitized):
    """Three claims through each package's ``MultiSession(mesh="2x1")``
    for three cycles: ``({claim: journal fingerprint}, [sharded
    dispatches, fallbacks])``.  Each fabric journals into a fresh
    journal of its own: a per-claim fingerprint carries the journal's
    global seqs, so the process journals (which other tests emit into)
    would make the two sides differ."""
    from conftest import fake_sentiment_vectorizer
    from svoc_tpu.fabric.registry import ClaimSpec as RefSpec
    from svoc_tpu.fabric.session import MultiSession as RefMulti
    from svoc_tpu.io.comment_store import CommentStore as RefStore
    from svoc_tpu.io.scraper import SyntheticSource as RefSource
    from svoc_tpu.utils.events import EventJournal as RefJournal

    from svoc_torch.fabric.registry import ClaimSpec
    from svoc_torch.fabric.session import MultiSession
    from svoc_torch.io.comment_store import CommentStore
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.utils.events import EventJournal

    def stores(Store, Source):
        def factory(claim_id):
            store = Store()
            store.save(Source(batch=60, seed=len(claim_id))())
            return store

        return factory

    def run(Multi, Spec, **kw):
        multi = Multi(base_seed=4, vectorizer=fake_sentiment_vectorizer, mesh="2x1",
                      device_resident=resident, sanitized_dispatch=sanitized, lineage_scope="msh", **kw)
        for cid in ("a", "b", "c"):
            multi.add_claim(Spec(claim_id=cid, n_oracles=8))
        reg = multi.router._shard._metrics
        before = [reg.family_total(f) for f in ("claim_shard_dispatches", "claim_shard_fallback")]
        multi.run(3)
        after = [reg.family_total(f) for f in ("claim_shard_dispatches", "claim_shard_fallback")]
        return ({cid: multi.router._resolve_journal().fingerprint(lineage_prefix=f"blkmsh-{cid}")
                 for cid in ("a", "b", "c")}, [y - x for x, y in zip(before, after)])

    ours = run(MultiSession, ClaimSpec, store_factory=stores(CommentStore, SyntheticSource),
               journal=EventJournal(), device="cpu")
    theirs = run(RefMulti, RefSpec, store_factory=stores(RefStore, RefSource), journal=RefJournal(),
                 consensus_impl="xla")
    return ours, theirs
