"""The port's resident claim-cube staging and hot-path gate against the JAX package's, on the CPU.

Twins of ``tests/test_hotpath.py``'s staging properties and of
``tools/hotpath_smoke.py``:

- ``_tiny_multi`` (``tests/test_hotpath.py:184``): the staged and the
  unstaged router give per-claim fingerprints equal to each other and to
  the reference's, pipelined and not, with the batched commit plane and
  without;
- the staging record: pad rows after a shrinking batch equal
  ``pad_claim_cube``'s bit for bit, the record is reallocated only when
  the bucket changes, and the admission masks handed to a pending group
  are never views of the staging tensors;
- ``enumerate_universe`` with the donate twin equals the reference's,
  key for key and in order;
- the hot-path twin's six checks at a small cycle count, and its seed-0
  constants against a live run of the reference's tool.

Tolerance: none.  Fingerprints and padded cubes are compared exactly.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import torch

from conftest import fake_sentiment_vectorizer

from svoc_tpu.compile import universe as ref_universe
from svoc_tpu.consensus.kernel import ConsensusConfig as RefConfig
from svoc_tpu.fabric.registry import ClaimSpec as RefSpec
from svoc_tpu.fabric.session import MultiSession as RefMulti
from svoc_tpu.io.comment_store import CommentStore as RefStore
from svoc_tpu.io.scraper import SyntheticSource as RefSource
from svoc_tpu.utils.events import EventJournal as RefJournal
from svoc_tpu.utils.metrics import MetricsRegistry as RefMetrics

from svoc_torch.compile import universe
from svoc_torch.consensus.batch import pad_claim_cube
from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.fabric.router import _GroupStaging
from svoc_torch.fabric.session import MultiSession
from svoc_torch.io.comment_store import CommentStore
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.sim.generators import claim_seed
from svoc_torch.tools import hotpath_smoke
from svoc_torch.utils.events import EventJournal
from svoc_torch.utils.metrics import MetricsRegistry

REPO = Path(__file__).resolve().parent.parent
CFG = ConsensusConfig(n_failing=2, constrained=True)


def _tiny_multi(*, ref=False, device_resident=False, pipelined=False, commit_mode="per_tx",
                scope="hp"):
    """``tests/test_hotpath.py::_tiny_multi`` in either package: three
    claims of 8 oracles, the third in its own (unconstrained) group."""
    Multi, Spec, Store, Source = ((RefMulti, RefSpec, RefStore, RefSource) if ref
                                  else (MultiSession, ClaimSpec, CommentStore, SyntheticSource))

    def store_factory(claim_id):
        store = Store()
        store.save(Source(batch=80, seed=claim_seed(11, claim_id))())
        return store

    kwargs = {} if ref else {"device": "cpu"}
    multi = Multi(base_seed=11, vectorizer=fake_sentiment_vectorizer, store_factory=store_factory,
                  journal=RefJournal() if ref else EventJournal(),
                  metrics=RefMetrics() if ref else MetricsRegistry(), lineage_scope=scope,
                  max_claims_per_batch=4, device_resident=device_resident, pipelined=pipelined,
                  commit_mode=commit_mode, **kwargs)
    multi.add_claim(Spec(claim_id="alpha", n_oracles=8))
    multi.add_claim(Spec(claim_id="beta", n_oracles=8))
    multi.add_claim(Spec(claim_id="gamma", n_oracles=8, constrained=False, max_spread=10.0))
    return multi


def _fingerprints(multi):
    return {c: multi.claim_fingerprint(c) for c in multi.claim_ids()}


# ---------------------------------------------------------------------------
# Fingerprints: staged == unstaged == the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("commit_mode", ["per_tx", "batched"])
def test_staged_equals_unstaged_and_the_reference(pipelined, commit_mode):
    staged = _tiny_multi(device_resident=True, pipelined=pipelined, commit_mode=commit_mode)
    plain = _tiny_multi(pipelined=pipelined, commit_mode=commit_mode)
    ref = _tiny_multi(ref=True, device_resident=True, pipelined=pipelined, commit_mode=commit_mode)
    for multi in (staged, plain, ref):
        multi.run(5)
        if pipelined:
            multi.router.flush()
    assert _fingerprints(staged) == _fingerprints(plain) == _fingerprints(ref)
    assert staged.snapshot()["device_resident"] is True
    assert plain.snapshot()["device_resident"] is False
    snap = staged.snapshot()
    assert (snap["consensus_impl"], snap["mesh"]) == ("plain", None)


def test_staging_reuse_does_not_corrupt_prior_outputs():
    """``tests/test_hotpath.py:163``: consecutive resident cycles
    reproduce the unstaged cycles' journal; the pipelined write-back reads
    masks captured at dispatch, never the staging tensor refilled since."""
    staged = _tiny_multi(device_resident=True, pipelined=True, scope="stga")
    plain = _tiny_multi(pipelined=True, scope="stga")
    for multi in (staged, plain):
        multi.run(4)
        multi.router.flush()
    assert _fingerprints(staged) == _fingerprints(plain)
    records = {key: rec for key, rec in staged.router._staging.items()}
    assert len(records) == 2  # one per (N, M, cfg) group, kept for the process


def test_shrinking_group_after_a_pause_keeps_fingerprints():
    staged = _tiny_multi(device_resident=True, scope="shr")
    plain = _tiny_multi(scope="shr")
    for multi in (staged, plain):
        multi.run(2)
        multi.get("beta").paused = True  # the constrained group goes from 2 claims to 1
        multi.run(2)
        multi.get("beta").paused = False
        multi.run(1)
    assert _fingerprints(staged) == _fingerprints(plain)


# ---------------------------------------------------------------------------
# The staging record
# ---------------------------------------------------------------------------


def _blocks(rng, c, n=7, m=6):
    return [rng.uniform(0, 1, size=(n, m)) for _ in range(c)], [rng.uniform(size=n) > 0.2
                                                                 for _ in range(c)]


@pytest.mark.parametrize("sizes", [(4, 3), (8, 5, 7, 1), (3, 3, 2)])
def test_pad_rows_after_a_shrinking_batch_equal_pad_claim_cube(sizes):
    rng = np.random.default_rng(sum(sizes))
    staging = None
    for c in sizes:
        blocks, oks = _blocks(rng, c)
        bucket = 1 << (c - 1).bit_length()
        if staging is None or staging.bucket != bucket:
            staging = _GroupStaging(bucket, 7, 6, torch.device("cpu"))
        staging.load(blocks, oks)
        values, ok, mask = staging.upload()
        want = pad_claim_cube(np.stack([np.asarray(b, np.float32) for b in blocks]), np.stack(oks))
        for got, ref in zip((values, ok, mask), want):
            assert got.dtype == ref.dtype and torch.equal(got, ref)
        # The CPU "device" tensors are copies, never the host buffers.
        for dev, host in zip(staging.dev, staging.host):
            assert dev.data_ptr() != host.data_ptr()


def test_router_reallocates_only_when_the_bucket_changes():
    multi = _tiny_multi(device_resident=True)
    router = multi.router
    first = router._group_staging(3, 8, 6, CFG)
    assert router._group_staging(4, 8, 6, CFG) is first  # 3 and 4 share bucket 4
    grown = router._group_staging(5, 8, 6, CFG)
    assert grown is not first and grown.bucket == 8
    assert router._group_staging(2, 8, 6, CFG).bucket == 2


def test_pending_masks_are_not_views_of_the_staging_tensor():
    multi = _tiny_multi(device_resident=True, pipelined=True)
    multi.router.step()  # MultiSession.run would flush the pipeline's tail
    inflight = multi.router._inflight
    assert len(inflight) == 2  # one group a consensus config
    for pending in inflight:
        record = multi.router._staging[(8, 6, pending.members[0].spec.consensus_config())]
        assert pending.ok.untyped_storage().data_ptr() != record.dev[1].untyped_storage().data_ptr()
        assert torch.equal(pending.ok, record.dev[1][: len(pending.members)])


def test_mesh_still_raises():
    """A claim mesh now serves (``tests/test_torch_claim_shard.py``); one
    that holds more slots than the device offers raises before any
    session is built, as the reference's does."""
    from svoc_torch.parallel.mesh import MeshConfigError
    from svoc_tpu.fabric.session import MultiSession as RefMultiSession
    from svoc_tpu.parallel.mesh import MeshConfigError as RefMeshConfigError

    with pytest.raises(MeshConfigError, match="needs 4096 slots"):
        MultiSession(base_seed=0, vectorizer=fake_sentiment_vectorizer, mesh="64x64", device="cpu")
    with pytest.raises(RefMeshConfigError, match="needs 4096 devices"):
        RefMultiSession(base_seed=0, vectorizer=fake_sentiment_vectorizer, mesh="64x64")
    staged = MultiSession(base_seed=0, vectorizer=fake_sentiment_vectorizer, mesh="2x1",
                          device_resident=True, device="cpu")
    assert (staged.snapshot()["mesh"], staged.router._donate) == ("2x1", False)


# ---------------------------------------------------------------------------
# The universe with the donate twin
# ---------------------------------------------------------------------------


def _ident(key):
    return (key.kind, key.bucket, key.n_oracles, key.dimension, dataclasses.astuple(key.cfg), key.donate,
            key.mesh)


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("sanitized", [False, True])
@pytest.mark.parametrize("cap,groups", [
    (8, {(7, 6, CFG): 3}),
    (4, {(7, 6, CFG): 4, (16, 6, ConsensusConfig(n_failing=4)): 1}),
])
def test_universe_equals_the_references_key_for_key(donate, sanitized, cap, groups):
    ref_groups = {(n, m, RefConfig(**dataclasses.asdict(cfg))): c for (n, m, cfg), c in groups.items()}
    for twins in (False, True):
        ours = universe.enumerate_universe(groups, max_claims_per_batch=cap, sanitized_dispatch=sanitized,
                                           impl="cuda", donate=donate, include_twins=twins)
        ref = ref_universe.enumerate_universe(ref_groups, max_claims_per_batch=cap,
                                              sanitized_dispatch=sanitized, donate=donate, impl="xla",
                                              include_twins=twins)
        assert [_ident(k) for k in ours] == [_ident(k) for k in ref]


def test_resident_router_keys_its_dispatches_donate():
    multi = _tiny_multi(device_resident=True)
    multi.run(1)
    keys = list(multi.router._warmth_seen)
    assert keys and all(k.donate for k in keys)
    worker = multi.start_prewarm(background=False, force=True)
    stats = worker.stats()
    assert stats["warmed"] == stats["universe"] == 24  # 2 groups x 3 buckets x 4 variants
    assert all(k.donate for k in worker._primary_keys(8, 6, CFG))


def test_unstaged_router_primes_a_donate_key_as_its_warm_twin(monkeypatch):
    """A router that stages nothing runs a donate key's dispatch as its
    non-donate twin's: the walk counts the donate twins warm without a
    staging record or a launch of their own."""
    from svoc_torch.compile import prewarm

    multi = _tiny_multi()
    primed = []
    real = prewarm.prime_key
    monkeypatch.setattr(prewarm, "prime_key", lambda key, device: (primed.append(key), real(key, device))[1])
    worker = multi.start_prewarm(background=False, force=True)
    keys = worker.universe()
    assert any(k.donate for k in keys) and all(worker.is_warm(k) for k in keys)
    assert primed == [k for k in keys if not k.donate]  # each non-donate key once, no donate key
    assert not multi.router._staging
    with pytest.raises(ValueError, match="resident"):
        multi.router.prime_staging(next(k for k in keys if k.donate))


# ---------------------------------------------------------------------------
# The hot-path gate
# ---------------------------------------------------------------------------


def test_hotpath_twin_six_checks_at_a_small_cycle_count():
    artifact = hotpath_smoke.run(seed=0, cycles=4, device="cpu")
    assert set(artifact["checks"]) == {
        "optimized_replay_identical", "optimized_equals_unoptimized", "injections_happened",
        "quarantine_fallbacks_counted", "rpcs_batch_is_claim_cycles", "rpcs_tx_is_zero"}
    assert all(artifact["checks"].values()), artifact["checks"]
    assert artifact["reference_mismatches"] is None and artifact["ok"]


def test_hotpath_constants_equal_a_live_reference_run(tmp_path):
    spec = importlib.util.spec_from_file_location("ref_hotpath_smoke", REPO / "tools" / "hotpath_smoke.py")
    ref_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tool)
    import json

    out = tmp_path / "hp.json"
    assert ref_tool.main(["--seed", "0", "--out", str(out)]) == 0
    ref = json.loads(out.read_text())
    pinned = hotpath_smoke.REFERENCE_FINGERPRINTS[0]
    assert ref["cycles"] == hotpath_smoke.DEFAULT_CYCLES
    assert pinned == {"journal": ref["journal_fingerprint"], "claims": ref["per_claim_fingerprints"]}
    assert (hotpath_smoke.RPC_CLAIMS, hotpath_smoke.RPC_CYCLES, hotpath_smoke.RPC_ORACLES) == tuple(
        ref["clean_leg"][k] for k in ("claims", "cycles", "oracles"))
    artifact = hotpath_smoke.run(seed=0, device="cpu")
    assert artifact["reference_mismatches"] == {} and artifact["ok"]
