"""The port's ``Session`` against the JAX package's, on the CPU, with the
fabric scenario's deterministic vectorizer.

- Store-driven cycles of ``fetch`` → ``commit_resilient`` →
  ``supervisor_step`` (a tampered block among them), under both commit
  modes: byte-identical journal fingerprints, the same previews (the
  fleet exactly, the statistics within 1e-6), the same chain state,
  commit outcomes, audit summaries and resilience snapshots.
- The faithful ``commit``: the same chain state, and the same refusal of
  a quarantined block.
- The request-fed branch (``fetch(window=...)``): the rolling window and
  its power-of-two tiling, the cold-start ``DegenerateBlockError`` with
  its ``commit.deferred`` event, the same fingerprints.
- ``preview_stats`` and ``rank_array`` against the reference's jitted
  preview at odd and even N, with NaN and Inf rows.
- The entry points default to CUDA and raise without a card;
  ``quant_inference="int8"`` builds the W8A8 vectorizer.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp

from svoc_tpu.apps import session as ref_session
from svoc_tpu.fabric.scenario import deterministic_vectorizer
from svoc_tpu.io.comment_store import CommentStore as RefStore
from svoc_tpu.ops.stats import rank_array as ref_rank_array
from svoc_tpu.robustness.sanitize import QuarantinedInputError as RefQuarantined
from svoc_tpu.utils.events import EventJournal as RefJournal

from svoc_torch.apps import session
from svoc_torch.fabric import MultiSession, run_fabric_scenario
from svoc_torch.io.comment_store import CommentStore
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.ops.stats import rank_array
from svoc_torch.robustness.sanitize import QuarantinedInputError
from svoc_torch.tools import fabric_smoke
from svoc_torch.utils.events import EventJournal


def _nan_offender(block):
    block = np.array(block, copy=True)
    block[6, 0] = np.nan
    return block


def _pair(mode, seed=5, comments=120, **cfg):
    """A reference and a port session over the same seeded store."""
    texts = SyntheticSource(batch=comments, seed=seed)()
    out = []
    for mod, store_cls, journal_cls, kw in (
        (ref_session, RefStore, RefJournal, {}),
        (session, CommentStore, EventJournal, {"device": "cpu"}),
    ):
        store = store_cls()
        if comments:
            store.save(texts)
        config = mod.SessionConfig(seed=seed, lineage_scope="t", commit_mode=mode, **cfg)
        out.append(mod.Session(config, store=store, vectorizer=deterministic_vectorizer,
                               journal=journal_cls(), **kw))
    return out


def _chain(s):
    c = s.adapter.backend.contract
    return (c.consensus_active, list(c.consensus_value), c.reliability_first_pass,
            c.reliability_second_pass, list(c.skewness), list(c.kurtosis),
            [(o.address, list(o.value), o.enabled, o.reliable) for o in c.oracles])


def _same_preview(p, r):
    np.testing.assert_array_equal(p["values"], r["values"])
    np.testing.assert_array_equal(p["honest"], np.asarray(r["honest"]))
    for key in ("mean", "median", "normalized_ranks"):
        np.testing.assert_allclose(p[key], np.asarray(r[key]), atol=1e-6, rtol=0)
    assert (p["lineage"], p["n_comments"], p["quarantine"]) == (
        r["lineage"], r["n_comments"], r["quarantine"]
    )


@pytest.mark.parametrize("mode", ["per_tx", "batched"])
def test_store_cycles_match_the_reference(mode):
    ref, port = _pair(mode)
    for cycle in range(6):
        tamper = _nan_offender if cycle in (2, 4) else None
        _same_preview(port.fetch(tamper=tamper), ref.fetch(tamper=tamper))
        p_out, r_out = port.commit_resilient(), ref.commit_resilient()
        assert (p_out.sent, p_out.total, p_out.stranded, p_out.attempts) == (
            r_out.sent, r_out.total, r_out.stranded, r_out.attempts
        )
        p_sup, r_sup = port.supervisor_step(), ref.supervisor_step()
        assert {k: v for k, v in p_sup.items() if k != "replaced"} == {
            k: v for k, v in r_sup.items() if k != "replaced"
        }
        assert _chain(port) == _chain(ref)
        assert port.journal.fingerprint() == ref.journal.fingerprint()
    assert port.audit()["summary"] == ref.audit()["summary"]
    p_snap, r_snap = port.resilience_snapshot(), ref.resilience_snapshot()
    assert p_snap == r_snap
    assert port.commit_mode == ref.commit_mode == mode
    assert port.simulation_step == ref.simulation_step
    assert port.label_names == ref.label_names


def test_faithful_commit_and_its_refusal():
    ref, port = _pair("per_tx", seed=9)
    for _ in range(2):
        port.fetch()
        ref.fetch()
        assert port.commit() == ref.commit() == 7
        assert _chain(port) == _chain(ref)
    port.fetch(tamper=_nan_offender)
    ref.fetch(tamper=_nan_offender)
    with pytest.raises(QuarantinedInputError) as p_err:
        port.commit()
    with pytest.raises(RefQuarantined) as r_err:
        ref.commit()
    assert p_err.value.report.reasons == r_err.value.report.reasons == {6: "nan"}
    assert port.journal.fingerprint() == ref.journal.fingerprint()


@pytest.mark.parametrize("mode", ["per_tx", "batched"])
def test_request_fed_branch_matches_the_reference(mode):
    ref, port = _pair(mode, seed=2, comments=0)
    rng = np.random.default_rng(2)
    one = rng.uniform(0.05, 0.95, size=(1, 6))
    # Cold start: a one-request block is degenerate and defers.
    for s in (port, ref):
        s.fetch(window=one)
    with pytest.raises(session.DegenerateBlockError):
        port.commit_resilient()
    with pytest.raises(ref_session.DegenerateBlockError):
        ref.commit_resilient()
    for k in (3, 2, 17, 60, 5):
        feed = rng.uniform(0.05, 0.95, size=(k, 6))
        _same_preview(port.fetch(window=feed), ref.fetch(window=feed))
        p_out, r_out = port.commit_resilient(), ref.commit_resilient()
        assert (p_out.sent, p_out.stranded) == (r_out.sent, r_out.stranded)
        assert _chain(port) == _chain(ref)
    assert port._request_window.shape == (50, 6)
    np.testing.assert_array_equal(port._request_window.numpy(), ref._request_window)
    assert port.journal.fingerprint() == ref.journal.fingerprint()
    with pytest.raises(ValueError):
        port.fetch(window=np.zeros((3, 5)))
    with pytest.raises(session.EmptyStoreError):
        port.fetch(window=np.zeros((0, 6)))


def test_empty_store_raises():
    _, port = _pair("per_tx", comments=0)
    with pytest.raises(session.EmptyStoreError):
        port.fetch()


@pytest.mark.parametrize("n", [7, 8, 6, 2])
def test_preview_stats_match_the_reference(n):
    rng = np.random.default_rng(n)
    cases = [rng.uniform(0.05, 0.95, size=(n, 6))]
    inf, nan = cases[0].copy(), cases[0].copy()
    inf[n - 1, :] = np.inf
    nan[0, 2] = np.nan
    ties = np.repeat(cases[0][:1], n, axis=0)
    for values in cases + [inf, nan, ties]:
        values = values.astype(np.float32)
        mean, median, ranks = session.preview_stats(torch.from_numpy(values))
        r_mean, r_median, r_ranks = ref_session._preview_stats(jnp.asarray(values))
        for got, want in ((mean, r_mean), (median, r_median), (ranks, r_ranks)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_rank_array_matches_the_reference():
    rng = np.random.default_rng(0)
    for scores in (rng.random(9), np.array([1.0, np.nan, 0.5, np.inf, 0.5, np.nan]),
                   np.zeros(4)):
        scores = scores.astype(np.float32)
        norm, ranks = rank_array(torch.from_numpy(scores))
        r_norm, r_ranks = ref_rank_array(jnp.asarray(scores))
        np.testing.assert_array_equal(ranks.numpy(), np.asarray(r_ranks))
        np.testing.assert_array_equal(norm.numpy(), np.asarray(r_norm))


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        session.Session()
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiSession()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fabric_scenario(0, cycles=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        fabric_smoke.main(["--cycles", "1"])


def test_parts_that_wait_raise_not_implemented(tmp_path):
    # The W8A8 vectorizer now builds (folded from the float weights).
    from svoc_torch.models.quant import QuantizedPackedSentimentEncoder

    s = session.Session(session.SessionConfig(quant_inference="int8"), device="cpu")
    assert s.vectorizer.quant == "int8"
    assert isinstance(s.vectorizer.packed_model, QuantizedPackedSentimentEncoder)

    # A commit on an open WAL cycle now reconciles it, as the reference
    # does (tests/test_torch_durable.py); the compile plane's persistent
    # cache and recovery prewarm now run (tests/test_torch_compile_plane.py).
    from svoc_torch.compile import cache
    from svoc_torch.durability.recovery import RecoveryManager
    from svoc_torch.ops import _build

    multi = MultiSession(device="cpu", warmup_mode="prewarm")
    previous = _build.build_dir()
    try:
        manager = RecoveryManager(multi, out_dir=str(tmp_path), compilation_cache="persistent")
        assert manager.compile_cache_dir == cache.persistent_cache_dir(str(tmp_path))
        assert str(_build.build_dir()) == manager.compile_cache_dir
        assert manager.recover(prewarm=True)["prewarm"]["report"]["universe"]["keys"] == 0
    finally:
        cache.disable_persistent_cache()
        _build.set_build_dir(previous)


def test_slo_snapshot_after_cycles():
    _, port = _pair("batched")
    for _ in range(2):
        port.fetch()
        port.commit_resilient()
    snap = port.slo_snapshot()
    assert set(snap) == {"commit_success", "consensus_latency", "quarantine_admission"}
    assert set(port.slo_step()) == set(snap)
