"""The port's multi-claim serving path against the JAX package's, on the
CPU.

Inputs are made with numpy from a seed and go through both packages.
The bars are those of ``tests/test_pallas_consensus.py``: the reliable
mask and ``interval_valid`` exact; essence, essence₁, reliabilities and
finite risks within 1e-5 (infinite risks equal); skewness within 1e-4;
kurtosis within 1e-3.  The gated claim cube is held against both the
XLA ``consensus_step_gated_claims`` and the Pallas
``fused_consensus_gated_claims`` in interpret mode (N ≤ 256).
"""

import collections
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.consensus import batch as jax_batch
from svoc_tpu.consensus.kernel import ConsensusConfig as JaxConfig
from svoc_tpu.consensus.kernel import consensus_step as jax_consensus_step
from svoc_tpu.consensus.kernel import consensus_step_gated as jax_gated
from svoc_tpu.consensus.kernel import consensus_step_gated_claims as jax_gated_claims
from svoc_tpu.fabric.registry import ClaimSpec as JaxClaimSpec
from svoc_tpu.fabric.scenario import _claim_names
from svoc_tpu.models import configs as jax_configs
from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder
from svoc_tpu.models.encoder import init_params as jax_init_params
from svoc_tpu.models.packing import PackedSentimentEncoder as JaxPacked
from svoc_tpu.models.packing import pack_tokens as jax_pack_tokens
from svoc_tpu.models.packing import strip_padding as jax_strip_padding
from svoc_tpu.models.sentiment import scores_to_vectors as jax_scores_to_vectors
from svoc_tpu.models.tokenizer import HashingTokenizer as JaxTokenizer
from svoc_tpu.ops.pallas_consensus import fused_consensus_gated_claims as jax_fused_gated
from svoc_tpu.robustness import sanitize as jax_sanitize
from svoc_tpu.serving.batcher import MicroBatcher as JaxMicroBatcher
from svoc_tpu.sim.generators import claim_seed as jax_claim_seed
from svoc_tpu.sim.oracle import gen_oracle_predictions as jax_gen_oracle_predictions
from svoc_tpu.utils.events import EventJournal
from svoc_tpu.utils.metrics import MetricsRegistry

from svoc_torch.apps import session as torch_session
from svoc_torch.apps.session import request_window
from svoc_torch.consensus import batch as torch_batch
from svoc_torch.consensus.kernel import (
    ConsensusConfig,
    consensus_step,
    consensus_step_gated,
    consensus_step_gated_claims,
)
from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.fabric.router import dispatch_group
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import TINY_TEST
from svoc_torch.models.from_jax import params_from_flax
from svoc_torch.ops.fused_consensus import (
    fused_consensus_gated_claims,
    fused_consensus_gated_claims_cuda,
    fused_consensus_gated_claims_plain,
)
from svoc_torch.robustness import sanitize as torch_sanitize
from svoc_torch.serving.batcher import ClaimQueues, Request, group_by_claim
from svoc_torch.serving.tier import ClaimServingStep
from svoc_torch.sim.generators import claim_seed
from svoc_torch.sim.oracle import FleetDraws

FLOAT_FIELDS = ("essence", "essence_first_pass", "reliability_first_pass",
                "reliability_second_pass")


def assert_claims_match(out, ref):
    """Field for field at the reference's bars; ``ref`` is a JAX output
    (or a tuple of arrays) with a leading claim axis."""
    np.testing.assert_array_equal(np.asarray(out.reliable), np.asarray(ref.reliable))
    np.testing.assert_array_equal(np.asarray(out.interval_valid), np.asarray(ref.interval_valid))
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(
            np.asarray(getattr(out, field)), np.asarray(getattr(ref, field)), atol=1e-5,
            rtol=0, err_msg=field,
        )
    qr, ref_qr = np.asarray(out.quadratic_risk), np.asarray(ref.quadratic_risk)
    finite = np.isfinite(ref_qr)
    np.testing.assert_array_equal(np.isfinite(qr), finite)
    np.testing.assert_array_equal(qr[~finite], ref_qr[~finite])
    np.testing.assert_allclose(qr[finite], ref_qr[finite], atol=1e-5, rtol=0, err_msg="risk")
    np.testing.assert_allclose(np.asarray(out.skewness), np.asarray(ref.skewness), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(out.kurtosis), np.asarray(ref.kurtosis), atol=1e-3, rtol=0)


def spectrum_cube(c, n, dim, constrained, seed):
    """``tests/test_pallas_consensus.py``'s degenerate spectrum in one
    cube: a clean claim, a partly quarantined claim with a NaN row, an
    all-quarantined claim (n_ok = 0), a single survivor (n_ok = 1)."""
    rng = np.random.default_rng(seed)
    if constrained:
        values = rng.uniform(0.01, 0.99, (c, n, dim)).astype(np.float32)
    else:
        values = (20.0 + 3.0 * rng.standard_normal((c, n, dim))).astype(np.float32)
    ok = np.ones((c, n), dtype=bool)
    if c > 1:
        ok[1, : max(1, n // 4)] = False
        values[1, 0, :] = np.nan
    if c > 2:
        ok[2, :] = False
    if c > 3:
        ok[3, : n - 1] = False
    return values, ok


GATED_CASES = [
    # (C, N, n_failing, dim, constrained): tests/test_pallas_consensus.py:172-178
    (4, 7, 2, 6, True),
    (4, 7, 2, 6, False),
    (3, 16, 4, 3, True),
    (2, 256, 64, 6, True),
]
PORT_FORMS = {
    "consensus_step_gated_claims": consensus_step_gated_claims,
    "fused_consensus_gated_claims_plain": fused_consensus_gated_claims_plain,
}


_jit_gated_claims = jax.jit(jax_gated_claims, static_argnums=3)


def jax_xla_gated(values, ok, claim_mask, cfg):
    """JAX ``consensus_step_gated_claims``, jitted where that keeps the
    numbers: the jitted program contracts the risk's products and sums
    into FMAs, which moves an unconstrained risk near 2000 by an ulp
    (2.4e-4, over the bar); op by op it sums in column order, as the port
    does, and a constrained risk (at most 6) moves by under 1e-6."""
    args = (jnp.asarray(values), jnp.asarray(ok), jnp.asarray(claim_mask))
    if cfg.constrained:
        return _jit_gated_claims(*args, cfg)
    return jax_gated_claims(*args, cfg)


@functools.lru_cache(maxsize=None)
def _jax_refs(c, n, f, dim, constrained):
    """The XLA and the interpret-mode Pallas outputs for one case."""
    values, ok = spectrum_cube(c, n, dim, constrained, seed=c * n + dim)
    cfg = JaxConfig(n_failing=f, constrained=constrained, max_spread=10.0)
    mask = np.ones(c, dtype=bool)
    pallas = jax_fused_gated(jnp.asarray(values), jnp.asarray(ok), jnp.asarray(mask), cfg,
                             interpret=True)
    return values, ok, jax_xla_gated(values, ok, mask, cfg), pallas


@pytest.mark.parametrize("form", sorted(PORT_FORMS))
@pytest.mark.parametrize("c,n,f,dim,constrained", GATED_CASES)
def test_gated_claim_cube_matches_jax(c, n, f, dim, constrained, form):
    values, ok, xla, pallas = _jax_refs(c, n, f, dim, constrained)
    cfg = ConsensusConfig(n_failing=f, constrained=constrained, max_spread=10.0)
    out = PORT_FORMS[form](
        torch.from_numpy(values), torch.from_numpy(ok), torch.ones(c, dtype=torch.bool), cfg
    )
    assert_claims_match(out, xla)
    assert_claims_match(out, pallas)
    valid = out.interval_valid.numpy()
    if c > 2:
        assert not valid[2] and np.isinf(out.quadratic_risk[2].numpy()).all()
        assert np.all(out.essence[2].numpy() == 0) and np.all(out.essence_first_pass[2].numpy() == 0)
    if c > 3:
        assert not valid[3]


@pytest.mark.parametrize("form", sorted(PORT_FORMS))
def test_padding_claims_come_back_inactive(form):
    values = np.random.default_rng(7).uniform(0.01, 0.99, (3, 8, 4)).astype(np.float32)
    jv, jo, jm = jax_batch.pad_claim_cube(values)
    tv, to, tm = torch_batch.pad_claim_cube(values)
    cfg = ConsensusConfig(n_failing=2)
    jcfg = JaxConfig(n_failing=2)
    ref = jax_fused_gated(jnp.asarray(jv), jnp.asarray(jo), jnp.asarray(jm), jcfg, interpret=True)
    out = PORT_FORMS[form](tv, to, tm, cfg)
    assert_claims_match(out, ref)
    assert_claims_match(out, jax_xla_gated(jv, jo, jm, jcfg))
    assert not out.interval_valid[3] and not out.reliable[3].any()
    assert torch.all(out.essence[3] == 0) and torch.all(out.quadratic_risk[3] == 0)


@pytest.mark.parametrize("form", sorted(PORT_FORMS))
def test_n_failing_guard(form):
    n = 8
    values = np.random.default_rng(1).uniform(0.1, 0.9, (2, n, 3)).astype(np.float32)
    ok = np.ones((2, n), dtype=bool)
    ref = jax_xla_gated(values, ok, np.ones(2, dtype=bool), JaxConfig(n_failing=n - 1))
    out = PORT_FORMS[form](torch.from_numpy(values), torch.from_numpy(ok),
                           torch.ones(2, dtype=torch.bool), ConsensusConfig(n_failing=n - 1))
    assert_claims_match(out, ref)
    assert not out.interval_valid.any() and torch.isfinite(out.essence).all()


@pytest.mark.parametrize("form", sorted(PORT_FORMS))
def test_tie_fixture_and_quantised_cube(form):
    """The reference's tie fixture (three equal outliers, two masked,
    ``tests/test_pallas_consensus.py:254-271``) and a cube quantised to
    1e-2 with quarantined rows: the reliable sets are exact."""
    base = np.array([[0.5], [0.5], [0.9], [0.9], [0.9], [0.5], [0.5]], np.float32)
    rng = np.random.default_rng(11)
    ties = np.round(rng.uniform(0.2, 0.8, (3, 64, 6)), 2).astype(np.float32)
    ties_ok = rng.uniform(size=(3, 64)) > 0.1
    for values, ok, f in (
        (np.stack([base, base[::-1]]), np.ones((2, 7), dtype=bool), 2),
        (ties, ties_ok, 8),
    ):
        args = (jnp.asarray(values), jnp.asarray(ok), jnp.ones(len(values), dtype=bool))
        ref = jax_xla_gated(values, ok, np.ones(len(values), dtype=bool), JaxConfig(n_failing=f))
        out = PORT_FORMS[form](torch.from_numpy(values), torch.from_numpy(ok),
                               torch.ones(len(values), dtype=torch.bool), ConsensusConfig(n_failing=f))
        assert_claims_match(out, ref)
        assert_claims_match(out, jax_fused_gated(*args, JaxConfig(n_failing=f), interpret=True))


def test_gated_with_every_oracle_admitted_is_the_ungated_step():
    values = np.random.default_rng(5).uniform(0.01, 0.99, (64, 6)).astype(np.float32)
    cfg = ConsensusConfig(n_failing=16)
    ref = jax.jit(jax_consensus_step, static_argnums=1)(jnp.asarray(values), JaxConfig(n_failing=16))
    gated = consensus_step_gated(torch.from_numpy(values), torch.ones(64, dtype=torch.bool), cfg)
    plain = consensus_step(torch.from_numpy(values), cfg)
    for out in (gated, plain):
        assert_claims_match(out, ref)
    ref_gated = jax.jit(jax_gated, static_argnums=2)(
        jnp.asarray(values), jnp.ones(64, dtype=bool), JaxConfig(n_failing=16))
    assert_claims_match(gated, ref_gated)


def test_fused_dispatch_takes_the_plain_version_on_cpu():
    values, ok = spectrum_cube(4, 16, 6, True, seed=3)
    v, o = torch.from_numpy(values), torch.from_numpy(ok)
    cfg = ConsensusConfig(n_failing=4)
    before = fused_consensus_gated_claims_cuda.launches
    got = fused_consensus_gated_claims(v, o, None, cfg)
    want = fused_consensus_gated_claims_plain(v, o, torch.ones(4, dtype=torch.bool), cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused_consensus_gated_claims_cuda.launches == before


# ---------------------------------------------------------------------------
# Padding and buckets
# ---------------------------------------------------------------------------


def test_pow2_bucket_matches():
    for n in range(0, 70):
        for floor in (1, 4):
            for multiple in (1, 3, 8):
                assert torch_batch.pow2_bucket(n, floor, multiple) == jax_batch.pow2_bucket(
                    n, floor, multiple
                ), (n, floor, multiple)
    for bad in ((-1, 1, 1), (3, 1, 0)):
        with pytest.raises(ValueError):
            torch_batch.pow2_bucket(*bad)


@pytest.mark.parametrize("c,floor,multiple,with_ok", [
    (1, 1, 1, False), (3, 1, 1, True), (4, 1, 1, True), (5, 8, 1, True), (6, 1, 3, True),
    (9, 1, 4, False),
])
def test_pad_claim_cube_gives_the_same_arrays(c, floor, multiple, with_ok):
    rng = np.random.default_rng(c)
    values = rng.uniform(size=(c, 5, 3))  # float64 in, float32 out, as the reference
    ok = rng.uniform(size=(c, 5)) > 0.3 if with_ok else None
    ref = jax_batch.pad_claim_cube(values, ok, floor=floor, multiple_of=multiple)
    out = torch_batch.pad_claim_cube(values, ok, floor=floor, multiple_of=multiple)
    for a, b in zip(out, ref):
        assert a.dtype == {np.dtype(np.float32): torch.float32, np.dtype(bool): torch.bool}[b.dtype]
        np.testing.assert_array_equal(a.numpy(), b)


def test_pad_claim_cube_refuses_bad_shapes():
    with pytest.raises(ValueError, match=r"\[C, N, M\]"):
        torch_batch.pad_claim_cube(np.zeros((3, 4)))
    with pytest.raises(ValueError, match="ok must be"):
        torch_batch.pad_claim_cube(np.zeros((3, 4, 2)), np.ones((3, 5), dtype=bool))


# ---------------------------------------------------------------------------
# The quarantine gate
# ---------------------------------------------------------------------------


def faulty_fleet(n, dim, seed, constrained=True):
    """A fleet with rows tripping every reason, one row tripping several
    (NaN and out of range: precedence says nan)."""
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.05, 0.95, (n, dim)) if constrained else rng.normal(20.0, 3.0, (n, dim))
    values[1, 2] = np.nan
    values[2, :] = np.inf
    values[3, 0] = -np.inf
    values[4, 1] = 7.5 if constrained else 1e33
    values[5, 0] = -0.25 if constrained else -1e35
    values[6, 3] = 1e33
    values[7, :2] = (np.nan, 9.0)
    return values.astype(np.float32)


@pytest.mark.parametrize("constrained", [True, False])
def test_quarantine_masks_and_reasons_match(constrained):
    bounds = torch_sanitize.SanitizeConfig.for_consensus(constrained)
    jbounds = jax_sanitize.SanitizeConfig.for_consensus(constrained)
    assert (bounds.lo, bounds.hi) == (jbounds.lo, jbounds.hi)
    cube = np.stack([faulty_fleet(12, 6, s, constrained) for s in range(3)])
    ref = jax.vmap(lambda v: jax_sanitize.quarantine_reasons_jax(v, jbounds.lo, jbounds.hi))(
        jnp.asarray(cube)
    )
    got = torch_sanitize.quarantine_reasons(torch.from_numpy(cube), bounds.lo, bounds.hi)
    for name in torch_sanitize.QUARANTINE_REASONS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), name)
    ok = torch_sanitize.quarantine_mask_claims(torch.from_numpy(cube), bounds.lo, bounds.hi)
    np.testing.assert_array_equal(
        ok.numpy(), np.asarray(jax_sanitize.quarantine_mask_claims(jnp.asarray(cube), jbounds.lo, jbounds.hi))
    )
    np.testing.assert_array_equal(
        torch_sanitize.quarantine_mask(torch.from_numpy(cube[0]), bounds.lo, bounds.hi).numpy(),
        np.asarray(jax_sanitize.quarantine_mask_jax(jnp.asarray(cube[0]), jbounds.lo, jbounds.hi)),
    )

    gate = torch_sanitize.QuarantineGate(bounds)
    jgate = jax_sanitize.QuarantineGate(jbounds, registry=MetricsRegistry(), journal=EventJournal())
    for block in cube:
        report, jreport = gate.inspect(block), jgate.inspect(block)
        assert report.reasons == jreport.reasons
        np.testing.assert_array_equal(report.ok, jreport.ok)
        assert report.as_dict() == jreport.as_dict()
    assert gate.slots_inspected == cube.shape[0] * cube.shape[1]
    assert sum(gate.reasons.values()) == int((~ok.numpy()).sum())
    assert set(gate.reasons) <= set(torch_sanitize.QUARANTINE_REASONS)
    again = gate.inspect(torch.from_numpy(cube[0]), count=False)
    assert gate.slots_inspected == cube.shape[0] * cube.shape[1]
    err = torch_sanitize.QuarantinedInputError(again)
    assert str(err) == str(jax_sanitize.QuarantinedInputError(jgate.inspect(cube[0], count=False)))


def test_sanitize_constants_match():
    assert torch_sanitize.WSAD_LIMIT == jax_sanitize.WSAD_LIMIT
    assert torch_sanitize.QUARANTINE_REASONS == jax_sanitize.QUARANTINE_REASONS
    with pytest.raises(ValueError):
        torch_sanitize.SanitizeConfig(lo=1.0, hi=0.0)


# ---------------------------------------------------------------------------
# The claim dispatch
# ---------------------------------------------------------------------------


def mixed_cube(seed):
    """Five claims of 32 oracles: clean ones, one with faulty rows the
    gate must catch, and admission masks for the gated call that leave
    the faulty rows out.  (An admitted infinite risk is where the
    reference's jitted and op-by-op programs part: XLA turns the
    unconstrained ``min(ms, inf) / ms`` into a product with ``1 / ms``,
    and rel₁ comes out -1.5e-8, not 0.)"""
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.02, 0.98, (5, 32, 6)).astype(np.float32)
    values[2, :8] = faulty_fleet(8, 6, seed)
    ok = rng.uniform(size=(5, 32)) > 0.15
    ok[2, 1:8] = False
    return values, ok


@pytest.mark.parametrize("constrained", [True, False])
def test_claim_dispatch_matches_the_xla_route(constrained):
    values, ok = mixed_cube(seed=21)
    jcfg = JaxConfig(n_failing=6, constrained=constrained)
    cfg = ConsensusConfig(n_failing=6, constrained=constrained)
    jv, jo, jm = jax_batch.pad_claim_cube(values, ok)
    tv, to, tm = torch_batch.pad_claim_cube(values, ok)
    clean_v = np.where(np.isfinite(jv) & (np.abs(jv) < 1e30), jv, 0.5).astype(np.float32)
    assert_claims_match(
        torch_batch.claims_consensus(torch.from_numpy(clean_v), tm, cfg),
        jax_batch.claims_consensus(jnp.asarray(clean_v), jnp.asarray(jm), jcfg, consensus_impl="xla"),
    )
    assert_claims_match(
        torch_batch.claims_consensus_gated(tv, to, tm, cfg),
        jax_batch.claims_consensus_gated(jnp.asarray(jv), jnp.asarray(jo), jnp.asarray(jm), jcfg,
                                         consensus_impl="xla"),
    )
    bounds = torch_sanitize.SanitizeConfig.for_consensus(constrained)
    out, got_ok = torch_batch.claims_consensus_sanitized(tv, tm, cfg, bounds.lo, bounds.hi)
    ref, ref_ok = jax_batch.claims_consensus_sanitized(
        jnp.asarray(jv), jnp.asarray(jm), jcfg, bounds.lo, bounds.hi, consensus_impl="xla"
    )
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    assert not got_ok[2, [1, 2, 3, 6, 7]].any() and got_ok[:, 8:].all()
    assert bool(got_ok[2, 4:6].all()) != constrained  # 7.5 and -0.25 are out of [0, 1] only
    assert_claims_match(out, ref)

    # The router's group dispatch keeps the first C rows of the same call.
    blocks = [torch.from_numpy(b) for b in values]
    d_out, d_ok = dispatch_group(blocks, None, cfg, sanitized=True)
    assert d_ok.shape == (5, 32)
    assert_claims_match(d_out, type(ref)(*(np.asarray(f)[:5] for f in ref)))
    g_out, g_ok = dispatch_group(blocks, [torch.from_numpy(o) for o in ok], cfg)
    np.testing.assert_array_equal(g_ok.numpy(), ok)
    gated_ref = jax_batch.claims_consensus_gated(
        jnp.asarray(jv), jnp.asarray(jo), jnp.asarray(jm), jcfg, consensus_impl="xla")
    assert_claims_match(g_out, type(gated_ref)(*(np.asarray(f)[:5] for f in gated_ref)))


@pytest.mark.parametrize("fn", ["claims_consensus", "claims_consensus_gated", "claims_consensus_sanitized"])
def test_consensus_impl_routing_is_refused(fn):
    values, ok = mixed_cube(seed=1)
    tv, to, tm = torch_batch.pad_claim_cube(values, ok)
    args = {
        "claims_consensus": (tv, tm, ConsensusConfig()),
        "claims_consensus_gated": (tv, to, tm, ConsensusConfig()),
        "claims_consensus_sanitized": (tv, tm, ConsensusConfig(), 0.0, 1.0),
    }[fn]
    with pytest.raises(ValueError, match="one route per device"):
        getattr(torch_batch, fn)(*args, consensus_impl="xla")


# ---------------------------------------------------------------------------
# Seeds, specs, windows, assembly
# ---------------------------------------------------------------------------


def test_claim_seed_is_bit_identical():
    for base in (0, 1, 7, 2**31, 123456789012):
        for cid in ("alpha", "delta", "claim63", "", 5, ("a", 1)):
            assert claim_seed(base, cid) == jax_claim_seed(base, cid)


@pytest.mark.parametrize("kwargs", [
    dict(claim_id=""), dict(claim_id="a-b"), dict(claim_id="a/b"), dict(claim_id="a", weight=0),
    dict(claim_id="a", constrained=False, max_spread=0.0),
])
def test_claim_spec_validation_matches(kwargs):
    with pytest.raises(ValueError) as jerr:
        JaxClaimSpec(**kwargs)
    with pytest.raises(ValueError) as err:
        ClaimSpec(**kwargs)
    assert str(err.value) == str(jerr.value)


def test_claim_spec_consensus_config():
    spec = ClaimSpec("alpha", n_failing=128, constrained=False, max_spread=3.0)
    jspec = JaxClaimSpec("alpha", n_failing=128, constrained=False, max_spread=3.0)
    assert dataclasses.asdict(spec.consensus_config()) == dataclasses.asdict(jspec.consensus_config())


def reference_window(previous, new, cap, subset_cap=10):
    """``svoc_tpu/apps/session.py:558-589``, the request branch of
    ``Session.fetch``, in numpy."""
    window_np = np.asarray(new, dtype=np.float32)
    if previous is not None:
        window_np = np.concatenate([previous, window_np])
    window_np = window_np[-cap:]
    kept = window_np
    rows = int(window_np.shape[0])
    bucket = 1 << max(0, rows - 1).bit_length()
    if bucket > rows:
        window_np = np.resize(window_np, (bucket, window_np.shape[1]))
    return kept, window_np, min(subset_cap, max(1, bucket // 2))


def test_request_window_follows_the_session_rule():
    rng = np.random.default_rng(0)
    prev_ref = prev = None
    for rows in (1, 7, 8, 50, 60, 1, 7):
        new = rng.uniform(size=(rows, 6)).astype(np.float32)
        kept_ref, tiled_ref, subset_ref = reference_window(prev_ref, new, 50)
        kept, tiled, subset = request_window(prev, torch.from_numpy(new), 50)
        np.testing.assert_array_equal(kept.numpy(), kept_ref)
        np.testing.assert_array_equal(tiled.numpy(), tiled_ref)
        assert subset == subset_ref
        prev_ref, prev = kept_ref, kept
    with pytest.raises(ValueError):
        request_window(None, torch.zeros(0, 6))
    with pytest.raises(ValueError):
        request_window(torch.zeros(3, 6), torch.zeros(2, 5))


class _Frontend:
    """What ``MicroBatcher.assemble`` reads of a ``ServingFrontend``."""

    def __init__(self, queues):
        self.queues = {cid: collections.deque(q) for cid, q in queues.items()}
        self.multi = self

    def claim_ids(self):
        return list(self.queues)

    def depth(self, cid):
        return len(self.queues[cid])

    def is_cold(self, cid):
        return False

    def drain(self, cid, n):
        return [self.queues[cid].popleft() for _ in range(min(n, len(self.queues[cid])))]


@pytest.mark.parametrize("max_requests", [1, 5, 9, 64])
def test_assembly_order_matches_the_micro_batcher(max_requests):
    depths = {"alpha": 3, "beta": 0, "gamma": 5, "delta": 1}
    queues = ClaimQueues(depths)
    for cid, d in depths.items():
        for i in range(d):
            queues.submit(cid, f"{cid} {i}")
    frontend = _Frontend({cid: [Request(cid, f"{cid} {i}") for i in range(d)] for cid, d in depths.items()})
    jax_batcher = JaxMicroBatcher(frontend, vectorizer=None, max_requests=max_requests,
                                  metrics=MetricsRegistry())
    assert queues.assemble(max_requests) == jax_batcher.assemble()
    with pytest.raises(KeyError):
        queues.submit("omega", "x")


def test_group_by_claim_matches():
    rng = np.random.default_rng(3)
    claims = ["b", "a", "b", "c", "a", "b"]
    vectors = rng.uniform(size=(len(claims), 6))
    requests = [Request(c, str(i)) for i, c in enumerate(claims)]
    jax_requests = [
        type("R", (), dict(claim=c, vector=v, request_id=i))() for i, (c, v) in enumerate(zip(claims, vectors))
    ]
    ref = JaxMicroBatcher.group_by_claim(jax_requests)
    got = group_by_claim(requests, torch.from_numpy(vectors.astype(np.float32)))
    assert list(got) == list(ref)
    for cid in ref:
        np.testing.assert_array_equal(got[cid].numpy(), ref[cid])


# ---------------------------------------------------------------------------
# The multi-claim step at small size, end to end
# ---------------------------------------------------------------------------


def _jax_draws(key, w, m, n_oracles, n_failing, subset):
    """The random numbers ``gen_oracle_predictions`` draws from ``key``."""
    k_fail, k_boot, k_perm = jax.random.split(key, 3)
    failing = jax.random.uniform(k_fail, (n_failing, m))
    boot = jax.vmap(lambda k: jax.random.choice(k, w, shape=(subset,), replace=False))(
        jax.random.split(k_boot, n_oracles - n_failing)
    )
    perm = jax.random.permutation(k_perm, n_oracles)
    return FleetDraws(*(torch.from_numpy(np.array(a)) for a in (failing, boot, perm)))


def _tamper(kind, block, slot):
    """The fabric scenario's tamper (``svoc_tpu/fabric/scenario.py:140-152``)."""
    if kind == "nan":
        block[slot, 0] = np.nan
    elif kind == "inf":
        block[slot, :] = np.inf
    elif kind == "range":
        block[slot, :] = 7.5
    return block


def test_small_multi_claim_step_matches_jax(monkeypatch):
    """TINY_TEST encoder (flax weights carried across), 4 claims x 16
    oracles, the last claim's slot 15 tampered in rotation (a NaN
    component, an inf row, a 7.5 row): the port's
    ``ClaimServingStep`` against the JAX packed forward → per-claim
    windows → ``claims_consensus_sanitized``, with JAX's fleet draws fed
    to the port."""
    names = _claim_names(4)
    n_oracles, n_failing, rows, seq, max_seg = 16, 4, 16, 32, 4
    kinds = [None, "nan", "inf", "range"]  # cycle 0 clean, as in the fabric scenario
    offender = names[-1]
    specs = [
        ClaimSpec(cid, seed=claim_seed(0, cid), n_oracles=n_oracles, n_failing=n_failing,
                  tamper=(lambda cycle, block: _tamper(kinds[cycle], np.array(block, copy=True),
                                                       n_oracles - 1))
                  if cid == offender else None)
        for cid in names
    ]
    flax_params = jax_init_params(JaxEncoder(jax_configs.TINY_TEST), seed=1)
    step = ClaimServingStep(specs, TINY_TEST, rows=rows, seq=seq, max_seg=max_seg,
                            params=params_from_flax(flax_params), params_dtype=None, device="cpu")
    draws = collections.deque()
    monkeypatch.setattr(torch_session, "draw_fleet", lambda *args: draws.popleft())

    assert step.pipe.cfg.attention == "flash"  # the step sets it; so does the JAX side
    jcfg = dataclasses.replace(jax_configs.TINY_TEST, attention="flash")
    jtok = JaxTokenizer(jcfg.vocab_size, pad_id=jcfg.pad_id, max_len=seq)
    sources = {cid: SyntheticSource(batch=3, seed=claim_seed(0, cid)) for cid in names}
    keys = {cid: jax.random.PRNGKey(claim_seed(0, cid)) for cid in names}
    windows = dict.fromkeys(names)
    cfg = JaxConfig(n_failing=n_failing)
    for cycle, kind in enumerate(kinds):
        queues = ClaimQueues(names)
        for cid in names:
            for text in sources[cid]():
                queues.submit(cid, text)
        requests = queues.assemble(64)

        # JAX: packed forward -> per-request vectors -> windows -> fleets.
        batch, n = jax_pack_tokens(jax_strip_padding(*jtok([r.text for r in requests], seq)),
                                   seq, max_seg, jtok.pad_id, rows=rows)
        assert n == len(requests)
        logits = JaxPacked(jcfg).apply(
            flax_params, *map(jnp.asarray, (batch.ids, batch.pos, batch.seg, batch.cls_pos)))
        vecs = np.asarray(jax_scores_to_vectors(logits.reshape(rows * max_seg, -1)))
        valid = batch.seg_valid.reshape(-1) > 0
        per_request = np.zeros((len(requests), 6), np.float32)
        per_request[batch.owner.reshape(-1)[valid]] = vecs[valid]
        blocks = []
        for cid in names:
            feed = per_request[[i for i, r in enumerate(requests) if r.claim == cid]]
            windows[cid], tiled, subset = reference_window(windows[cid], feed, 50)
            keys[cid], sub = jax.random.split(keys[cid])
            draws.append(_jax_draws(sub, tiled.shape[0], 6, n_oracles, n_failing, subset))
            values, _ = jax_gen_oracle_predictions(sub, jnp.asarray(tiled), n_oracles, n_failing, subset)
            values = np.array(values, dtype=np.float64)
            blocks.append(_tamper(kind, values, n_oracles - 1) if cid == offender else values)
        jv, _, jm = jax_batch.pad_claim_cube(np.stack(blocks))
        ref, ref_ok = jax_batch.claims_consensus_sanitized(
            jnp.asarray(jv), jnp.asarray(jm), cfg, 0.0, 1.0, consensus_impl="xla")

        (result,) = step(requests)
        assert result.claims == tuple(names) and not draws
        np.testing.assert_array_equal(result.ok.numpy(), np.asarray(ref_ok))
        assert_claims_match(result.out, type(ref)(*(np.asarray(f)[:4] for f in ref)))
        assert result.ok[:-1].all() and result.ok[-1, :-1].all()
        assert bool(result.ok[-1, -1]) == (kind is None) and result.out.interval_valid.all()
        assert kind is None or not result.out.reliable[-1, -1]
        assert torch.isfinite(result.out.essence).all()


def test_step_refuses_requests_that_do_not_fit():
    spec = ClaimSpec("alpha", n_oracles=8)
    step = ClaimServingStep([spec], TINY_TEST, rows=2, seq=16, max_seg=2, params_dtype=None,
                            device="cpu")
    texts = SyntheticSource(batch=6, seed=0)()
    with pytest.raises(ValueError, match="do not fit"):
        step([Request("alpha", t) for t in texts])
    with pytest.raises(ValueError, match="dimension"):
        ClaimServingStep([ClaimSpec("beta", dimension=3)], TINY_TEST, params_dtype=None, device="cpu")
