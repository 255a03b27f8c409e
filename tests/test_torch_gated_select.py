"""A CPU model of the gated claim-cube kernel's body, held against the
port's plain version and the JAX package's kernel.

``svoc_torch/csrc/gated_claims_consensus.cu`` reads its order statistics
by the radix select of ``csrc/cairo_select.cuh``, which cannot run here.
:func:`_composite`, :func:`_select` and :func:`_row_of` repeat that
select pass by pass (as ``tests/test_torch_consensus_select.py`` does for
the one-fleet kernel), and :func:`_gated_model` repeats the kernel's
steps around it, claim by claim: the neutral fill, the counts read at
run time, +inf keys for quarantined or unreliable rows, medians that
read the KEY at a clipped rank (so a rank on a masked row reads +inf),
the cut at rank ``n_ok - n_failing`` (none below 1, every admitted row
from N up), the risk summed in column order without FMAs, the moments
with count-clamped denominators, and padding claims.

One cube covers the degenerate claims: clean, partly quarantined with a
NaN row and an inf value, all quarantined, a single survivor, fewer
admitted rows than ``n_failing`` (a negative cut), and a padding claim;
``n_failing = 0`` with every row admitted puts the cut at N.  The model
is held against ``fused_consensus_gated_claims_plain`` on tie-heavy
fleets (values quantised to 1e-2, all rows equal, ±0.0 mixed) at N ∈
{7, 1000, 1024}, and against
``svoc_tpu.ops.pallas_consensus.fused_consensus_gated_claims(...,
interpret=True)`` at N ∈ {128, 256}, at the bars of
``tests/test_pallas_consensus.py``: ``reliable`` and ``interval_valid``
exact, the floats within 1e-5 (infinite risks equal), skewness within
1e-4, kurtosis within 1e-3, each beside numpy's default relative 1e-7
as that file's ``assert_allclose`` has it (a risk near 2700, a row whose
inf value was filled with 0 in an unconstrained fleet, is 1 ulp = 2.4e-4
apart in the JAX package's XLA rounding).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.consensus.kernel import ConsensusConfig as JaxConfig
from svoc_tpu.ops.pallas_consensus import fused_consensus_gated_claims as jax_gated

from svoc_torch.consensus.batch import pad_claim_cube
from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.ops.fused_consensus import fused_consensus_gated_claims_plain

NONE = (1 << 64) - 1  # the select's answer to a rank outside [0, n)
KINDS = ("quantised", "all_equal", "signed_zeros")
FIELDS = ("essence", "essence_first_pass", "reliability_first_pass",
          "reliability_second_pass", "reliable", "quadratic_risk", "skewness",
          "kurtosis", "interval_valid")


# ---- The select, as cairo_select.cuh runs it (copied from
# tests/test_torch_consensus_select.py) ----


def _index_bits(n):
    bits = 0
    while (1 << bits) < n:
        bits += 1
    return bits


def _ord(keys):
    """float32 → uint32 in the same order, -0.0 folded into +0.0."""
    u = np.asarray(keys, np.float32).view(np.uint32).astype(np.uint64)
    u[u == 0x80000000] = 0
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _composite(keys):
    n = len(keys)
    index = (n - 1 - np.arange(n)).astype(np.uint64)
    return (_ord(keys) << np.uint64(_index_bits(n))) | index


def _row_of(answer, n):
    return n - 1 - (answer & ((1 << _index_bits(n)) - 1))


def _select(keys, rank):
    """The composite key at ``rank`` as ``select_ranks`` finds it: 8-bit
    digits from the top, closing when the rank's bin holds one key."""
    n = len(keys)
    if not 0 <= rank < n:
        return NONE
    c = _composite(keys)
    pre, low, r = 0, 32 + _index_bits(n), rank
    while True:
        top, shift = low, max(low - 8, 0)
        hit = (c >> np.uint64(top)) == np.uint64(pre)
        digits = (c[hit] >> np.uint64(shift)) & np.uint64((1 << (top - shift)) - 1)
        hist = np.bincount(digits.astype(np.int64), minlength=256)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, r, side="right"))  # the first bin whose count passes r
        pre, r, low = (pre << (top - shift)) | b, r - int(cum[b] - hist[b]), shift
        if hist[b] == 1:
            break
    (answer,) = c[(c >> np.uint64(low)) == np.uint64(pre)]
    return int(answer)


# ---- The kernel's body, claim by claim ----


def _reliability(mean_qr, dim, constrained, max_spread):
    if constrained:
        return np.float64(1.0) - 2.0 * np.sqrt(np.float64(mean_qr) / dim)
    return 1.0 - min(max_spread, np.sqrt(np.float64(mean_qr))) / max_spread


def _block_sum(part_of_row):
    """The kernel's ``block_sums`` of one float32 value per row: each
    thread adds its rows in order, a warp's 32 partials meet in a
    butterfly of shuffles, then warp 0 adds the warps' sums in order."""
    n = len(part_of_row)
    threads = min(max(-(-n // 32) * 32, 32), 1024)
    part = np.zeros(threads, np.float32)
    for start in range(0, n, threads):
        chunk = np.asarray(part_of_row[start:start + threads], np.float32)
        part[: len(chunk)] = part[: len(chunk)] + chunk
    lanes = part.reshape(-1, 32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ off]
    total = np.float32(0.0)
    for warp_sum in lanes[:, 0]:
        total = np.float32(total + warp_sum)
    return total


def _median(keys, count):
    """The mean of the KEYS at ranks clip(count//2 - 1) and clip(count//2)."""
    n = len(keys)
    lo, hi = (min(max(r, 0), n - 1) for r in (count // 2 - 1, count // 2))
    a, b = (keys[_row_of(_select(keys, r), n)] for r in (lo, hi))
    return (a + b) * np.float32(0.5)


def _claim_model(values, ok, n_failing, constrained, max_spread):
    n, dim = values.shape
    v = np.where(ok[:, None] & np.isfinite(values), values, np.float32(0.0)).astype(np.float32)
    n_ok = int(_block_sum(ok))
    inf = np.float32(np.inf)
    ess1 = np.array([_median(np.where(ok, v[:, c], inf), n_ok) for c in range(dim)], np.float32)
    qr = np.zeros(n, np.float32)
    for c in range(dim):  # column order, each product and sum rounded on its own
        d = v[:, c] - ess1[c]
        qr = qr + d * d
    cut = n_ok - n_failing
    keys = np.where(ok, qr, inf)
    below = 0 if cut <= 0 else NONE if cut >= n else _select(keys, cut)
    reliable = ok & np.array([int(k) < below for k in _composite(keys)])
    n_rel = int(_block_sum(reliable))
    nr, denom = float(n_rel), float(max(n_rel, 1))
    mean = np.array([_block_sum(np.where(reliable, v[:, c], np.float32(0.0))) for c in range(dim)])
    mean = mean / np.float32(denom)
    if constrained:
        ess2 = np.array([_median(np.where(reliable, v[:, c], inf), n_rel) for c in range(dim)])
    else:
        ess2 = mean
    centered = np.where(reliable[:, None], v - mean, 0.0)
    sd = np.maximum(np.sqrt((centered**2).sum(axis=0) / denom), 1e-30)
    z = np.where(reliable[:, None], (v - mean) / sd, 0.0)
    skew = (z**3).sum(axis=0) * nr / max((nr - 1.0) * (nr - 2.0), 1.0)
    t1 = (z**4).sum(axis=0) * nr * (nr + 1.0) / max(nr - 1.0, 1.0)
    kurt = (t1 - 3.0 * (nr - 1.0) ** 2) / max((nr - 2.0) * (nr - 3.0), 1.0)
    zero = np.float32(0.0)
    rel1 = _reliability(_block_sum(np.where(ok, qr, zero)) / np.float32(max(n_ok, 1)), dim,
                        constrained, max_spread)
    rel2 = _reliability(_block_sum(np.where(reliable, qr, zero)) / np.float32(denom), dim,
                        constrained, max_spread)
    return dict(
        essence=np.where(np.isfinite(ess2), ess2, 0.0),
        essence_first_pass=np.where(np.isfinite(ess1), ess1, 0.0),
        reliability_first_pass=rel1, reliability_second_pass=rel2,
        reliable=reliable, quadratic_risk=qr, skewness=skew, kurtosis=kurt,
        interval_valid=bool(0.0 <= rel1 <= 1.0 and 0.0 <= rel2 <= 1.0 and n_ok >= 2 and n_rel >= 2),
    )


def _gated_model(values, ok, claim_mask, n_failing, constrained, max_spread=10.0):
    """The kernel on ``values [C, N, M]``: one claim per block, padding
    claims as ``_mask_padded_claims`` leaves them."""
    c, n, dim = values.shape
    claims = []
    for i in range(c):
        if claim_mask[i]:
            claims.append(_claim_model(values[i], ok[i], n_failing, constrained, max_spread))
        else:
            claims.append(dict(
                essence=np.zeros(dim), essence_first_pass=np.zeros(dim),
                reliability_first_pass=0.0, reliability_second_pass=0.0,
                reliable=np.zeros(n, bool), quadratic_risk=np.zeros(n, np.float32),
                skewness=np.zeros(dim), kurtosis=np.zeros(dim), interval_valid=False,
            ))
    return {f: np.stack([np.asarray(claim[f]) for claim in claims]) for f in FIELDS}


def _assert_matches(got, ref):
    ref = {f: np.asarray(getattr(ref, f)) for f in FIELDS}
    np.testing.assert_array_equal(got["reliable"], ref["reliable"])
    np.testing.assert_array_equal(got["interval_valid"], ref["interval_valid"])
    inf = np.isinf(ref["quadratic_risk"])
    np.testing.assert_array_equal(np.isinf(got["quadratic_risk"]), inf)
    np.testing.assert_array_equal(got["quadratic_risk"][inf], ref["quadratic_risk"][inf])
    np.testing.assert_allclose(got["quadratic_risk"][~inf], ref["quadratic_risk"][~inf], atol=1e-5)
    for f in ("essence", "essence_first_pass", "reliability_first_pass", "reliability_second_pass"):
        np.testing.assert_allclose(got[f], ref[f], atol=1e-5, err_msg=f)
    np.testing.assert_allclose(got["skewness"], ref["skewness"], atol=1e-4)
    np.testing.assert_allclose(got["kurtosis"], ref["kurtosis"], atol=1e-3)


def _fleet(kind, n, dim, rng):
    if kind == "uniform":
        return rng.uniform(0.01, 0.99, size=(n, dim)).astype(np.float32)
    if kind == "quantised":
        return np.round(rng.uniform(0.0, 1.0, size=(n, dim)), 2).astype(np.float32)
    if kind == "all_equal":  # 3/8: every sum exact, so the moments of a constant column are too
        return np.full((n, dim), 0.375, np.float32)
    return rng.choice(np.array([-0.0, 0.0, 0.25, 0.5], np.float32), size=(n, dim))


def _cube(kind, n, n_failing, seed, dim=6):
    """Seven claims padded to eight: clean; partly quarantined with a NaN
    row and an inf value; all quarantined (n_ok = 0); a single survivor
    (n_ok = 1); fewer admitted rows than n_failing (a negative cut);
    clean twice more; then the padding claim."""
    rng = np.random.default_rng(seed)
    values = np.stack([_fleet(kind, n, dim, rng) for _ in range(7)])
    ok = np.ones((7, n), bool)
    ok[1, : max(1, n // 4)] = False
    values[1, 0] = np.nan
    values[1, n - 1, 0] = np.inf
    ok[2] = False
    ok[3, : n - 1] = False
    ok[4, max(0, n_failing - 1):] = False
    assert int(ok[4].sum()) < max(n_failing, 1)
    v, o, mask = pad_claim_cube(values, ok)
    assert tuple(mask.shape) == (8,) and not bool(mask[7])
    return v.numpy(), o.numpy(), mask.numpy()


CASES = [("n/8", True), ("n/8", False), ("none", True)]


@pytest.mark.parametrize("failing,constrained", CASES, ids=["constrained", "unconstrained", "cut_n"])
@pytest.mark.parametrize("n", [7, 1000, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_gated_model_matches_the_plain_version(kind, n, failing, constrained):
    f = max(2, n // 8) if failing == "n/8" else 0
    values, ok, mask = _cube(kind, n, max(2, n // 8), seed=n)
    if not constrained:
        values = np.where(np.isfinite(values), 20.0 + 3.0 * values, values).astype(np.float32)
    cfg = ConsensusConfig(n_failing=f, constrained=constrained)
    ref = fused_consensus_gated_claims_plain(
        torch.from_numpy(values), torch.from_numpy(ok), torch.from_numpy(mask), cfg)
    got = _gated_model(values, ok, mask, f, constrained)
    _assert_matches(got, ref)
    if f == 0:  # the cut at N: every admitted row is reliable
        assert got["reliable"][0].all() and np.array_equal(got["reliable"][:7], ok[:7])
    else:  # the negative cut passes no row
        assert not got["reliable"][4].any() and not got["interval_valid"][4]
    assert np.isinf(got["quadratic_risk"][2]).all() and not got["interval_valid"][2:4].any()


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("kind,failing,constrained", [
    ("uniform", "n/8", True), ("uniform", "n/8", False), ("quantised", "n/8", True),
    ("signed_zeros", "n/8", True), ("uniform", "none", True),
])
def test_gated_model_matches_the_jax_kernel(kind, failing, constrained, n):
    """The model against the Pallas kernel in interpret mode on the same
    numpy cube."""
    f = n // 8 if failing == "n/8" else 0
    values, ok, mask = _cube(kind, n, n // 8, seed=n + 1)
    if not constrained:
        values = np.where(np.isfinite(values), 20.0 + 3.0 * values, values).astype(np.float32)
    cfg = JaxConfig(n_failing=f, constrained=constrained)
    ref = jax_gated(jnp.asarray(values), jnp.asarray(ok), jnp.asarray(mask), cfg, interpret=True)
    _assert_matches(_gated_model(values, ok, mask, f, constrained), ref)
