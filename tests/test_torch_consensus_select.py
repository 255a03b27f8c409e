"""A CPU model of the fused-consensus kernel's rank selection, held
against the port's Cairo order and the JAX package's kernel.

``svoc_torch/csrc/fused_consensus.cu`` reads its order statistics by a
radix select (``csrc/cairo_select.cuh``) that cannot run here.
:func:`_composite` and :func:`_select` repeat it pass by pass: one
composite key per element (the float's order-preserving bits, -0.0
folded into +0.0, over the inverted index), 8-bit digits from the top,
a query closing as soon as its bin holds one key.  :func:`_kernel_model`
repeats the kernel's steps around it (first-pass medians, the risk
summed in column order without FMAs, the cut at rank m, the second
pass).  They are held against ``svoc_torch.ops.sort`` on tie-heavy
fleets (values quantised to 1e-2, all rows equal, ±0.0 mixed) at N ∈
{7, 1000, 1024}, and the whole model against
``svoc_tpu.ops.pallas_consensus.fused_consensus(interpret=True)`` at N ∈
{128, 256}, at the bars of ``tests/test_pallas_consensus.py``.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.consensus.kernel import ConsensusConfig as JaxConfig
from svoc_tpu.ops.pallas_consensus import fused_consensus as jax_fused

from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.ops.fused_consensus import fused_consensus_plain
from svoc_torch.ops.sort import argsort_cairo, cairo_rank

NONE = (1 << 64) - 1  # the kernel's answer to a rank outside [0, n)
KINDS = ("quantised", "all_equal", "signed_zeros")


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
    """``(composite key at rank, passes)`` as ``select_ranks`` finds it."""
    n = len(keys)
    if not 0 <= rank < n:
        return NONE, 0
    c = _composite(keys)
    pre, low, r, passes = 0, 32 + _index_bits(n), rank, 0
    while True:
        top, shift = low, max(low - 8, 0)
        hit = (c >> np.uint64(top)) == np.uint64(pre)
        digits = (c[hit] >> np.uint64(shift)) & np.uint64((1 << (top - shift)) - 1)
        hist = np.bincount(digits.astype(np.int64), minlength=256)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, r, side="right"))  # the first bin whose count passes r
        pre, r, low, passes = (pre << (top - shift)) | b, r - int(cum[b] - hist[b]), shift, passes + 1
        if hist[b] == 1:
            break
    (answer,) = c[(c >> np.uint64(low)) == np.uint64(pre)]
    return int(answer), passes


def _fleet(kind, n, dim=6, seed=0):
    rng = np.random.default_rng(seed + n)
    if kind == "quantised":
        return np.round(rng.uniform(0.0, 1.0, size=(n, dim)), 2).astype(np.float32)
    if kind == "all_equal":  # 3/8: every sum exact, so the moments of a constant column are too
        return np.full((n, dim), 0.375, np.float32)
    return rng.choice(np.array([-0.0, 0.0, 0.25, 0.5], np.float32), size=(n, dim))


def _reliability(mean_qr, dim, constrained, max_spread):
    if constrained:
        return 1.0 - 2.0 * math.sqrt(mean_qr / dim)
    return 1.0 - min(max_spread, math.sqrt(mean_qr)) / max_spread


def _kernel_model(values, n_failing, constrained, max_spread=10.0):
    """The kernel's steps on ``values [N, M]`` float32, its selects by
    :func:`_select`; the moments in float64."""
    v = np.asarray(values, np.float32)
    n, dim = v.shape
    m = n - n_failing

    def median(col, keys, count):
        a, b = (_select(keys, r)[0] for r in (count // 2 - 1, count // 2))
        read = [np.float32(0.0) if x == NONE else col[_row_of(x, n)] for x in (a, b)]
        return (read[0] + read[1]) * np.float32(0.5)

    ess1 = np.array([median(v[:, c], v[:, c], n) for c in range(dim)], np.float32)
    qr = np.zeros(n, np.float32)
    for c in range(dim):  # column order, each product and sum rounded on its own
        d = v[:, c] - ess1[c]
        qr = qr + d * d
    cut = 0 if m <= 0 else NONE if m >= n else _select(qr, m)[0]
    reliable = np.array([int(x) < cut for x in _composite(qr)])
    w = reliable.astype(np.float64)[:, None]
    mean = (v * w).sum(axis=0) / m
    if constrained:
        ess2 = np.array([median(v[:, c], np.where(reliable, v[:, c], np.inf), m) for c in range(dim)])
    else:
        ess2 = mean
    centered = (v - mean) * w
    z = centered / np.maximum(np.sqrt((centered**2).sum(axis=0) / m), 1e-30)
    skew = (z**3).sum(axis=0) * m / ((m - 1.0) * (m - 2.0))
    t1 = (z**4).sum(axis=0) * m * (m + 1.0) / (m - 1.0)
    kurt = (t1 - 3.0 * (m - 1.0) ** 2) / ((m - 2.0) * (m - 3.0))
    return dict(
        essence=ess2, essence_first_pass=ess1, quadratic_risk=qr, reliable=reliable,
        reliability_first_pass=_reliability(float(qr.sum(dtype=np.float64)) / n, dim, constrained, max_spread),
        reliability_second_pass=_reliability(
            float(qr[reliable].sum(dtype=np.float64)) / m, dim, constrained, max_spread),
        skewness=skew, kurtosis=kurt,
    )


def _assert_model_matches(got, ref):
    np.testing.assert_array_equal(got["reliable"], np.asarray(ref.reliable))
    for field in ("essence", "essence_first_pass", "quadratic_risk",
                  "reliability_first_pass", "reliability_second_pass"):
        np.testing.assert_allclose(got[field], np.asarray(getattr(ref, field)), atol=1e-5, err_msg=field)
    np.testing.assert_allclose(got["skewness"], np.asarray(ref.skewness), atol=1e-4)
    np.testing.assert_allclose(got["kurtosis"], np.asarray(ref.kurtosis), atol=1e-3)


@pytest.mark.parametrize("n", [7, 1000, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_select_reads_the_row_of_the_cairo_order(kind, n):
    """Every column, keyed as it is or with a quarter of its rows masked
    to +inf: the row the select finds at each rank is the row
    ``argsort_cairo`` puts there; ranks outside [0, n) answer NONE; no
    select takes more passes than its key has digits."""
    v = _fleet(kind, n)
    rng = np.random.default_rng(n)
    masked = rng.uniform(size=n) < 0.25
    ranks = {0, n - 1, n // 2 - 1, n // 2, *rng.integers(0, n, size=12).tolist()}
    max_passes = math.ceil((32 + _index_bits(n)) / 8)
    for c in range(v.shape[1]):
        for keys in (v[:, c], np.where(masked, np.float32(np.inf), v[:, c])):
            order = argsort_cairo(torch.from_numpy(keys)).numpy()
            for r in sorted(ranks):
                answer, passes = _select(keys, r)
                assert _row_of(answer, n) == order[r] and 1 <= passes <= max_passes, (c, r)
            assert _select(keys, -1)[0] == NONE and _select(keys, n)[0] == NONE


@pytest.mark.parametrize("n", [7, 1000, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_risk_cut_is_the_cairo_rank_mask(kind, n):
    """The reliable rows are the composite keys below the one at rank m:
    ``cairo_rank(risk) < m`` for m inside (0, n); rank n answers NONE,
    above every key (m >= n passes all)."""
    v = _fleet(kind, n)
    e = np.median(v, axis=0).astype(np.float32)
    risk = (((v - e) ** 2).sum(axis=1)).astype(np.float32)
    rank = cairo_rank(torch.from_numpy(risk)).numpy()
    keys = _composite(risk)
    for m in sorted({1, n // 2, n - n // 8, n - 1}):
        cut = _select(risk, m)[0]
        np.testing.assert_array_equal(keys < np.uint64(cut), rank < m)
    assert _select(risk, n)[0] == NONE and not (keys >= np.uint64(NONE)).any()


@pytest.mark.parametrize("n,f", [(7, 2), (1000, 125), (1024, 128)])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_model_matches_the_plain_version(kind, n, f):
    values = _fleet(kind, n, seed=1)
    ref = fused_consensus_plain(torch.from_numpy(values), ConsensusConfig(n_failing=f))
    _assert_model_matches(_kernel_model(values, f, True), ref)


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("kind,constrained", [("uniform", True), ("uniform", False),
                                              ("quantised", True), ("signed_zeros", True)])
def test_kernel_model_matches_the_jax_kernel(kind, constrained, n):
    """The model against the Pallas kernel in interpret mode on the same
    numpy fleet, n_failing = N / 8."""
    if kind == "uniform":
        rng = np.random.default_rng(n)
        values = rng.uniform(0.01, 0.99, size=(n, 6)).astype(np.float32)
        if not constrained:
            values = (20.0 + 3.0 * rng.standard_normal((n, 6))).astype(np.float32)
    else:
        values = _fleet(kind, n, seed=2)
    f = n // 8
    ref = jax_fused(jnp.asarray(values), JaxConfig(n_failing=f, constrained=constrained), interpret=True)
    _assert_model_matches(_kernel_model(values, f, constrained), ref)
