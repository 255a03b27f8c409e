"""The port's wsad/felt codec, rounding, Cairo sort and golden engine
against the JAX package's, exactly, on the CPU.

Every function runs in both packages on the same seeded inputs and must
give the same Python ints (or floats, bit for bit), or raise the same
exception type with the same message: the codec at its edges (±0, the
i128 and felt windows, NaN and out-of-range under each ``on_error``),
``to_wsad_rows`` against its per-element loop, ``round6``,
``indexed_sort_host`` with ties, ``wsad_sqrt`` with its panic on 1, and
``two_pass_consensus`` on seeded fleets.
"""

import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp

from svoc_tpu.consensus import wsad_engine as ref_engine
from svoc_tpu.ops import fixedpoint as ref_fp
from svoc_tpu.ops.sort import indexed_sort_host as ref_indexed_sort
from svoc_tpu.utils import rounding as ref_rounding
from svoc_tpu.utils.metrics import registry as ref_registry

from svoc_torch.consensus import wsad_engine as engine
from svoc_torch.ops import fixedpoint as fp
from svoc_torch.ops.sort import indexed_sort_host
from svoc_torch.utils import rounding
from svoc_torch.utils.metrics import registry

I128_MAX, I128_MIN, PRIME = fp.I128_MAX, fp.I128_MIN, fp.FELT_PRIME

#: Floats at the codec's edges: signed zeros, one wsad unit and below it,
#: the i128 window in real units and just past it, huge and non-finite.
EDGE_FLOATS = [
    0.0, -0.0, 1e-6, -1e-6, 9.99e-7, -9.99e-7, 0.5, -0.5, 1.0, -1.0, 0.0000005,
    float(I128_MAX) * 1e-6, -float(I128_MAX) * 1e-6, 1.7e32, -1.7e32, 1e300, -1e300,
    float("nan"), float("inf"), float("-inf"),
]
#: Felts at the window edges: in the positive window, the dead zone
#: between the windows, in the negative window, and outside the field.
EDGE_FELTS = [
    0, 1, I128_MAX, I128_MAX + 1, PRIME + I128_MIN - 1, PRIME + I128_MIN, PRIME - 1,
    PRIME, PRIME + 1, -1,
]


def outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("raise", type name, message)``."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # the exception is what is compared
        return ("raise", type(e).__name__, str(e))


def same(result_ref, result_port):
    """Outcomes equal, floats compared bit for bit (NaN equal to NaN)."""
    if result_ref[0] != result_port[0]:
        return False
    if result_ref[0] == "raise":
        return result_ref == result_port
    a, b = result_ref[1], result_port[1]
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or (
            a == b and math.copysign(1, a) == math.copysign(1, b))
    return type(a) is type(b) and a == b


def seeded_floats(seed, n=200):
    rng = np.random.default_rng(seed)
    return [float(x) for x in np.concatenate([
        rng.uniform(-1, 1, n // 2), rng.normal(0, 1e3, n // 4),
        rng.uniform(0, 1, n // 4).round(6),
    ])]


@pytest.mark.parametrize("name", ["to_wsad", "from_wsad", "float_to_fwsad"])
def test_float_codec_equals_reference(name):
    for x in EDGE_FLOATS + seeded_floats(1):
        arg = x if name != "from_wsad" else int(x * 1e6) if math.isfinite(x) else 0
        assert same(outcome(getattr(ref_fp, name), arg), outcome(getattr(fp, name), arg)), (name, x)


@pytest.mark.parametrize("name", ["felt_to_wsad", "fwsad_to_float", "felt_wsad_to_string"])
def test_felt_decode_equals_reference_at_the_window_edges(name):
    rng = np.random.default_rng(2)
    felts = EDGE_FELTS + [int(v) % PRIME for v in rng.integers(-10**9, 10**9, 50)]
    for felt in felts:
        assert same(outcome(getattr(ref_fp, name), felt), outcome(getattr(fp, name), felt)), (name, felt)
    with pytest.raises(fp.FeltRangeError):
        fp.felt_to_wsad(I128_MAX + 1)  # the dead zone between the windows
    assert issubclass(fp.FeltRangeError, ValueError)


def test_felt_encode_is_twos_complement():
    ints = [0, 1, -1, I128_MAX, I128_MIN, 123456, -123456]
    for x in ints:
        assert fp.wsad_to_felt(x) == ref_fp.wsad_to_felt(x)
        assert fp.felt_to_wsad(fp.wsad_to_felt(x)) == x
    assert fp.float_to_fwsad(-1e-6) == PRIME - 1 == ref_fp.float_to_fwsad(-1e-6)


@pytest.mark.parametrize("n_digits", [0, 3, 6, 7, -1])
def test_wsad_to_string_equals_reference(n_digits):
    for x in [0, 7000, -7000, 1_000_000, -1, 123_456_789, I128_MAX, I128_MIN]:
        assert same(outcome(ref_fp.wsad_to_string, x, n_digits), outcome(fp.wsad_to_string, x, n_digits))


@pytest.mark.parametrize("name", ["div_trunc", "wsad_mul", "wsad_div"])
def test_integer_arithmetic_equals_reference(name):
    rng = np.random.default_rng(3)
    pairs = [(int(a), int(b)) for a, b in rng.integers(-10**12, 10**12, (200, 2))]
    pairs += [(7, -2), (-7, 2), (-7, -2), (0, 5), (5, 0), (1, 2), (-1, 2), (I128_MAX, 3)]
    for a, b in pairs:
        assert same(outcome(getattr(ref_fp, name), a, b), outcome(getattr(fp, name), a, b)), (name, a, b)


def test_wsad_sqrt_equals_reference_and_panics_on_one():
    rng = np.random.default_rng(4)
    values = [0, 2, 3, 4, 1_000_000, 250_000, 999_999, 10**20] + [int(v) for v in rng.integers(2, 10**9, 100)]
    for v in values:
        assert same(outcome(ref_fp.wsad_sqrt, v), outcome(fp.wsad_sqrt, v)), v
    # Newton from 1 // 2 = 0 divides by zero, as in math.cairo:277-285.
    assert same(outcome(ref_fp.wsad_sqrt, 1), outcome(fp.wsad_sqrt, 1))
    with pytest.raises(ZeroDivisionError):
        fp.wsad_sqrt(1)


@pytest.mark.parametrize("name,op", [("wsad_add_sat", "add"), ("wsad_mul_sat", "mul")])
def test_saturating_ops_equal_reference_and_count(name, op):
    cases = [(I128_MAX, 1), (I128_MIN, -1), (10**6, 10**6), (I128_MAX, I128_MAX), (-I128_MAX, I128_MAX)]
    before = registry.counter("wsad_overflows", labels={"op": op}).count
    ref_before = ref_registry.counter("wsad_overflows", labels={"op": op}).count
    for a, b in cases:
        assert getattr(fp, name)(a, b) == getattr(ref_fp, name)(a, b)
    ref_delta = ref_registry.counter("wsad_overflows", labels={"op": op}).count - ref_before
    assert registry.counter("wsad_overflows", labels={"op": op}).count - before == ref_delta > 0


def test_encode_and_decode_vector_equal_reference():
    rng = np.random.default_rng(5)
    for row in [rng.uniform(-2, 2, 6), np.array(EDGE_FLOATS[:11]), np.array([0.0, -0.0])]:
        assert same(outcome(ref_fp.encode_vector, row), outcome(fp.encode_vector, row))
        felts = fp.encode_vector(row)
        assert same(outcome(ref_fp.decode_vector, felts), outcome(fp.decode_vector, felts))
    for bad in ([float("nan"), 0.5], [float("inf")], [1e40]):
        assert same(outcome(ref_fp.encode_vector, bad), outcome(fp.encode_vector, bad))


def _matrices():
    rng = np.random.default_rng(6)
    clean = rng.uniform(0, 1, (64, 6))
    signed = rng.uniform(-1, 1, (32, 6))
    mixed = rng.uniform(-1, 1, (16, 6))
    mixed[3, 2] = np.nan
    mixed[7, 0] = np.inf
    mixed[9, 5] = 1e40  # past the i128 window: encoded all the same, wrapped by the prime
    mixed[11, 1] = 1e25  # past the int64 lane, still an i128
    return {"clean": clean, "signed": signed, "mixed": mixed, "one_row": clean[:1]}


@pytest.mark.parametrize("kind", ["clean", "signed", "mixed", "one_row"])
def test_to_wsad_rows_equals_the_per_element_loop(kind):
    matrix = _matrices()[kind]
    got = outcome(fp.to_wsad_rows, matrix)
    assert same(outcome(ref_fp.to_wsad_rows, matrix), got)
    loop = outcome(lambda m: [[fp.to_wsad(float(x)) for x in row] for row in m], matrix)
    assert same(loop, got)


@pytest.mark.parametrize("kind", ["clean", "signed", "mixed", "one_row"])
@pytest.mark.parametrize("on_error", [None, "none"])
def test_encode_matrix_equals_reference(kind, on_error):
    matrix = _matrices()[kind]
    got = outcome(fp.encode_matrix, matrix, on_error=on_error)
    assert same(outcome(ref_fp.encode_matrix, matrix, on_error=on_error), got)
    if on_error == "none" and kind == "mixed":
        rows = got[1]
        assert rows[3] is None and rows[7] is None
        assert rows[9][5] == int(1e40 * 1e6) and rows[11][1] == int(1e25 * 1e6)
    if on_error is None:
        loop = outcome(lambda m: [fp.encode_vector(row) for row in m], matrix)
        assert same(loop, got)
    with pytest.raises(ValueError):
        fp.encode_matrix(matrix[0])


def test_quantize_equals_reference():
    x = np.random.default_rng(7).uniform(-2, 2, (5, 6))
    assert same(("ok", ref_fp.quantize(x)), ("ok", fp.quantize(x)))
    assert ref_fp.quantize(0.1234567) == fp.quantize(0.1234567)
    got = fp.quantize(torch.from_numpy(x.astype(np.float32)))
    want = np.asarray(ref_fp.quantize(jnp.asarray(x.astype(np.float32))))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_cairo_fixture_text_equals_reference():
    vecs = np.random.default_rng(8).uniform(-1, 1, (3, 6))
    assert fp.to_cairo_fixture(vecs) == ref_fp.to_cairo_fixture(vecs)
    assert fp.to_cairo_fixture(vecs[0]) == ref_fp.to_cairo_fixture(vecs[0])
    assert fp.to_cairo_fixture(np.zeros((0, 6))) == "" == ref_fp.to_cairo_fixture(np.zeros((0, 6)))


def test_codec_constants_equal_reference_and_the_gate_uses_them():
    from svoc_torch.robustness import sanitize

    for name in ("WSAD", "HALF_WSAD", "FELT_PRIME", "I128_MAX", "I128_MIN", "MAX_SQRT_ITERATIONS"):
        assert getattr(fp, name) == getattr(ref_fp, name), name
    assert sanitize.I128_MAX is fp.I128_MAX and sanitize.WSAD_LIMIT == fp.WSAD_LIMIT
    assert fp.WSAD_LIMIT == float(ref_fp.I128_MAX) * 1e-6


def _round_inputs(seed):
    rng = np.random.default_rng(seed)
    halves = (np.arange(-2000, 2000) + 0.5) * 1e-6  # every value at a half-boundary
    return np.concatenate([
        rng.uniform(-1, 1, 2000), rng.normal(0, 1e4, 500), halves,
        [0.0000005, -0.0000005, 0.0, -0.0, 2.0**52 / 1e6, 1e17, -1e17,
         float("nan"), float("inf"), float("-inf")],
    ])


@pytest.mark.parametrize("shape", [(-1,), (10, -1), ()])
def test_round6_equals_reference_and_python_round(shape):
    x = _round_inputs(9)
    if shape == ():
        x = x[4510]  # a half-boundary scalar
    else:
        x = x[: (x.size // 10) * 10].reshape(shape)
    got = rounding.round6(x)
    assert same(("ok", ref_rounding.round6(x)), ("ok", got))
    loop = np.vectorize(lambda v: round(float(v), 6), otypes=[np.float64])(x)
    assert same(("ok", np.asarray(loop, dtype=np.float64)), ("ok", got))
    assert rounding.round6_list(x) == ref_rounding.round6_list(x) or np.isnan(x).any()


def test_round6_scalar_and_list_equal_reference():
    for v in _round_inputs(10)[:300]:
        assert same(("ok", ref_rounding.round6_scalar(v)), ("ok", rounding.round6_scalar(v)))
    row = [0.1234565, 0.0000005, 1.0, -0.25]
    assert rounding.round6_list(row) == ref_rounding.round6_list(row)
    assert rounding.round6_list([row, row]) == ref_rounding.round6_list([row, row])


@pytest.mark.parametrize("n,span", [(1, 5), (2, 1), (7, 3), (16, 2), (33, 4), (100, 1000)])
def test_indexed_sort_host_equals_reference_with_ties(n, span):
    rng = np.random.default_rng(n)
    for _ in range(20):
        values = [int(v) for v in rng.integers(0, span, n)]
        assert indexed_sort_host(values) == ref_indexed_sort(values)
    assert [i for i, _ in indexed_sort_host([5] * n)] == list(range(n - 1, -1, -1))
    assert indexed_sort_host([]) == []


def _fleet(n, constrained, seed, quantised=False):
    rng = np.random.default_rng(seed)
    if constrained:
        x = rng.uniform(0.05, 0.95, (n, 6))
    else:
        x = rng.normal([20, 12, 0, -3, 5, 1], [3, 2, 1, 1, 4, 0.5], (n, 6))
    if quantised:
        x = np.round(x, 2)  # ties in the risks
    return [[fp.to_wsad(float(v)) for v in row] for row in x]


@pytest.mark.parametrize("n", [7, 13, 64, 128])
@pytest.mark.parametrize("constrained", [True, False])
@pytest.mark.parametrize("failing", ["none", "two", "quarter"])
def test_two_pass_consensus_equals_reference(n, constrained, failing):
    n_failing = {"none": 0, "two": 2, "quarter": n // 4}[failing]
    for seed, quantised in ((n, False), (n + 1, True)):
        values = _fleet(n, constrained, seed, quantised)
        kw = dict(constrained=constrained, n_failing=n_failing,
                  max_spread=0 if constrained else 10_000_000)
        ref = outcome(ref_engine.two_pass_consensus, values, **kw)
        got = outcome(engine.two_pass_consensus, values, **kw)
        assert same(ref, got), (ref[:1], got[:1])


#: A spread fleet whose first-pass reliability is negative.
INTERVAL_PANIC = [[0, 0, 0]] * 2 + [[1_000_000] * 3] * 2 + [
    [0, 1_000_000, 0], [1_000_000, 0, 1_000_000], [500_000, 0, 1_000_000]]


@pytest.mark.parametrize("case", ["zero_variance", "interval", "max_spread_zero", "tiny_subset",
                                  "lenient_interval"])
def test_two_pass_consensus_raises_as_reference(case):
    n = 7
    values = _fleet(n, True, 11)
    kw = dict(constrained=True, n_failing=2)
    if case == "zero_variance":
        values = [[500_000 + i, 500_000, 500_000] for i in range(n)]
    elif case == "interval":  # rel₁ = 1 - 2·sqrt(mean risk / M) < 0
        values = INTERVAL_PANIC
    elif case == "max_spread_zero":
        kw = dict(constrained=False, n_failing=2, max_spread=0)
    elif case == "tiny_subset":
        kw = dict(constrained=True, n_failing=4)  # 3 reliable: (n-2)(n-3) = 0
    elif case == "lenient_interval":
        values = INTERVAL_PANIC
        kw = dict(constrained=True, n_failing=2, strict_interval=False)
    ref = outcome(ref_engine.two_pass_consensus, values, **kw)
    got = outcome(engine.two_pass_consensus, values, **kw)
    assert same(ref, got)
    assert (got[0] == "ok") == (case == "lenient_interval")


def test_engine_helpers_equal_reference():
    values = _fleet(13, True, 12)
    col = [v[0] for v in values]
    for name, args in [("smooth_median", (col,)), ("median", (col,)), ("average", (col,)),
                       ("nd_smooth_median", (values,)), ("nd_median", (values,)),
                       ("nd_average", (values,))]:
        assert same(outcome(getattr(ref_engine, name), *args), outcome(getattr(engine, name), *args)), name
    for v in (-1, 0, 1_000_000, 1_000_001):
        assert same(outcome(ref_engine.interval_check, v), outcome(engine.interval_check, v))
