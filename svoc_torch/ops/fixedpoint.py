"""Signed fixed-point ("wsad") numerics and the felt252 codec.

Mirrors :mod:`svoc_tpu.ops.fixedpoint` (``fixedpoint.py:30-344``), the
whole module, on Python ints and numpy.  The contract stores every
statistic as an ``i128`` scaled by 1e6 (``contract/src/
signed_decimal.cairo:82-116``), and chain I/O wraps negative values
around the felt252 prime in two's complement (``client/contract.py:
35-53``).  This is the golden arithmetic of the contract simulator
(:mod:`svoc_torch.consensus.wsad_engine`) and the codec of every commit.

Cairo semantics kept exactly:

- ``i128`` division truncates toward zero (``signed_decimal.cairo:52-63``);
- ``wsad_mul(a, b) = (a*b + HALF_WSAD) / WSAD`` (``:110-112``), the
  +0.5 wsad bias also for negative products, then truncated;
- ``wsad_div(a, b) = (a*WSAD + b/2) / b`` (``:114-116``);
- ``sqrt`` is Newton's iteration from ``value/2``, stopping at a fixed
  point or after 50 iterations (``math.cairo:271-292``), so
  ``wsad_sqrt(1)`` divides by zero.

:func:`quantize` takes numpy arrays and scalars, as in the reference,
and torch tensors where the reference takes JAX arrays.
"""

from __future__ import annotations

import numpy as np

WSAD: int = 1_000_000
HALF_WSAD: int = 500_000

#: Starknet field prime (felt252 modulus), used for two's-complement
#: encoding of negative wsad values (client/contract.py:35).
FELT_PRIME: int = (
    3618502788666131213697322783095070105623107215331596699973092056135872020481
)
#: Largest value decoded as positive (client/contract.py:36).
I128_MAX: int = 2**127 - 1
#: Most negative representable wsad value (Cairo ``i128`` lower bound).
I128_MIN: int = -(2**127)
#: Largest real-unit magnitude the codec represents (``I128_MAX / 1e6``,
#: the quarantine gate's codec bound, ``svoc_tpu/robustness/
#: sanitize.py:48``): beyond it ``to_wsad`` leaves the i128 window.
WSAD_LIMIT: float = float(I128_MAX) * 1e-6

MAX_SQRT_ITERATIONS: int = 50


class FeltRangeError(ValueError):
    """A felt252 outside the two's-complement i128 window.

    The wire encoding maps signed wsad ints onto ``[0, I128_MAX]``
    (non-negative) and ``[FELT_PRIME + I128_MIN, FELT_PRIME)``
    (negative).  Everything between those windows — and anything
    outside ``[0, FELT_PRIME)`` — is not the encoding of ANY i128, so
    decoding it silently (as the seed's ``felt_to_wsad`` did by
    wrapping) manufactures a value no oracle ever signed.  The decode
    boundary raises instead (docs/ROBUSTNESS.md §input integrity).
    """


def div_trunc(a: int, b: int) -> int:
    """Cairo ``I128Div``: sign-magnitude division, truncating toward zero.

    Mirrors ``signed_decimal.cairo:52-63`` (unsigned divide of absolute
    values, sign re-applied).
    """
    if b == 0:
        raise ZeroDivisionError("i128 division by zero")
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def wsad_mul(a: int, b: int) -> int:
    """Rounded fixed-point multiply (``signed_decimal.cairo:110-112``)."""
    return div_trunc(a * b + HALF_WSAD, WSAD)


def wsad_div(a: int, b: int) -> int:
    """Rounded fixed-point divide (``signed_decimal.cairo:114-116``)."""
    return div_trunc(a * WSAD + div_trunc(b, 2), b)


def _saturate(value: int, op: str) -> int:
    """Clamp an exact result into the i128 window, counting overflows.

    The host engine computes in unbounded Python ints, so — unlike the
    Cairo i128 — an overflow here would neither panic nor wrap; it
    would silently leave the representable range and only blow up at
    the felt encode boundary.  The ``*_sat`` variants make the i128
    contract explicit: saturate at ``I128_MIN``/``I128_MAX`` (sign
    preserved — saturation can NEVER wrap a positive overflow to a
    negative value the way two's-complement wrapping would) and count
    the event into ``wsad_overflows{op=}`` (docs/OBSERVABILITY.md).
    """
    if I128_MIN <= value <= I128_MAX:
        return value
    from svoc_torch.utils.metrics import registry as _metrics

    _metrics.counter("wsad_overflows", labels={"op": op}).add(1)
    return I128_MAX if value > 0 else I128_MIN


def wsad_add_sat(a: int, b: int) -> int:
    """i128-checked add: exact sum, saturated into the i128 window."""
    return _saturate(a + b, "add")


def wsad_mul_sat(a: int, b: int) -> int:
    """:func:`wsad_mul` with the product saturated into the i128 window
    (same +HALF_WSAD rounding bias, then clamp instead of silent
    out-of-range growth)."""
    return _saturate(wsad_mul(a, b), "mul")


def wsad_sqrt(value: int) -> int:
    """Newton square root in wsad, 50-iteration cap (``math.cairo:271-292``)."""
    if value == 0:
        return 0
    g = div_trunc(value, 2)
    g2 = g + WSAD
    i = 0
    while g != g2 and i < MAX_SQRT_ITERATIONS:
        n = wsad_div(value, g)
        g2 = g
        g = div_trunc(g + n, 2)
        i += 1
    return g


def to_wsad(x: float) -> int:
    """Float → wsad, truncating like the reference's ``int(x*1e6)``.

    Matches both the client encoder (``client/contract.py:48-49``) and
    the notebook fixture generator ``to_wsad`` that produced the Cairo
    test vectors.
    """
    return int(x * 1e6)  # svoclint: disable=SVOC005


def from_wsad(x: int) -> float:
    """wsad → float (``client/contract.py:41-45`` scale factor)."""
    return float(x) * 1e-6


def float_to_fwsad(x: float) -> int:
    """Float → felt252-encoded wsad (``client/contract.py:48-53``)."""
    as_wsad = to_wsad(x)
    return as_wsad + FELT_PRIME if as_wsad < 0 else as_wsad


def fwsad_to_float(x: int) -> float:
    """felt252-encoded wsad → float (``client/contract.py:41-45``).

    Validated decode: out-of-window calldata raises
    :class:`FeltRangeError` instead of wrapping (see
    :func:`felt_to_wsad`) — an RPC answering garbage must fail the
    read, not poison downstream statistics with a fabricated value."""
    return float(felt_to_wsad(int(x))) * 1e-6


def wsad_to_string(value: int, n_digits: int = 3) -> str:
    """Decimal rendering of a wsad int (``contract/src/utils.cairo:
    283-297`` ``wsad_to_string``): sign, integer part, then the first
    ``n_digits`` decimal digits TRUNCATED (not rounded), zero-padded on
    the left exactly like the Cairo ``lfill``."""
    if n_digits < 0 or n_digits > 6:
        raise ValueError(f"n_digits must be in [0, 6], got {n_digits}")
    u = abs(value)
    sign = "-" if value < 0 else ""
    integer_part = u // WSAD
    decimal_reduced = (u % WSAD) // (10 ** (6 - n_digits))
    if n_digits == 0:
        return f"{sign}{integer_part}."
    return f"{sign}{integer_part}.{str(decimal_reduced).zfill(n_digits)}"


def felt_wsad_to_string(value: int, n_digits: int = 3) -> str:
    """``utils.cairo:279-281`` — felt252 calldata → decimal string."""
    return wsad_to_string(felt_to_wsad(value), n_digits)


def wsad_to_felt(x: int) -> int:
    """Signed wsad int → felt252 (``signed_decimal.cairo:26-28`` via felt cast)."""
    return x % FELT_PRIME


def felt_to_wsad(x: int) -> int:
    """felt252 → signed wsad int (two's complement around the prime).

    Raises :class:`FeltRangeError` for calldata outside the i128
    encoding windows: the seed accepted any integer here and wrapped,
    so a felt ≥ ``FELT_PRIME`` (or one from the dead zone between the
    positive and negative windows) decoded to a value that was never
    an i128 on chain — exactly the malformed input the quarantine gate
    exists to refuse (docs/ROBUSTNESS.md)."""
    if not 0 <= x < FELT_PRIME:
        raise FeltRangeError(f"felt {x} outside [0, FELT_PRIME)")
    if x <= I128_MAX:
        return x
    decoded = x - FELT_PRIME
    if decoded < I128_MIN:
        raise FeltRangeError(
            f"felt {x} decodes below i128 range (no oracle can sign it)"
        )
    return decoded


# ---------------------------------------------------------------------------
# Array helpers (host-side, vectorized over numpy object/int64 arrays).
# ---------------------------------------------------------------------------


def encode_vector(xs) -> list[int]:
    """Float vector → list of felt252-encoded wsad ints (chain calldata)."""
    return [float_to_fwsad(float(x)) for x in np.asarray(xs).ravel()]


#: Largest |x·1e6| the vectorized int64 truncation lane may handle —
#: beyond it the cast would wrap, so those rows take the exact
#: arbitrary-precision per-element lane instead.
_INT64_SAFE: float = float(2**62)


def _wsad_fast_rows(scaled: np.ndarray) -> np.ndarray:
    """Rows of a pre-scaled (×1e6) float64 block that the int64
    truncation lane encodes exactly: finite and within the safe cast
    window.  ``np.trunc`` on the identical float64 product is
    bit-identical to Python's ``int(x * 1e6)`` (both truncate toward
    zero), so the two lanes can never disagree — the lane split is
    purely about int64 range and error semantics."""
    with np.errstate(invalid="ignore", over="ignore"):
        return np.all(
            np.isfinite(scaled) & (np.abs(scaled) < _INT64_SAFE), axis=1
        )


def to_wsad_rows(matrix) -> list[list[int]]:
    """Vectorized :func:`to_wsad` over a ``[N, M]`` float block — the
    commit path's per-element ``int(x * 1e6)`` loop collapsed into one
    numpy truncation (bit-identical results; non-finite or huge rows
    fall back to the exact per-element lane, *including* its
    exceptions, so error semantics don't change with the speedup)."""
    arr = np.atleast_2d(np.asarray(matrix, dtype=np.float64))
    scaled = arr * 1e6
    fast = _wsad_fast_rows(scaled)
    if bool(np.all(fast)):
        return np.trunc(scaled).astype(np.int64).tolist()
    out: list = [None] * arr.shape[0]
    idx = np.flatnonzero(fast)
    if idx.size:
        lists = np.trunc(scaled[idx]).astype(np.int64).tolist()
        for j, i in enumerate(idx):
            out[i] = lists[j]
    for i in np.flatnonzero(~fast):
        out[i] = [to_wsad(float(x)) for x in arr[i]]
    return out


def encode_matrix(matrix, on_error: str | None = None) -> list:
    """Vectorized :func:`encode_vector` over a ``[N, M]`` float block:
    one numpy truncation for every encodable row, the exact
    per-element codec for the rest.

    ``on_error=None`` (default) mirrors a ``[encode_vector(row) for
    row]`` loop exactly — a malformed row raises the same exception at
    the same row.  ``on_error="none"`` is the WAL cycle-open contract
    (the reference's ``Session._open_wal_cycle``): a row with
    no signable payload becomes ``None`` instead of raising.
    """
    arr = np.asarray(matrix, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError(f"encode_matrix needs [N, M], got {arr.shape}")
    scaled = arr * 1e6
    fast = _wsad_fast_rows(scaled)
    out: list = [None] * arr.shape[0]
    idx = np.flatnonzero(fast)
    if idx.size:
        wsad = np.trunc(scaled[idx]).astype(np.int64)
        lists = wsad.tolist()
        if wsad.size and int(wsad.min()) < 0:
            # Negative wsad wraps around the felt prime (252-bit Python
            # ints — only the rare negative rows pay the per-element
            # wrap; constrained fleets never do).
            lists = [
                [x if x >= 0 else x + FELT_PRIME for x in row]
                for row in lists
            ]
        for j, i in enumerate(idx):
            out[i] = lists[j]
    for i in np.flatnonzero(~fast):
        if on_error == "none":
            try:
                out[i] = encode_vector(arr[i])
            except Exception:  # svoclint: disable=SVOC014 -- deliberate: on_error="none" is the per-element error CHANNEL — the None sentinel is this lane's documented output and callers (the WAL cycle-open) keep exact per-slot failure semantics
                out[i] = None
        else:
            out[i] = encode_vector(arr[i])
    return out


def decode_vector(felts) -> np.ndarray:
    """felt252 calldata → float vector."""
    return np.array([fwsad_to_float(int(f)) for f in felts], dtype=np.float64)


def quantize(x, scale: float = 1e6):
    """Quantize a float array onto the wsad grid, truncating toward zero:
    ``trunc(x * 1e6) / 1e6``, on numpy arrays and scalars or on a torch
    tensor (on its device)."""
    if isinstance(x, np.ndarray) or np.isscalar(x):
        return np.trunc(np.asarray(x) * scale) / scale
    import torch

    return torch.trunc(x * scale) / scale


def to_cairo_fixture(vectors) -> str:
    """Float prediction vectors → Cairo test-fixture source text.

    The reference generates its contract-test vectors by printing
    ``array![...].span(),`` lines of wsad ints from the notebooks
    (provenance comments at ``test_contract.cairo:148-149``; the
    ``to_wsad`` cells of ``beta_kumaraswamy_algorithm_demo copy.ipynb``)
    — this is that generator as a library function, so new Cairo
    fixtures can be produced from any fleet this framework simulates::

        print(to_cairo_fixture(np.asarray(out_values)))

    Negative components render as prime-wrapped felts the way the chain
    encoding sends them (``encode_vector``).
    """
    arr = np.asarray(vectors, dtype=np.float64)
    if arr.size == 0:
        return ""
    rows = []
    for vec in np.atleast_2d(arr):
        felts = ", ".join(str(f) for f in encode_vector(vec))
        rows.append(f"array![{felts}].span(),")
    return "\n".join(rows)
