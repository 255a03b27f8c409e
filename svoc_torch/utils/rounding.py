"""Vectorized 6-decimal rounding, bit for bit Python's ``round(x, 6)``.

Mirrors :mod:`svoc_tpu.utils.rounding` (``rounding.py:58-90``:
``round6``, ``round6_scalar``, ``round6_list``), numpy only.  Journaled
floats go through ``round(float(x), 6)`` and seeded replay fingerprints
digest them byte for byte, so the rounding must be exact.  ``np.round``
scales by 1e6 first and can land on the other side of a half-boundary
(``0.0000005``), so this is two lanes:

- the bulk lane is ``np.round`` (one vectorized pass);
- every element whose scaled fraction lies within ``_HALF_WINDOW`` of a
  half-boundary, or whose magnitude leaves float64's integer-exact range
  once scaled, is rounded again through Python's ``round``.

Non-finite values pass through both lanes unchanged.
"""

from __future__ import annotations

from typing import List

import numpy as np

#: Half-boundary proximity (in scaled units, i.e. multiples of 1e-6)
#: below which the exact Python rounding adjudicates.  Must stay far
#: above the ~1e-10 worst-case scaling error and far below 0.5.
_HALF_WINDOW = 1e-6

#: Magnitude above which the scaled product ``x * 1e6`` leaves the
#: float64 integer-exact range (2^53) and ``np.round``'s divide-back
#: DOUBLE-ROUNDS — and the half-boundary distance computed below
#: degenerates, so the fixup lane cannot flag the divergence.  Every
#: such value routes straight to Python's exact rounding instead
#: (2^52/1e6, a 2× guard under the true 2^53/1e6 edge).  Journaled
#: essences are tiny in practice, but the unconstrained codec-only gate
#: admits values up to the i128 window — the parity contract must hold
#: there too.
_BIG = float(2**52) / 1e6


def round6(values) -> np.ndarray:
    """Round a float array to 6 decimals, bit-identical to mapping
    Python's ``round(float(x), 6)`` over every element (the journal
    write-back contract).  Returns a float64 array of the input shape;
    scalars become 0-d arrays (use :func:`round6_scalar` for a Python
    float)."""
    arr = np.asarray(values, dtype=np.float64)
    out = np.round(arr, 6)
    with np.errstate(invalid="ignore", over="ignore"):
        scaled = arr * 1e6
        # Distance of the scaled value from the nearest half-boundary;
        # NaN/Inf propagate to NaN here and compare False (fast lane).
        frac = np.abs(scaled - np.floor(scaled) - 0.5)
        risky = (frac < _HALF_WINDOW) | (np.abs(arr) >= _BIG)
    if np.any(risky):
        flat_out = out.reshape(-1)
        flat_in = arr.reshape(-1)
        for i in np.flatnonzero(risky.reshape(-1)):
            flat_out[i] = round(float(flat_in[i]), 6)
    return out


def round6_scalar(x) -> float:
    """``round(float(x), 6)`` — the scalar twin, for call sites that
    journal a single reliability/ratio value."""
    return round(float(x), 6)


def round6_list(values) -> List:
    """The journal-payload form: :func:`round6` then ``tolist()`` —
    plain Python floats (1-D input) or nested lists (2-D), exactly what
    the per-element ``[round(float(x), 6) for x in row]`` loops built."""
    return round6(values).tolist()
