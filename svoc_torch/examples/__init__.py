"""The reference's example scripts as the port's entry points.

One module a script of ``examples/``, each naming the script it mirrors
and printing the same lines from the same stages:

- :mod:`.beta_kumaraswamy_demo` (``examples/beta_kumaraswamy_demo.py``);
- :mod:`.gaussian_demo` (``examples/gaussian_demo.py``);
- :mod:`.multimodal_demo` (``examples/multimodal_demo.py``);
- :mod:`.fleet_demo` (``examples/fleet_demo.py``);
- :mod:`.serving_demo` (``examples/serving_demo.py``).

Each runs as ``python -m svoc_torch.examples.<name>`` and has
``main(argv=None) -> int``.  The reference's ``--platform`` flag becomes
``--device``: the default is CUDA, which raises without a card
(:func:`svoc_torch.device.resolve_device`); ``--device cpu`` runs the
plain PyTorch versions.  Nothing falls back from one to the other.

:func:`compare_printed` holds a demo's output to the reference's, number
by number; each demo's ``printed_bars`` says which of its numbers count
trials and so may move by one trial's share.
"""

from __future__ import annotations

import argparse
import re

#: Every demo's ``--device`` help.
DEVICE_HELP = "torch device; default cuda (raises without a card); cpu runs the plain PyTorch versions"


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    """The ``--device`` flag that takes the place of the reference's ``--platform``."""
    parser.add_argument("--device", default=None, help=DEVICE_HELP)


#: A printed number, an exponent included.
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
#: What a demo prints from a clock: the fleet demo's stage seconds and the
#: serving demo's rates.
_CLOCKS = ((re.compile(r"in \d+\.\d+s"), "in #s"),
           (re.compile(r"\s+[\d.]+ comments/sec \(\s*[\d.]+ ms/step\)"), ""))


def without_clocks(text: str) -> str:
    """``text`` with every number read from a clock cut out."""
    for pattern, repl in _CLOCKS:
        text = pattern.sub(repl, text)
    return text


def printed_unit(token: str) -> float:
    """One unit of the last printed place of ``token`` (0 for an integer)."""
    mantissa, _, exponent = token.partition("e")
    places = len(mantissa.split(".")[1]) if "." in mantissa else 0
    if not places and not exponent:
        return 0.0
    return 10.0 ** (int(exponent or 0) - places)


def compare_printed(got: str, want: str, bars=()):
    """``got`` against the reference's ``want``, line by line: the same
    words, and each number within one unit of its last printed place (the
    generators agree with JAX's to a few ulp, so a printed digit may round
    the other way) plus the bar of the first ``(pattern, bar)`` of
    ``bars`` one of whose groups spans the number in ``want``'s line.
    Returns ``(ok, gaps)``, ``gaps`` the largest non-zero gap of a line
    (keyed by its first 40 characters) or why two lines differ."""
    got_lines, want_lines = got.strip("\n").splitlines(), want.strip("\n").splitlines()
    if len(got_lines) != len(want_lines):
        return False, {"lines": (len(got_lines), len(want_lines))}
    ok, gaps = True, {}
    for g, w in zip(got_lines, want_lines):
        if NUMBER.sub("#", g) != NUMBER.sub("#", w):
            ok, gaps[w[:40]] = False, f"words differ: {g!r}"
            continue
        spans = [(m.span(i), bar) for pattern, bar in bars for m in [re.search(pattern, w)] if m
                 for i in range(1, m.re.groups + 1)]
        for mg, mw in zip(NUMBER.finditer(g), NUMBER.finditer(w)):
            extra = next((bar for (start, end), bar in spans if start <= mw.start() and mw.end() <= end), 0.0)
            gap = abs(float(mg.group()) - float(mw.group()))
            if gap > printed_unit(mw.group()) + extra + 1e-9:
                ok = False
            if gap:
                gaps[w[:40]] = max(gaps.get(w[:40], 0.0), gap)
    return ok, gaps
