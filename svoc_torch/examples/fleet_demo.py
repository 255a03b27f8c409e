"""Fleet-scale walkthrough: the product configuration, end to end.

Mirrors ``examples/fleet_demo.py`` (``main`` ``:34``): a 1024-oracle
fleet through the port's own stack, printing the reference's lines:

1. comments → sequence-packed sentiment (TINY_TEST with flash attention,
   the flash-attention kernel on the card) → bootstrap fleet → preview,
   through :meth:`svoc_torch.apps.session.Session.fetch`;
2. the same fleet committed through the chain adapter — 1024 signed-tx
   semantics in one device-certified batched commit
   (:meth:`~svoc_torch.apps.session.Session.commit`), then ``resume``
   reads the contract back;
3. detection quality at fleet scale
   (:func:`svoc_torch.sim.montecarlo.fleet_benchmark`, every trial's
   consensus one cube through the gated claim-cube kernel on the card):
   uniform adversaries, then a coordinated 55 % bias past the
   breakdown point.

Stage 1's sentiment weights are the port's seeded ones (seed 0, drawn
on the CPU's generator and moved to the device, so that every device
serves the same weights), not flax's: the preview and the commit's
reliabilities are near the reference's run, not equal to it.  Stage 3
draws only from ``PRNGKey(0)`` and gives the reference's rates.
``main`` runs :func:`run`, which takes the pipeline's weights (the tests
pass the reference's).

Usage::

    python -m svoc_torch.examples.fleet_demo [--oracles 1024] [--failing 256] [--trials 50] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from svoc_torch.apps.session import Session, SessionConfig
from svoc_torch.device import resolve_device
from svoc_torch.examples import add_device_argument
from svoc_torch.io.comment_store import CommentStore
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import TINY_TEST
from svoc_torch.models.encoder import init_params
from svoc_torch.models.sentiment import SentimentPipeline
from svoc_torch.sim import prng
from svoc_torch.sim.montecarlo import fleet_benchmark


def run(n: int = 1024, f: int = 256, trials: int = 50, device=None, params=None) -> dict:
    """The demo's three stages; ``params``: the TINY_TEST encoder's
    weights (None: seeded, seed 0, on the CPU).  Returns what it printed,
    by stage."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(TINY_TEST, 0, "cpu")
    print(f"== fleet demo: {n} oracles, {f} adversarial ==")
    pipe = SentimentPipeline(cfg=dataclasses.replace(TINY_TEST, attention="flash"), seq_len=32, batch_size=16,
                             packed=True, params=params, device=dev)
    store = CommentStore()
    store.save(SyntheticSource(batch=60, seed=1)())
    session = Session(config=SessionConfig(n_oracles=n, n_failing=f), store=store, vectorizer=pipe, device=dev)
    t0 = time.perf_counter()
    preview = session.fetch()
    t_fetch = time.perf_counter() - t0
    print(
        f"fetch: {preview['n_comments']} comments -> {n} oracle "
        f"predictions in {t_fetch:.2f}s (packed x flash forward + "
        "bootstrap fleet + preview ranks)"
    )
    suspects = int(np.sum(preview["normalized_ranks"] <= 0.2))
    print(f"preview flags {suspects} oracles as suspect (red in the UI)")

    t0 = time.perf_counter()
    n_tx = session.commit()
    t_commit = time.perf_counter() - t0
    state = session.adapter.resume()
    print(
        f"commit: {n_tx} txs in {t_commit:.2f}s (device-certified batch "
        "— sequential-loop semantics, O(1) golden recomputes)"
    )
    print(
        f"on-chain: active={state['consensus_active']} rel1="
        f"{state['reliability_first_pass']:.3f} rel2="
        f"{state['reliability_second_pass']:.3f}"
    )

    key = prng.PRNGKey(0, dev)
    uniform = fleet_benchmark(key, n, f, k_trials=trials)
    print(
        f"uniform adversaries ({f}/{n}): per-oracle misflag rate "
        f"{uniform['misclassified_rate_pct']:.2f} %, restricted-median "
        f"reliability {uniform['reliability_pct']:.2f} %"
    )
    f_capture = int(0.55 * n)
    capture = fleet_benchmark(key, n, f_capture, k_trials=trials, biased=True)
    print(
        f"coordinated capture ({f_capture}/{n}, biased): misflag rate "
        f"{capture['misclassified_rate_pct']:.2f} % — the estimator inverts "
        "past N/2 (docs/ALGORITHM.md §5 breakdown curve)"
    )
    return dict(preview=preview, suspects=suspects, n_tx=n_tx, state=state, session=session, uniform=uniform,
                capture=capture)


def printed_bars(trials: int, oracles: int) -> tuple:
    """For :func:`svoc_torch.examples.compare_printed`: a misflag rate
    counts oracle-trials, so one oracle-trial's share (100/(K*N)
    percentage points) on top of its printed unit (the reliability is a
    mean of distances, held to its printed unit); the preview's suspects,
    the oracles whose normalized rank is at most 0.2, one oracle (one
    whose rank sits at the cut moves with the last bit of the window's
    vectors)."""
    return ((r"misflag rate (\S+) %", 100.0 / (trials * oracles)), (r"preview flags (\d+) oracles", 1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--oracles", type=int, default=1024)
    p.add_argument("--failing", type=int, default=256)
    p.add_argument("--trials", type=int, default=50)
    add_device_argument(p)
    args = p.parse_args(argv)
    run(args.oracles, args.failing, args.trials, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
