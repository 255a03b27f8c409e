"""The console's command line.

Mirrors :mod:`svoc_tpu.apps.cli` (``cli.py:22-120``): :func:`build_parser`,
:func:`build_adapter` and :func:`main`, with the reference's flags
(``--int8`` included: the session's vectorizer then runs the W8A8
forward, :mod:`svoc_torch.models.quant`) and one more, ``--device``
(default ``cuda``, raising without a card; ``cpu`` runs the plain
versions).

``python -m svoc_torch.apps.cli [--dimension N] [--scraper] [--rate R]
[--live_mode] [--disable_startup_fetch] [--seed-comments N] [--int8]
[--device cuda|cpu]``

The local chain simulator is the default backend (``--contract-info``
with ``--accounts`` selects Sepolia).  Commands are read from standard
input (the command language of :mod:`svoc_torch.apps.commands`, ``help``
to list); the console boots with ``resume`` and ``fetch`` unless
``--disable_startup_fetch``.
"""

from __future__ import annotations

import argparse
import sys

from svoc_torch.apps.commands import CommandConsole
from svoc_torch.apps.session import Session, SessionConfig
from svoc_torch.io.comment_store import CommentStore
from svoc_torch.io.scraper import SyntheticSource


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="svoc",
        description="Stochastic vector oracle consensus client (PyTorch/CUDA)",
    )
    p.add_argument("--dimension", type=int, default=6)
    p.add_argument("--n-oracles", type=int, default=7)
    p.add_argument("--n-failing", type=int, default=2)
    p.add_argument("--scraper", action="store_true",
                   help="run the ingest loop in the background")
    p.add_argument("--rate", type=float, default=600.0,
                   help="scraper period in seconds (main.py:23)")
    p.add_argument("--refresh", type=float, default=5.0,
                   help="auto_fetch period in seconds (common.py:11)")
    p.add_argument("--live-scraper", action="store_true",
                   help="scrape HN via Selenium when available")
    p.add_argument("--int8", action="store_true",
                   help="serve sentiment through the W8A8 dynamic-PTQ "
                        "forward (int8 x int8 -> int32 block matmuls)")
    p.add_argument("--live_mode", action="store_true")
    p.add_argument("--disable_startup_fetch", action="store_true")
    p.add_argument("--db", default=":memory:",
                   help="comment store path (reference: data/comments.db)")
    p.add_argument("--seed-comments", type=int, default=200,
                   help="pre-seed an empty store with N synthetic comments")
    p.add_argument("--contract-info", default=None,
                   help="data/contract_info.json (rpc + deployed address) — "
                        "with --accounts, commits go to Sepolia instead of "
                        "the local simulator")
    p.add_argument("--accounts", default=None,
                   help="data/sepolia.json with admin/oracle keys "
                        "(client/README.md:38-77 layout)")
    p.add_argument("--device", default="cuda",
                   help="where the fleet, the vectorizer and the contract "
                        "run (default: cuda, which raises without a card)")
    return p


def session_device(args):
    """``--device``: ``cuda`` resolves through
    :func:`svoc_torch.device.resolve_device` (raising without a card)."""
    return None if args.device == "cuda" else args.device


def build_adapter(args):
    """The chain backend for parsed CLI args: Sepolia when both
    ``--contract-info`` and ``--accounts`` are given (reference
    ``retrieve_account_data`` + RPC path), else the local simulator
    (``None`` → Session default)."""
    if bool(args.contract_info) != bool(args.accounts):
        raise SystemExit(
            "--contract-info and --accounts must be given together"
        )
    if not args.contract_info:
        return None
    from svoc_torch.io.chain import ChainAdapter, starknet_backend_from_files

    return ChainAdapter(
        starknet_backend_from_files(args.contract_info, args.accounts)
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    store = CommentStore(args.db)
    if store.count() == 0 and args.seed_comments:
        store.save(SyntheticSource(batch=args.seed_comments)())

    session = Session(
        config=SessionConfig(
            n_oracles=args.n_oracles,
            n_failing=args.n_failing,
            dimension=args.dimension,
            refresh_rate_s=args.refresh,
            scraper_rate_s=args.rate,
            live_scraper=args.live_scraper,
            quant_inference="int8" if args.int8 else None,
        ),
        store=store,
        adapter=build_adapter(args),
        device=session_device(args),
    )
    console = CommandConsole(session, write=print)

    if args.scraper:
        console.query("scraper on")
    if args.live_mode:
        console.query("live_mode on")
    if not args.disable_startup_fetch:
        # main.py:51-54 boots with resume + fetch.
        console.query("resume")
        console.query("fetch")

    print("svoc console — 'help' for commands, 'exit' to quit")
    while session.application_on:
        try:
            line = input("> ")
        except EOFError:
            break
        console.query(line)
    console.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
