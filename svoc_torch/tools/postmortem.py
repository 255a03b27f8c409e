"""Dump a flight-recorder debug bundle on demand.

The twin of ``tools/postmortem.py`` (``postmortem.py:1-52``): the
journal tail, the span ring, the metrics registry and the environment
that the process-wide observability singletons hold, in one atomically
written JSON bundle (:func:`svoc_torch.utils.postmortem.build_bundle`).
Run it beside a live process, or import ``build_bundle`` and pass the
session for the resilience and configuration sections.

``--device`` (default CUDA, raising without a card) and ``--seed`` are
recorded in the bundle's ``extra`` section, so a bundle says where it
was taken; neither draws anything.

Usage::

    python -m svoc_torch.tools.postmortem [--out-dir .] [--trigger manual] [--device cpu] [--seed 0]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", default=".")
    p.add_argument("--trigger", default="manual")
    p.add_argument("--events-tail", type=int, default=512, help="journal events to embed")
    p.add_argument("--spans-tail", type=int, default=256, help="spans to embed")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    from svoc_torch.device import resolve_device
    from svoc_torch.utils.postmortem import build_bundle

    path = build_bundle(out_dir=args.out_dir, trigger=args.trigger, events_tail=args.events_tail,
                        spans_tail=args.spans_tail,
                        extra={"device": str(resolve_device(args.device)), "seed": args.seed})
    print(f"postmortem bundle written: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
