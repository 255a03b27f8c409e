"""Packed / pipelined / int8 serving walkthrough on the serving mesh.

Mirrors ``examples/serving_demo.py`` (``main`` ``:42``, its four rungs):
the serving ladder end to end on a 1-D ``data`` mesh
(:mod:`svoc_torch.parallel.serving`), one throughput line a rung:

1. **dense DP serving** — the batch split over the slots, the window
   gathered, the fleet and consensus oracle-parallel
   (:func:`~svoc_torch.parallel.serving.dp_serving_step_fn`);
2. **packed serving** — several comments a fixed row
   (:func:`~svoc_torch.parallel.serving.packed_serving_step_fn`);
3. **packed + software-pipelined** — the consensus of batch k−1 in the
   same step as batch k's forward
   (:func:`~svoc_torch.parallel.serving.packed_serving_pipelined_step_fn`
   and the :func:`~svoc_torch.parallel.serving.fleet_step_fn` drain),
   lossless: its output is checked equal to rung 2's before it runs;
4. **packed + pipelined + int8** — the W8A8 forward
   (:func:`svoc_torch.models.quant.quantize_params`) on the same
   pipeline.

The reference builds its mesh from ``len(jax.devices())``: one chip, or
the 8 virtual CPU devices of ``examples/README.md``'s command.  Here
``--slots N`` gives N slots of the device (``--slots 8`` is
:data:`svoc_torch.parallel.mesh.MESH_SLOTS`, the reference's simulated
device count); the default is one slot a visible card
(:func:`~svoc_torch.parallel.serving.serving_mesh`).  At the tiny
default shapes one slot gives a window of 4 rows, fewer than a bootstrap
subset of 10, and the first rung raises the reference's ``ValueError``,
as the reference does on one device; ``--slots 8`` or ``--full`` runs.

Tiny shapes by default; ``--full`` for flagship shapes (the
roberta-base config, seeded random weights).

Usage::

    python -m svoc_torch.examples.serving_demo [--steps 20] [--full] [--slots N] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.device import resolve_device
from svoc_torch.examples import add_device_argument
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, TINY_TEST
from svoc_torch.models.packing import pack_tokens_auto, strip_padding
from svoc_torch.models.quant import quantize_params
from svoc_torch.models.sentiment import SentimentPipeline
from svoc_torch.parallel.mesh import Mesh
from svoc_torch.parallel.serving import (
    dp_serving_step_fn,
    fleet_step_fn,
    packed_serving_pipelined_step_fn,
    packed_serving_step_fn,
    serving_mesh,
)
from svoc_torch.sim import prng


@torch.inference_mode()
def ladder(mesh: Mesh, steps: int = 20, full: bool = False, seed: int = 0) -> dict:
    """The four rungs on ``mesh``: ``{rung: comments/s}``, after the
    pipelined rung's lossless check."""
    n_dev = mesh.size
    dev = mesh.devices.flat[0]
    if full:
        cfg, rows, seq, n_oracles, max_seg = ROBERTA_GO_EMOTIONS, 256, 128, 1024, 8
    else:
        cfg, rows, seq, n_oracles, max_seg = TINY_TEST, 4 * n_dev, 32, 16 * n_dev, 4
    window = min(50, rows)
    ccfg = ConsensusConfig(n_failing=max(2, n_oracles // 8), constrained=True)
    pipe = SentimentPipeline(cfg=cfg, seq_len=seq, batch_size=rows, seed=seed, device=dev)
    params = pipe.model.state_dict()
    source = SyntheticSource(batch=rows, seed=seed)
    rates = {}

    def sync_count(out, n):
        """A host fetch of the consensus essence (the step ran), then the step's comment count."""
        float(out.essence[0])
        return n

    def timed(name, step, feed, fetch):
        """``steps`` iterations after a warm one; the clock stops after a
        host fetch of the last result."""
        out = step(feed())
        fetch(out)
        t0 = time.perf_counter()
        for _ in range(steps):
            out = step(feed())
        n_last = fetch(out)
        dt = time.perf_counter() - t0
        per_sec = steps * n_last / dt
        print(f"  {name:34s} {per_sec:10.1f} comments/sec ({dt / steps * 1e3:6.2f} ms/step)")
        rates[name] = per_sec
        return per_sec

    print(f"[serving demo] {n_dev} device(s), {'flagship' if full else 'tiny'} shapes, "
          f"{n_oracles}-oracle fleet, window {window}")

    # 1. dense DP serving
    serve = dp_serving_step_fn(mesh, cfg, ccfg, n_oracles, window_size=window, subset_size=10)
    key = prng.PRNGKey(seed, dev)

    def dense_feed():
        ids, mask = pipe.tokenizer(source(), seq)
        return torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)

    timed("dense DP serving", lambda b: serve(params, key, *b), dense_feed, lambda o: sync_count(o[0], rows))

    # the shared packed feed (native tokenize + pack)
    def packed_feed():
        ids, mask = pipe.tokenizer(source(), seq)
        batch, n = pack_tokens_auto(strip_padding(ids, mask), seq, max_seg, pipe.tokenizer.pad_id, rows=rows)
        arrs = tuple(torch.from_numpy(a).to(dev) for a in (batch.ids, batch.pos, batch.seg, batch.cls_pos))
        return arrs, torch.from_numpy(batch.seg_valid > 0).to(dev), n

    # 2. packed serving
    pserve = packed_serving_step_fn(mesh, cfg, ccfg, n_oracles, window_size=window, subset_size=10)
    timed("packed serving", lambda b: (pserve(params, key, *b[0], b[1]), b[2]), packed_feed,
          lambda o: sync_count(o[0][0], o[1]))

    # 3. packed + pipelined (lossless: checked against the plain step)
    pipe_serve = packed_serving_pipelined_step_fn(mesh, cfg, ccfg, n_oracles, window_size=window, subset_size=10)
    drain = fleet_step_fn(mesh, ccfg, n_oracles, subset_size=10)
    state = {"win": torch.zeros(window, pipe.dimension, device=dev)}

    def pipelined_step(b):
        arrs, valid, n = b
        state["win"], out, _ = pipe_serve(params, key, *arrs, valid, state["win"])
        return out, n

    check = packed_feed()
    ref_out, _ = pserve(params, key, *check[0], check[1])
    state["win"], _, _ = pipe_serve(params, key, *check[0], check[1], state["win"])
    got_out, _ = drain(key, state["win"])
    np.testing.assert_array_equal(got_out.essence.cpu().numpy(), ref_out.essence.cpu().numpy())
    timed("packed + pipelined", pipelined_step, packed_feed, lambda o: sync_count(o[0], o[1]))

    # 4. packed + pipelined + int8
    qparams = quantize_params(params, cfg)
    qserve = packed_serving_pipelined_step_fn(mesh, cfg, ccfg, n_oracles, window_size=window, subset_size=10,
                                              quant="int8")
    qstate = {"win": state["win"]}

    def int8_step(b):
        arrs, valid, n = b
        qstate["win"], out, _ = qserve(qparams, key, *arrs, valid, qstate["win"])
        return out, n

    timed("packed + pipelined + int8", int8_step, packed_feed, lambda o: sync_count(o[0], o[1]))
    print("[serving demo] pipelined output verified equal to the plain step")
    return rates


def main(argv=None) -> int:
    def positive_int(v):
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return n

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=positive_int, default=20)
    parser.add_argument("--full", action="store_true", help="flagship shapes")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--slots", type=positive_int, default=None,
                        help="mesh slots of the device (default: one a visible card)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = serving_mesh(device=dev) if args.slots is None else serving_mesh([dev] * args.slots)
    ladder(mesh, args.steps, args.full, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
