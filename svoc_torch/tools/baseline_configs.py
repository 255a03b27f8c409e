"""BASELINE configs 1-4 on the port: the step bodies of ``bench.py``'s
``bench_config1`` to ``bench_config4``.

This module mirrors the step bodies of ``bench.py::bench_config1``-
``bench_config4`` (``bench.py:891, 968, 1054, 1149``), not bench.py's
timer, replay or decision machinery.  The four configurations are the
first four of ``BASELINE.json``:

1. ``classify_and_predict`` (``bench.py:923``): DistilBERT-SST2 (6
   layers, vocab 30522, ``pad_id`` 0, ``ln_eps`` 1e-12, a softmax head,
   labels ``(0, 1)``) over 100 cached comments of 128 tokens as one
   batch, through the dense attention of the reference; the prediction
   is the window's mean (a one-oracle fleet).  No kernel: the
   reference's path is XLA only, and so is the port's.
2. ``one_update``/``run_chunk`` (``bench.py:981, 992``): 8 oracles, 2
   failing, Beta(10, 10) in 6 dimensions, 256 updates a chunk keyed
   ``fold_in(key, i)``.  The chunk's fleets are drawn in one call on the
   batched keys (threefry) and stacked ``[256, 8, 6]``.
3. ``step`` (``bench.py:1082``): RoBERTa go_emotions over a batch of 128
   comments of 128 tokens, the window ``vecs[:50, :2]``, 64 oracles (8
   failing, subsets of 10) by ``sim/oracle.py::gen_oracle_predictions``,
   then the fused consensus as ``flagship.py``'s step calls it (the
   one-fleet kernel B2 on the card).
4. ``one_step``/``run_chunk`` (``bench.py:1165, 1177``): 1024 oracles,
   256 failing, subsets of 10 over the window ``uniform(PRNGKey(1), (50,
   6)) / 6`` (``bench.py:1185``), 64 updates a chunk; the chunk's fleets
   are drawn in one call and stacked ``[64, 1024, 6]``.

Configs 2 and 4 put each chunk's consensus through one launch of the
gated claim-cube kernel (B3, :func:`svoc_torch.ops.fused_consensus.
consensus_blocks`), where the reference scans ``consensus_step`` over
the chunk: ``consensus_blocks`` computes that same function on every
block (every oracle admitted, every block active).  On the CPU every
config takes the plain forms, which is how the tests hold it against
the JAX package; on CUDA the kernels launch or raise, with no fallback.

Entry points default to CUDA (:func:`svoc_torch.device.resolve_device`)
and raise without a card; pass ``device="cpu"`` for the plain versions.

Usage::

    python -m svoc_torch.tools.baseline_configs --config {1,2,3,4}
        [--small] [--device cpu] [--seconds S]

prints bench.py's metric and unit for that config with the measured
value, on the wall clock with every step's result fetched to the host.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import torch

from svoc_torch.consensus.kernel import ConsensusConfig, ConsensusOutput
from svoc_torch.device import resolve_device
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import DISTILBERT_SST2, ROBERTA_GO_EMOTIONS, TINY_TEST
from svoc_torch.models.sentiment import SentimentPipeline
from svoc_torch.ops.fused_consensus import consensus_blocks, fused_consensus
from svoc_torch.sim import prng
from svoc_torch.sim.generators import generate_beta_oracles
from svoc_torch.sim.oracle import gen_oracle_predictions

#: Config 1: the cached window, its tokens (``small``: TINY_TEST at 32), the SST-2 labels.
CONFIG1_COMMENTS, CONFIG1_SEQ, CONFIG1_SMALL_SEQ = 100, 128, 32
CONFIG1_LABELS = (0, 1)  # SST-2: negative, positive
#: Config 2: the fleet, Beta(a, b) in ``dim`` dimensions, updates a chunk (``small``: 32).
CONFIG2_ORACLES, CONFIG2_FAILING, CONFIG2_DIM, CONFIG2_A, CONFIG2_B = 8, 2, 6, 10.0, 10.0
CONFIG2_CHUNK, CONFIG2_SMALL_CHUNK = 256, 32
#: Config 3: the fleet, the batch and its tokens (``small``: TINY_TEST, 32 x 32), the window.
CONFIG3_ORACLES, CONFIG3_FAILING, CONFIG3_SUBSET = 64, 8, 10
CONFIG3_BATCH, CONFIG3_SEQ, CONFIG3_SMALL_BATCH, CONFIG3_SMALL_SEQ = 128, 128, 32, 32
CONFIG3_WINDOW, CONFIG3_DIMS = 50, 2
#: Config 4: the fleet (``small``: 128), a quarter failing, updates a chunk (``small``: 16).
CONFIG4_ORACLES, CONFIG4_SMALL_ORACLES, CONFIG4_DIM, CONFIG4_SUBSET = 1024, 128, 6, 10
CONFIG4_CHUNK, CONFIG4_SMALL_CHUNK, CONFIG4_WINDOW = 64, 16, 50

METRICS = {
    1: ("config 1: single-oracle DistilBERT-SST2 sentiment, 100 cached comments", "comments/sec"),
    2: ("config 2: 8-oracle two-pass consensus on synthetic Beta vectors", "consensus-updates/sec"),
    3: ("config 3: 64 vmapped bootstrap oracles over batched sentiment, 2D", "comments/sec"),
    4: ("config 4: {n}-oracle adversarial pod sim ({f} failing), fused fleet+consensus",
        "consensus-updates/sec"),
}


class Chunk(NamedTuple):
    """One chunk of configs 2 and 4: the stacked fleets and their consensus."""

    values: torch.Tensor  #: [chunk, N, M]
    honest: torch.Tensor  #: [chunk, N]
    out: ConsensusOutput  #: every field with the chunk's leading axis
    detected: torch.Tensor  #: [chunk] failing oracles left out of the reliable set


# -- config 1 -----------------------------------------------------------------


def config1_pipeline(small: bool = False, device=None, params=None, cfg=None) -> SentimentPipeline:
    """``bench.py:904-916``'s pipeline: DistilBERT-SST2 (``small``:
    TINY_TEST) with the whole cached window as one batch; ``cfg``
    replaces the configuration (a float32 twin, a narrow shape)."""
    if cfg is None:
        cfg = TINY_TEST if small else DISTILBERT_SST2
    return SentimentPipeline(cfg=cfg, seq_len=CONFIG1_SMALL_SEQ if small else CONFIG1_SEQ,
                             batch_size=CONFIG1_COMMENTS, label_indices=CONFIG1_LABELS, params=params,
                             device=resolve_device(device))


def comment_batch(pipe: SentimentPipeline, n: int):
    """``SyntheticSource(batch=n, seed=0)``'s comments tokenized at the
    pipeline's length, on its device: ``(ids, mask)``."""
    ids, mask = pipe.tokenizer(SyntheticSource(batch=n, seed=0)(), pipe.seq_len)
    return torch.from_numpy(ids).to(pipe.device), torch.from_numpy(mask).to(pipe.device)


def config1_step(pipe: SentimentPipeline, ids: torch.Tensor, mask: torch.Tensor):
    """``classify_and_predict``: ``(vecs [B, 2], prediction [2])``, the
    prediction the window's mean."""
    vecs = pipe.forward(ids, mask)
    return vecs, vecs.mean(dim=0)


# -- config 2 -----------------------------------------------------------------


def _detected(out: ConsensusOutput, honest: torch.Tensor) -> torch.Tensor:
    return (~out.reliable & ~honest).sum(dim=-1)


def config2_chunk(key: torch.Tensor, chunk: int = CONFIG2_CHUNK) -> Chunk:
    """``run_chunk(key)``: ``chunk`` updates, update ``i`` drawing its
    Beta fleet from ``fold_in(key, i)``, on the key's device."""
    keys = prng.fold_in_range(key, 0, chunk)
    values, honest = generate_beta_oracles(keys, CONFIG2_ORACLES, CONFIG2_FAILING, CONFIG2_A, CONFIG2_B,
                                           dim=CONFIG2_DIM)
    out = consensus_blocks(values, ConsensusConfig(n_failing=CONFIG2_FAILING, constrained=True))
    return Chunk(values, honest, out, _detected(out, honest))


# -- config 3 -----------------------------------------------------------------


def config3_pipeline(small: bool = False, device=None, params=None) -> SentimentPipeline:
    """``bench.py:1069-1071``'s pipeline: RoBERTa go_emotions (``small``:
    TINY_TEST), dense attention, unpacked batches of 128 (32)."""
    cfg = TINY_TEST if small else ROBERTA_GO_EMOTIONS
    return SentimentPipeline(cfg=cfg, seq_len=CONFIG3_SMALL_SEQ if small else CONFIG3_SEQ,
                             batch_size=CONFIG3_SMALL_BATCH if small else CONFIG3_BATCH, params=params,
                             device=resolve_device(device))


def config3_step(pipe: SentimentPipeline, key: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor):
    """``step(key, ids, mask)``: the forward, the 2-D window, the fleet
    and its consensus; ``(output, honest, window)``."""
    vecs = pipe.forward(ids, mask)
    window = vecs[: min(CONFIG3_WINDOW, ids.shape[0]), :CONFIG3_DIMS]
    values, honest = gen_oracle_predictions(key, window, CONFIG3_ORACLES, CONFIG3_FAILING,
                                            subset_size=CONFIG3_SUBSET)
    out = fused_consensus(values.contiguous(), ConsensusConfig(n_failing=CONFIG3_FAILING, constrained=True))
    return out, honest, window


# -- config 4 -----------------------------------------------------------------


def config4_window(device=None) -> torch.Tensor:
    """``uniform(PRNGKey(1), (50, 6)) / 6`` (``bench.py:1185``)."""
    return prng.uniform(prng.PRNGKey(1, resolve_device(device)), (CONFIG4_WINDOW, CONFIG4_DIM)) / CONFIG4_DIM


def config4_chunk(key: torch.Tensor, window: torch.Tensor, chunk: int = CONFIG4_CHUNK,
                  n_oracles: int = CONFIG4_ORACLES) -> Chunk:
    """``run_chunk(key, window)``: ``chunk`` updates of ``n_oracles``
    (a quarter failing), update ``i`` drawing its fleet from
    ``fold_in(key, i)``, on the key's device."""
    n_failing = n_oracles // 4
    keys = prng.fold_in_range(key, 0, chunk)
    values, honest = gen_oracle_predictions(keys, window.expand(chunk, *window.shape), n_oracles, n_failing,
                                            subset_size=CONFIG4_SUBSET)
    out = consensus_blocks(values, ConsensusConfig(n_failing=n_failing, constrained=True))
    return Chunk(values, honest, out, _detected(out, honest))


# -- the timed runs -----------------------------------------------------------


def _latency_ms(fn, reps: int) -> float:
    """Median wall time of ``fn()``, whose result is fetched to the host."""
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return sorted(samples)[len(samples) // 2]


def _chunks(make, key, chunk: int, seconds: float):
    """bench.py's chunk loop: ``key = fold_in(key, n)``, one chunk, its
    ``[detected, checksum]`` fetched; ``(updates, elapsed, detected)``."""
    n, detected = 0, 0
    t0 = time.perf_counter()
    while n == 0 or time.perf_counter() - t0 < seconds:
        key = prng.fold_in(key, n)
        c = make(key)
        pair = torch.stack([c.detected.sum().to(torch.float32),
                            c.out.essence.sum() + c.out.reliability_second_pass.sum()]).cpu()
        detected += int(pair[0])
        n += chunk
    return n, time.perf_counter() - t0, detected


def run(config: int, small: bool = False, device=None, seconds: float = 2.0, params=None) -> dict:
    """One config's metric, value and unit, timed for about ``seconds``
    after a warm-up (at least one step), every step's result fetched.
    ``params``: the encoder's weights (configs 1 and 3; None: seeded).
    ``detail["calls"]`` counts the steps (chunks) run, the warm-up and
    the latency's included: a kernel of the step launches that often."""
    dev = resolve_device(device)
    metric, unit = METRICS[config]
    detail: dict = {}
    calls = 0

    def counted(fn):
        def call(*args):
            nonlocal calls
            calls += 1
            return fn(*args)
        return call

    reps = 3 if dev.type == "cpu" else 30
    if config in (1, 3):
        if config == 1:
            pipe = config1_pipeline(small, dev, params)
        else:
            pipe = config3_pipeline(small, dev, params)
        ids, mask = comment_batch(pipe, pipe.batch_size)
        # Config 1 draws nothing: no key, so no threefry launch.
        key = prng.PRNGKey(0, dev) if config == 3 else None
        if config == 1:
            step = counted(lambda k: config1_step(pipe, ids, mask)[1].cpu())
        else:
            step = counted(lambda k: config3_step(pipe, k, ids, mask)[0].essence.cpu())
        step(key)
        detail["step_latency_ms"] = _latency_ms(lambda: step(key), reps)
        n, steps = 0, 0
        t0 = time.perf_counter()
        while steps == 0 or time.perf_counter() - t0 < seconds:
            if key is not None:
                key = prng.fold_in(key, steps)
            step(key)
            n += pipe.batch_size
            steps += 1
        elapsed = time.perf_counter() - t0
        detail.update(batch=pipe.batch_size, seq_len=pipe.seq_len, steps=steps,
                      tokens_per_sec=n * pipe.seq_len / elapsed)
    else:
        key = prng.PRNGKey(0, dev)
        if config == 2:
            chunk = CONFIG2_SMALL_CHUNK if small else CONFIG2_CHUNK
            n_oracles, n_failing = CONFIG2_ORACLES, CONFIG2_FAILING
            make = counted(lambda k, c=chunk: config2_chunk(k, c))
        else:
            chunk = CONFIG4_SMALL_CHUNK if small else CONFIG4_CHUNK
            n_oracles = CONFIG4_SMALL_ORACLES if small else CONFIG4_ORACLES
            n_failing = n_oracles // 4
            window = config4_window(dev)
            make = counted(lambda k, c=chunk: config4_chunk(k, window, c, n_oracles))
            metric = metric.format(n=n_oracles, f=n_failing)
        make(key)
        detail["consensus_update_latency_ms"] = _latency_ms(lambda: make(key, 1).out.essence.cpu(), reps)
        n, elapsed, detected = _chunks(make, key, chunk, seconds)
        detail.update(n_oracles=n_oracles, n_failing=n_failing, chunk=chunk, steps=n,
                      mean_failing_detected=detected / n)
    detail.update(calls=calls, elapsed_s=elapsed, device=str(dev),
                  timing_method="wall clock, every step's (chunk's) result fetched to the host")
    return {"metric": metric, "value": n / elapsed, "unit": unit, "detail": detail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=int, choices=(1, 2, 3, 4), required=True)
    p.add_argument("--small", action="store_true", help="bench.py's small sizes")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    p.add_argument("--seconds", type=float, default=2.0, help="the timed window")
    args = p.parse_args(argv)
    print(json.dumps(run(args.config, args.small, args.device, args.seconds)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
