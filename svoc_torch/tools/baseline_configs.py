"""BASELINE configs 1-4, 7 and 11 on the port: the step bodies of
``bench.py``'s ``bench_config1`` to ``bench_config4``, ``bench_config7``
and ``bench_config11``.

This module mirrors the step bodies of ``bench.py::bench_config1``-
``bench_config4`` (``bench.py:891, 968, 1054, 1149``), ``bench_config7``
(``bench.py:1580``) and ``bench_config11`` (``bench.py:2159``, the body
of ``_bench_packed_dp_serving(quant="int8")`` at ``bench.py:2168``), not
bench.py's timer, replay or decision machinery.  The first four
configurations are the first four of ``BASELINE.json``:

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

7. ``serve`` (``bench.py:1618-1621``): data-parallel serving,
   :func:`svoc_torch.parallel.serving.dp_serving_step_fn` on
   :func:`~svoc_torch.parallel.serving.serving_mesh` (one slot a visible
   card; on one card the mesh has size 1, as bench.py's docstring says):
   RoBERTa go_emotions with bf16-resident weights over 256 rows of 128
   tokens a slot, the window of the first 50 vectors, 1024 oracles (128
   failing, subsets of 10), the fleet and the consensus oracle-parallel
   over the slots (``small``: TINY_TEST, 32 rows of 32 tokens a slot, 16
   oracles a slot).
11. ``serve``/``pserve``/``drain_fleet`` (``bench.py:2213-2227``): INT8
   (W8A8) sequence-packed data-parallel serving, the float32 weights
   folded by :func:`svoc_torch.models.quant.quantize_params`, 256 packed
   rows of 128 tokens a slot with up to 8 comments each (``small``:
   TINY_TEST, 16 rows of 32 tokens with up to 4).  The plain step
   (:func:`~svoc_torch.parallel.serving.packed_serving_step_fn`) runs the
   warm-up and the isolated latency; the timed loop runs the pipelined
   twin (:func:`~svoc_torch.parallel.serving.packed_serving_pipelined_step_fn`),
   primed as ``bench.py:2275-2297`` primes it (a zero window whose
   output is discarded, the consensus key riding the pipeline), and
   :func:`~svoc_torch.parallel.serving.fleet_step_fn` drains the last
   batch.

Configs 7 and 11 take ``SyntheticSource``'s comments through the native
tokenizer (and packer) with seeded weights: bench.py's full size names
the ``SamLowe/roberta-base-go_emotions`` tokenizer, which would be a
download.  No TPU kernel is on their paths: the dense and the int8
forwards bypass flash attention (B1), and the consensus tail is the
mesh's psum body, not B2; threefry draws the fleets.

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

    python -m svoc_torch.tools.baseline_configs --config {1,2,3,4,7,11}
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
from svoc_torch.flagship import pack_stream, token_lists
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import DISTILBERT_SST2, ROBERTA_GO_EMOTIONS, TINY_TEST, EncoderConfig
from svoc_torch.models.encoder import init_params
from svoc_torch.models.quant import quantize_params
from svoc_torch.models.sentiment import TRACKED_INDICES, SentimentPipeline
from svoc_torch.models.tokenizer import load_tokenizer
from svoc_torch.ops.fused_consensus import consensus_blocks, fused_consensus
from svoc_torch.parallel.mesh import Mesh
from svoc_torch.parallel.serving import (
    dp_serving_step_fn,
    fleet_step_fn,
    packed_serving_pipelined_step_fn,
    packed_serving_step_fn,
    serving_mesh,
)
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
#: Configs 7 and 11: rows and tokens a slot (``small``: TINY_TEST at 32 tokens), the packed
#: segments a row (config 11), the fleet (``small``: 16 oracles a slot), the window and subsets.
CONFIG7_ROWS, CONFIG7_SMALL_ROWS, CONFIG11_ROWS, CONFIG11_SMALL_ROWS = 256, 32, 256, 16
DP_SEQ, DP_SMALL_SEQ, CONFIG11_SEGMENTS, CONFIG11_SMALL_SEGMENTS = 128, 32, 8, 4
DP_ORACLES, DP_SMALL_ORACLES_PER_SLOT, DP_WINDOW, DP_SUBSET = 1024, 16, 50, 10
#: Distinct batches made before the clock of configs 7 and 11, taken in turn by the timed steps.
DP_BATCHES = 4

METRICS = {
    1: ("config 1: single-oracle DistilBERT-SST2 sentiment, 100 cached comments", "comments/sec"),
    2: ("config 2: 8-oracle two-pass consensus on synthetic Beta vectors", "consensus-updates/sec"),
    3: ("config 3: 64 vmapped bootstrap oracles over batched sentiment, 2D", "comments/sec"),
    4: ("config 4: {n}-oracle adversarial pod sim ({f} failing), fused fleet+consensus",
        "consensus-updates/sec"),
    7: ("config 7: data-parallel serving over {n_dev} device(s) — sharded sentiment batch -> {n}-oracle fleet "
        "-> consensus", "comments/sec"),
    11: ("config 11: INT8 (W8A8) sequence-packed data-parallel serving over {n_dev} device(s) — {s}-seg packed "
         "rows -> {n}-oracle fleet -> consensus", "comments/sec"),
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


# -- configs 7 and 11 ---------------------------------------------------------


class DPServing(NamedTuple):
    """Configs 7 and 11's serving steps on one mesh, at one size."""

    config: int
    mesh: Mesh
    cfg: EncoderConfig
    ccfg: ConsensusConfig
    n_oracles: int
    rows: int  #: the whole batch: rows a slot × slots
    seq: int
    max_seg: int  #: packed segments a row (config 11; 1 for config 7)
    window: int
    params: dict  #: bf16-resident (config 7, full size), float32, or the folded int8 tree (config 11)
    tokenizer: object
    serve: object  #: the plain step
    pipelined: object  #: config 11's pipelined twin (None for config 7)
    drain: object  #: config 11's drain (None for config 7)
    fold_s: float  #: seconds of the int8 fold (0.0 for config 7)


def dp_serving(config: int, small: bool = False, device=None, params=None, mesh: Mesh = None) -> DPServing:
    """Config 7's or 11's step functions at ``bench.py``'s sizes
    (``bench.py:1601-1621, 2196-2227``) on ``mesh`` (default: one slot
    a visible card, or ``device`` itself).  ``params``: the float
    encoder weights (None: seeded, seed 0, on ``device``)."""
    if config not in (7, 11):
        raise ValueError(f"config {config} is not a data-parallel serving config (7, 11)")
    dev = resolve_device(device)
    mesh = serving_mesh(device=dev) if mesh is None else mesh
    n_dev = mesh.size
    cfg = TINY_TEST if small else ROBERTA_GO_EMOTIONS
    if config == 7:
        per_slot, max_seg = (CONFIG7_SMALL_ROWS if small else CONFIG7_ROWS), 1
    else:
        per_slot = CONFIG11_SMALL_ROWS if small else CONFIG11_ROWS
        max_seg = CONFIG11_SMALL_SEGMENTS if small else CONFIG11_SEGMENTS
    seq = DP_SMALL_SEQ if small else DP_SEQ
    n_oracles = DP_SMALL_ORACLES_PER_SLOT * n_dev if small else DP_ORACLES
    if n_oracles % n_dev:
        n_oracles += n_dev - n_oracles % n_dev
    rows = per_slot * n_dev
    window = min(DP_WINDOW, rows)
    ccfg = ConsensusConfig(n_failing=max(2, n_oracles // 8), constrained=True)
    if params is None:
        params = init_params(cfg, 0, dev)
    quant, fold_s = ("int8" if config == 11 else None), 0.0
    if quant:  # the fold takes the float32 weights (bench.py:2205-2208)
        t0 = time.perf_counter()
        params = quantize_params(params, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        fold_s = time.perf_counter() - t0
    elif not small:  # bf16-resident weights (bench.py:1610)
        params = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in params.items()}
    kw = dict(window_size=window, subset_size=DP_SUBSET)
    if config == 7:
        serve, pipelined, drain = dp_serving_step_fn(mesh, cfg, ccfg, n_oracles, **kw), None, None
    else:
        serve = packed_serving_step_fn(mesh, cfg, ccfg, n_oracles, quant=quant, **kw)
        pipelined = packed_serving_pipelined_step_fn(mesh, cfg, ccfg, n_oracles, quant=quant, **kw)
        drain = fleet_step_fn(mesh, ccfg, n_oracles, subset_size=DP_SUBSET)
    tokenizer = load_tokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=seq)
    return DPServing(config, mesh, cfg, ccfg, n_oracles, rows, seq, max_seg, window, params, tokenizer, serve,
                     pipelined, drain, fold_s)


def dp_batches(s: DPServing, source, n: int) -> list:
    """``n`` batches of ``source``'s comments on the mesh's first slot:
    config 7's ``(ids, mask)`` and a comment count, config 11's ``(ids,
    pos, seg, cls_pos, valid)`` packed rows (the packed feed's,
    ``bench.py:1725-1791``) and the comments packed."""
    dev = s.mesh.devices.flat[0]
    out = []
    if s.config == 7:
        for _ in range(n):
            ids, mask = s.tokenizer(source(), s.seq)
            out.append(((torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)), s.rows))
        return out
    feed = pack_stream(token_lists(s.tokenizer, source, s.seq), s.rows, s.seq, s.max_seg, s.tokenizer.pad_id)
    for _, (batch, n_comments) in zip(range(n), feed):
        arrays = (batch.ids, batch.pos, batch.seg, batch.cls_pos, batch.seg_valid > 0)
        out.append((tuple(torch.from_numpy(a).to(dev) for a in arrays), n_comments))
    return out


def dp_step(s: DPServing, key: torch.Tensor, batch: tuple):
    """The plain serving step on one batch: ``(ConsensusOutput, honest)``."""
    with torch.inference_mode():
        return s.serve(s.params, key, *batch)


def dp_pipelined(s: DPServing, key: torch.Tensor, batch: tuple, prev_window: torch.Tensor):
    """Config 11's pipelined step: this batch's window, and the fleet and
    consensus of ``prev_window`` under ``key`` (the previous batch's):
    ``(window, ConsensusOutput, honest)``."""
    with torch.inference_mode():
        return s.pipelined(s.params, key, *batch, prev_window)


def dp_drain(s: DPServing, key: torch.Tensor, window: torch.Tensor):
    """Config 11's drain: the last window's ``(ConsensusOutput, honest)``."""
    with torch.inference_mode():
        return s.drain(key, window)


def zero_window(s: DPServing) -> torch.Tensor:
    """The dummy window that primes the pipelined loop (``bench.py:2285``)."""
    return torch.zeros(s.window, len(TRACKED_INDICES), device=s.mesh.devices.flat[0])


def _dp_run(s: DPServing, dev: torch.device, seconds: float, reps: int, counted, detail: dict):
    """The warm-up, the isolated step's latency and the timed loop of
    config 7 or 11: ``(comments, elapsed)``, every step's essence
    fetched."""
    key = prng.PRNGKey(0, dev)
    step = counted(lambda k, b: dp_step(s, k, b)[0].essence.cpu())
    # bench.py:1643-1644 (config 7: the timed source) and :2249-2253 (config 11: its own source, seed 1)
    warm_source = SyntheticSource(batch=s.rows, seed=1 if s.config == 11 else 0)
    warm = dp_batches(s, warm_source, 2)
    if torch.equal(step(key, warm[0][0]), step(key, warm[1][0])):  # bench.py:1647-1650, 2257-2260
        raise AssertionError(f"distinct {'packed' if s.config == 11 else 'warmup'} batches produced identical "
                             "serving checksums")
    detail["step_latency_ms"] = _latency_ms(lambda: step(key, warm[0][0]), reps)
    if s.config == 7:  # the timed source goes on from the warm-up batches
        timed = warm + dp_batches(s, warm_source, DP_BATCHES - 2)
    else:
        timed = dp_batches(s, SyntheticSource(batch=s.rows, seed=0), DP_BATCHES)
    essences = set()
    comments = steps = 0
    if s.config == 7:
        t0 = time.perf_counter()
        while steps == 0 or time.perf_counter() - t0 < seconds:
            key = prng.fold_in(key, steps)
            batch, n = timed[steps % len(timed)]
            essences.add(tuple(step(key, batch).tolist()))
            comments += n
            steps += 1
    else:
        pipelined = counted(lambda k, b, w: dp_pipelined(s, k, b, w))
        drain = counted(lambda k, w: dp_drain(s, k, w))
        # Primed with the warm-up batch's window; the zero window's output is discarded.
        prev_window, _, _ = pipelined(key, warm[0][0], zero_window(s))
        prev_key = key
        t0 = time.perf_counter()
        while steps == 0 or time.perf_counter() - t0 < seconds:
            key = prng.fold_in(key, steps)
            batch, n = timed[steps % len(timed)]
            prev_window, out, _ = pipelined(prev_key, batch, prev_window)
            prev_key = key
            essence = out.essence.cpu()
            if steps > 0:  # step 0's output is the warm-up batch's
                essences.add(tuple(essence.tolist()))
            comments += n
            steps += 1
        out, _ = drain(prev_key, prev_window)
        essences.add(tuple(out.essence.cpu().tolist()))
    elapsed = time.perf_counter() - t0
    if steps >= 2 and len(essences) < max(2, steps // 2):  # bench.py's assert_checksums_distinct
        raise AssertionError(f"per-step outputs are not distinct ({len(essences)} of {steps}) — the timed "
                             "loop is replaying identical work; measurement invalid")
    detail.update(n_mesh_devices=s.mesh.size, rows=s.rows, seq_len=s.seq, steps=steps,
                  consensus_n_oracles=s.n_oracles, n_failing=s.ccfg.n_failing, window=s.window,
                  distinct_essences=len(essences), tokens_per_sec=steps * s.rows * s.seq / elapsed)
    if s.config == 11:
        detail.update(max_segments=s.max_seg, packing_factor=comments / (steps * s.rows), pipelined=True,
                      quant="int8", fold_s=s.fold_s)
    return comments, elapsed


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
    ``params``: the encoder's weights (configs 1, 3, 7 and 11; None:
    seeded; config 11 folds them to int8).
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
    elif config in (7, 11):
        s = dp_serving(config, small, dev, params)
        metric = metric.format(n_dev=s.mesh.size, n=s.n_oracles, s=s.max_seg)
        n, elapsed = _dp_run(s, dev, seconds, reps, counted, detail)
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
    p.add_argument("--config", type=int, choices=sorted(METRICS), required=True)
    p.add_argument("--small", action="store_true", help="bench.py's small sizes")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    p.add_argument("--seconds", type=float, default=2.0, help="the timed window")
    args = p.parse_args(argv)
    print(json.dumps(run(args.config, args.small, args.device, args.seconds)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
