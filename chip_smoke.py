#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``svoc_torch``) on one NVIDIA GPU and check it.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

Phases:

1. Environment: the card's name and power limit, the torch and CUDA
   versions, and the build of every CUDA kernel from ``svoc_torch/csrc``
   (one ``nvcc`` per source, all at once, into ``svoc_torch/_build``).
1b. The gridded block-copy kernel against its plain version and its
   input, bit for bit: the probe's shape ([4, 256, 128] float32, blocks
   (1, 128, 128), grid (4, 2, 1)), [64, 8192, 128] float32 (256 MiB each
   way), a (1, 64, 128) block (grid (4, 4, 1)), bf16, a narrow block on
   the scalar path, two refusals; times beside ``x.clone()`` and the
   bound ``2 * bytes / 3.35 TB/s``.
2. The flash-attention kernel against its plain PyTorch version: the
   flagship shape [256, 128, 12, 64] in bf16 with segment ids from a real
   packed batch (3e-2), the per-key mask mode, float32 at every head width
   (2e-5, the CUDA-core body), bf16 at every head width with T = 1, 77 and
   1000 in both mask modes (the tensor-core body: 3e-2, lse 1e-3, two
   launches bit for bit equal), dead rows (exactly 0 and lse -inf), the
   lse, and T = 1000 as one segment and in runs of 50 tokens; the share
   of 64 x 64 tile pairs that a tag-range skip would save at the flagship
   (the kernels visit every tile). Times by CUDA events at the flagship
   shape and at flash_probe's four shapes beside SDPA and the bound (B1
   twice at each, before and after SDPA).
2b. The flash backward kernels (dq, and dk with dv) against the plain
   backward's fp32 result on the same inputs: the flagship shape in
   bf16 with segment ids from a real packed batch (3e-2, plus one bf16
   rounding of the kernel's output), the per-key mask mode with a fully
   masked row, float32 at every head width with T = 77 (1e-4), bf16 at
   every head width with T = 1, 77 and 1000 in both mask modes (dq, dk
   and dv of two launches bit for bit equal), T = 1000 as one segment
   and in runs of 50 tokens, and exact zeros for padding queries and
   dead keys; then their times beside the plain backward's and SDPA's
   backward under the same boolean mask, and at flash_probe's four
   shapes beside SDPA's backward and the bounds (``backward_times``;
   dq's CUDA-core times from before its tensor-core body beside).
2c. Flash against dense attention, in-process through
   ``svoc_torch.tools.flash_probe``: the numerics adjudication
   (``parity_only``: both bf16 results against a float32-truth dense
   attention; the verdict must be ``rounding-equivalent``) and the timed
   runs (``main``) at (B, T) = (256, 128), (8, 512), (8, 2048), (2, 8192)
   with 12 heads of 64 in bf16, forward and backward, with each side's
   peak device memory; SDPA under the same all-ones key mask is timed
   beside them by the same protocol (yardstick only).
3. The fused-consensus kernel against its plain version: N = 1024, M = 6,
   n_failing = 128, constrained and unconstrained, three tie-heavy fleets
   (quantised to 1e-2, every row equal, -0.0 and +0.0 mixed), N = 7 and
   N = 1000. The reliable mask exact; essence, risk and reliabilities
   within 1e-5; skewness within 1e-4; kurtosis within 1e-3.
3b. The gated claim-cube kernel against its plain version: the
   ``bench.py --claims 64 --claims-oracles 1024`` cube ([64, 1024, 6],
   n_failing 256, every eighth claim's last oracle quarantined), the
   degenerate spectrum (a clean claim, a partly quarantined claim with a
   NaN row, an all-quarantined claim, a single survivor, padding claims
   from 3 -> 4) at N = 1024 and N = 7, a cube quantised to 1e-2 (ties) and
   an unconstrained cube. The reliable mask and interval_valid exact;
   essences, reliabilities and finite risks within 1e-5, infinite risks
   equal; skewness within 1e-4; kurtosis within 1e-3. Two refusals (a
   smooth_mode "true" config, a fleet beyond shared memory). Times at
   [64, 1024, 6]: the kernel, the plain version, the bound, and 64
   sequential one-claim launches against one batched launch (claims/s).
4. The serving step: first a small float32 step on the card against the
   same step on the CPU (the plain versions the CPU tests hold against the
   JAX package), for each of the three flagship variants; then the main
   path at full width, ROBERTA_GO_EMOTIONS
   with bf16 weights, 256 packed rows of 128 tokens with up to 8 comments,
   a 50-comment window, 1024 oracles, subsets of 10: one warm-up step and
   five timed steps on distinct batches. Every kernel's launch count is
   set to 0 just before the main path and read just after it; the
   backward kernels must launch 0 times there. One more step then runs
   under ``torch.profiler`` for a breakdown of device time
   (informational: it cannot fail the run). Then (4c) the other two
   flagship variants at the same full width, ``packed`` (packed rows,
   dense attention) and ``dense`` (256 unpacked comments, dense
   attention): one warm-up and five timed steps each on distinct batches,
   0 flash launches and 1 fused-consensus launch a step; and on one
   shared set of 256 comments the per-comment vectors of the three
   variants agree (5e-3 in bf16).
5. The fine-tune step: first a small float32 step on the card against
   the same step on the CPU (one SGD(0.1) and one AdamW step, TINY_TEST,
   the same packed batch); then the training path at full width,
   ROBERTA_GO_EMOTIONS with float32 master parameters and bf16
   compute, AdamW(1e-4), 256 packed rows of 128 tokens with up to 8
   comments and seeded multi-hot labels: one warm-up step, five timed
   steps on distinct batches, ten steps on one fixed batch, with the
   launch counts set to 0 before and read after; every parameter must
   move, including the 36 query, key and value projections, the loss on
   the fixed batch must fall, and a saved and restored state must equal
   the original. One profiled step follows (informational).
6. The multi-claim serving step at full width: 64 claims of 1024
   oracles (128 failing, constrained), ROBERTA_GO_EMOTIONS with bf16
   weights; each step takes 8 new comments per claim (512), assembled
   round-robin into one packed forward of 256 rows of 128 tokens with up
   to 8 comments, then per-claim windows (8 -> 50 rows) and fleets, the
   in-graph quarantine gate and one gated claim-cube launch. The last
   claim's oracle 1023 is tampered in rotation by the fabric scenario's
   hook in its numpy form, which gets the block on the host as float64
   (a NaN component, an inf row, a 7.5 row; the first step clean).
   Eight steps, the last five timed, with every kernel's launch count
   set to 0 before and read after: 12 flash and 1 claim-cube launch a
   step, no other. The
   offender's slot is quarantined (the host gate agrees, with its
   reason) and it still reports a finite consensus over 1023 oracles;
   a second run without the tamper gives the 63 other claims' outputs
   bit for bit; one step's cube through the plain path meets the 3b
   bars; essences differ across claims and steps. One more step runs
   under ``torch.profiler`` (informational).
7. The probe path: ``svoc_torch.tools.probe.main`` through its normal
   entry, each probe in its own interpreter under a timeout: nine records
   (``backend``, ``grid_copy``, ``consensus128/256/512/1024``,
   ``flash512``, ``encoder512_dense``, ``encoder512_flash``), every one
   ok, with ``correct``, ``essence_match`` and ``match_dense`` true and
   ``GPU_PROBE.json`` readable. Each record carries the launch counts of
   its own interpreter (set to 0 by its start, read at its end): the
   grid-copy kernel must have launched in ``grid_copy``, the flash kernel
   12 times a forward in ``encoder512_flash`` and never in
   ``encoder512_dense``. A probe that fails or times out fails the run.

It then prints one JSON line of per-kernel numbers, the card's
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. It exits non-zero, and prints no
result, if any check fails, if there is no CUDA device, or if the
``svoc_torch`` package is not beside it. Bounds use the H100 SXM data
sheet: 3.35 TB/s, 989 TFLOP/s bf16 and 67 TFLOP/s fp32.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
KERNELS = ("flash_attention", "flash_attention_bwd", "fused_consensus",
           "gated_claims_consensus", "grid_copy")  # sources
MAIN_STEPS = 5  # timed steps after one warm-up step
CLAIMS, ORACLES, REQUESTS_PER_CLAIM = 64, 1024, 8  # the multi-claim path
CLAIM_STEPS, CLAIM_TIMED = 8, 5  # its steps, of which the last are timed
FIXED_STEPS = 10  # training steps on one fixed batch
#: The fixed batch's last loss must be below this × its first (0.963
#: measured on an NVIDIA H100 80GB HBM3).
FIXED_LOSS_RATIO = 0.98
#: Largest difference between the three flagship variants' per-comment
#: bf16 vectors on shared comments (1.8e-3 measured on an NVIDIA H100
#: 80GB HBM3).
VARIANT_BAR = 5e-3
#: The kernels of the JSON line: name → (source, the TPU kernel it replaces).
KERNEL_ROWS = {
    "flash_attention": ("svoc_torch/csrc/flash_attention.cu", "svoc_tpu/ops/pallas_attention.py:71"),
    "flash_dq": ("svoc_torch/csrc/flash_attention_bwd.cu", "svoc_tpu/ops/pallas_attention.py:157"),
    "flash_dkv": ("svoc_torch/csrc/flash_attention_bwd.cu", "svoc_tpu/ops/pallas_attention.py:201"),
    "fused_consensus": ("svoc_torch/csrc/fused_consensus.cu", "svoc_tpu/ops/pallas_consensus.py:209"),
    "gated_claims_consensus": ("svoc_torch/csrc/gated_claims_consensus.cu",
                               "svoc_tpu/ops/pallas_consensus.py:411"),
    "grid_copy": ("svoc_torch/csrc/grid_copy.cu", "tools/tpu_probe.py:99"),
}
#: B4's bf16 times (ms) at flash_probe's four shapes with its CUDA-core
#: body, before the tensor-core body: backward_times() run on that
#: body's tree (an NVIDIA H100 80GB HBM3 at 700.00 W).
OLD_DQ_MS = {(256, 128): 1.5497, (8, 512): 0.7043, (8, 2048): 10.8642, (2, 8192): 42.4093}
PROBE_TIMEOUT_S = 120  # each probe of phase 7 (about 10 s each on an H100)
PROBE_RECORDS = ("backend", "grid_copy", "consensus128", "consensus256", "consensus512",
                 "consensus1024", "flash512", "encoder512_dense", "encoder512_flash")

failures: list = []


def check(ok: bool, what: str) -> bool:
    print(("  ok    " if ok else "  FAIL  ") + what, flush=True)
    if not ok:
        failures.append(what)
    return ok


def phase(title: str):
    def wrap(fn):
        def run(*args, **kwargs):
            print(f"== {title}", flush=True)
            try:
                return fn(*args, **kwargs)
            except Exception:  # a phase that raises is a failed phase; the next may still run
                traceback.print_exc()
                failures.append(f"{title}: raised")
                return None
        return run
    return wrap


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "nvidia-smi unavailable"


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


@phase("1. environment and build")
def environment(torch):
    from svoc_torch.ops import _build

    print(f"  card: {nvidia_smi()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = _build.build(KERNELS)
    for name in KERNELS:
        _build.load(name)
    print(f"  kernel build: {time.perf_counter() - t0:.3f} s ({', '.join(KERNELS)})")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")
    return True


@phase("1b. grid copy: kernel vs plain")
def grid_copy_phase(torch, results):
    from svoc_torch.ops.grid_copy import grid_copy_cuda, grid_copy_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = 0.0

    def compare(name, x, block):
        nonlocal worst
        out = grid_copy_cuda(x, block)
        ref = grid_copy_plain(x, block)
        torch.cuda.synchronize()
        bits = {4: torch.int32, 2: torch.int16}[x.element_size()]
        worst = max(worst, (out.float() - x.float()).abs().max().item())
        grid = (x.shape[0], x.shape[1] // block[1], x.shape[2] // block[2])
        check(out.data_ptr() != x.data_ptr() and torch.equal(out.view(bits), x.view(bits))
              and torch.equal(out.view(bits), ref.view(bits)),
              f"{name}: {list(x.shape)} {str(x.dtype)[6:]}, block {block}, grid {grid}: "
              f"kernel == input == plain, bit for bit")

    probe_x = torch.arange(4 * 256 * 128, dtype=torch.float32, device=dev).reshape(4, 256, 128)
    block = (1, 128, 128)
    big = torch.randn(64, 8192, 128, generator=gen, device=dev)
    compare("the probe's shape", probe_x, block)
    compare("256 MiB", big, block)
    compare("an odd block", probe_x, (1, 64, 128))
    compare("bf16", torch.randn(8, 512, 256, generator=gen, device=dev).bfloat16(), (1, 128, 64))
    compare("a narrow block (scalar path)", torch.randn(3, 10, 6, generator=gen, device=dev), (1, 5, 3))

    for name, x, blk in (
        ("a block that does not divide the shape", probe_x, (1, 100, 128)),
        ("a non-contiguous tensor", torch.zeros(4, 128, 256, device=dev).transpose(1, 2), block),
    ):
        before = grid_copy_cuda.launches
        try:
            grid_copy_cuda(x, blk)
            refused = False
        except ValueError:
            refused = True
        check(refused and grid_copy_cuda.launches == before,
              f"refuses {name} with ValueError before any launch")

    card = nvidia_smi()
    for name, x, plain_iters in (("[4, 256, 128]", probe_x, 10), ("[64, 8192, 128]", big, 2)):
        ms = cuda_ms(torch, lambda: grid_copy_cuda(x, block), iters=50)
        plain_ms = cuda_ms(torch, lambda: grid_copy_plain(x, block), iters=plain_iters, warmup=1)
        library_ms = cuda_ms(torch, lambda: x.clone(), iters=50)
        bytes_moved = 2 * x.numel() * x.element_size()
        bound_ms, bound_by = bound(bytes_moved, 0, FP32_FLOPS)
        print(f"  [{card}] {name} f32 times: kernel {ms:.4f} ms ({bytes_moved / ms / 1e9:.3f} TB/s), "
              f"plain {plain_ms:.4f} ms, x.clone() {library_ms:.4f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}; {bytes_moved} bytes)")
        if x is probe_x:  # the shape the probe path gives the kernel
            results["grid_copy"] = dict(
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
            )


def packed_batch(seed: int):
    from svoc_torch.flagship import packed_comment_stream
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS as cfg
    from svoc_torch.models.tokenizer import HashingTokenizer

    tok = HashingTokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=128)
    batch, _ = next(packed_comment_stream(tok, SyntheticSource(batch=256, seed=seed), 256, 128, 8))
    return batch


def small_tags(torch, q, mode, gen):
    """Tags for [B, T] in one of the two mask modes, row 0 dead: sorted
    segment ids 0..3 (0 is padding), or a random key mask."""
    from svoc_torch.ops.flash_attention import attention_tags

    b, t = q.shape[:2]
    if mode == "segments":
        seg = torch.randint(0, 4, (b, t), generator=gen, device=q.device, dtype=torch.int32)
        seg = seg.sort(dim=1).values
        seg[0] = 0
        return attention_tags(q, segment_ids=seg.contiguous())
    kmask = torch.rand(b, t, generator=gen, device=q.device) > 0.3
    kmask[0] = False
    return attention_tags(q, kmask=kmask)


def run_segments(torch, b, t, length, device):
    """Segment ids 1, 2, ... in runs of ``length`` tokens, the last 7
    tokens padding."""
    seg = (torch.arange(t, device=device) // length + 1).expand(b, t).clone()
    seg[:, -7:] = 0
    return seg.to(torch.int32).contiguous()


def range_rule_share(torch, qtag, ktag, tile=64):
    """The share of (query tile, key tile) pairs, ``tile`` rows each, in
    which no key tag lies within the live (> 0) tag range of the query
    tile's rows: what a tile skip by tag range would save."""
    import torch.nn.functional as F

    b, t = qtag.shape
    o = F.pad(qtag, (0, (-t) % tile)).view(b, -1, tile)
    lo = torch.where(o > 0, o, torch.iinfo(torch.int32).max).amin(-1)[:, :, None, None]
    hi = torch.where(o > 0, o, 0).amax(-1)[:, :, None, None]
    st = F.pad(ktag, (0, (-t) % tile)).view(b, 1, -1, tile)
    return 1.0 - ((st >= lo) & (st <= hi)).any(-1).float().mean().item()


@phase("2. flash attention: kernel vs plain")
def flash_phase(torch, results):
    import torch.nn.functional as F

    from svoc_torch.ops.flash_attention import (
        attention_tags, flash_attention_cuda, flash_attention_plain, tag_mask,
    )
    from svoc_torch.tools import flash_probe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, t, h, d, dtype):
        return [torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype) for _ in range(3)]

    # Flagship shape, segment ids of a real packed batch.
    b, t, h, d = 256, 128, 12, 64
    seg = torch.from_numpy(packed_batch(seed=1).seg).to(dev)
    q, k, v = qkv(b, t, h, d, torch.bfloat16)
    qtag, ktag = attention_tags(q, segment_ids=seg)
    out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, qtag, ktag, return_lse=True)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= 3e-2, f"flagship bf16 segments: max |kernel - plain| = {err:.3e} <= 3e-2")
    dead = seg == 0
    check(bool(torch.all(out[dead] == 0)) and bool(torch.all(torch.isneginf(lse[dead]))),
          f"flagship: {int(dead.sum())} padding queries give exactly 0 and lse -inf")
    lse_err = (lse[~dead] - ref_lse[~dead]).abs().max().item()
    check(lse_err <= 1e-4, f"flagship lse: max err {lse_err:.3e} <= 1e-4")

    kmask = seg > 0
    kmask[3] = False  # a row whose every key is masked
    kq, kk = attention_tags(q, kmask=kmask)
    kout = flash_attention_cuda(q, k, v, kq, kk)
    kref = flash_attention_plain(q, k, v, kq, kk)
    torch.cuda.synchronize()
    kerr = (kout.float() - kref.float()).abs().max().item()
    check(kerr <= 3e-2 and bool(torch.all(kout[3] == 0)),
          f"flagship bf16 kmask: max err {kerr:.3e} <= 3e-2, fully masked row exactly 0")

    for hd in (16, 32, 64, 128):
        sq, sk, sv = qkv(2, 77, 3, hd, torch.float32)
        sseg = torch.randint(0, 4, (2, 77), generator=gen, device=dev, dtype=torch.int32).sort(dim=1).values
        a, b_ = attention_tags(sq, segment_ids=sseg)
        so, sl = flash_attention_cuda(sq, sk, sv, a, b_, return_lse=True)
        ro, rl = flash_attention_plain(sq, sk, sv, a, b_, return_lse=True)
        torch.cuda.synchronize()
        live = torch.isfinite(rl)
        e_out = (so - ro).abs().max().item()
        e_lse = (sl[live] - rl[live]).abs().max().item()
        check(e_out <= 2e-5 and e_lse <= 2e-5 and torch.equal(live, torch.isfinite(sl)),
              f"f32 [2, 77, 3, {hd}] segments: out err {e_out:.3e}, lse err {e_lse:.3e} <= 2e-5")

    # bf16 (the tensor-core body) at every head width, T from one token to
    # 16 key tiles, both mask modes: 3e-2, lse 1e-3, dead rows exactly 0
    # with lse -inf, two launches bit for bit the same.
    for hd in (16, 32, 64, 128):
        for t_ in (1, 77, 1000):
            errs, ok = [], True
            for mode in ("segments", "kmask"):
                sq, sk, sv = qkv(3, t_, 2, hd, torch.bfloat16)
                a, b_ = small_tags(torch, sq, mode, gen)
                so, sl = flash_attention_cuda(sq, sk, sv, a, b_, return_lse=True)
                so2, sl2 = flash_attention_cuda(sq, sk, sv, a, b_, return_lse=True)
                ro, rl = flash_attention_plain(sq, sk, sv, a, b_, return_lse=True)
                torch.cuda.synchronize()
                live = torch.isfinite(rl)
                errs += [(so.float() - ro.float()).abs().max().item(),
                         (sl[live] - rl[live]).abs().max().item() if bool(live.any()) else 0.0]
                ok &= (errs[-2] <= 3e-2 and errs[-1] <= 1e-3 and torch.equal(live, torch.isfinite(sl))
                       and bool(torch.all(so[~live] == 0)) and bool(torch.all(so[0] == 0))
                       and torch.equal(so, so2) and torch.equal(sl, sl2))
            check(ok, "bf16 [3, {}, 2, {}]: segments out err {:.3e}, lse err {:.3e}; kmask out err "
                      "{:.3e}, lse err {:.3e}; dead rows 0 and -inf; two launches equal".format(t_, hd, *errs))

    # T = 1000 as one segment (every pair live) and in runs of 50 tokens
    # (most pairs masked).
    for kind in ("one segment", "runs of 50"):
        sq, sk, sv = qkv(2, 1000, 3, 64, torch.bfloat16)
        seg_ = run_segments(torch, 2, 1000, 1000 if kind == "one segment" else 50, dev)
        a, b_ = attention_tags(sq, segment_ids=seg_)
        so, sl = flash_attention_cuda(sq, sk, sv, a, b_, return_lse=True)
        ro, rl = flash_attention_plain(sq, sk, sv, a, b_, return_lse=True)
        torch.cuda.synchronize()
        live = torch.isfinite(rl)
        e_out = (so.float() - ro.float()).abs().max().item()
        e_lse = (sl[live] - rl[live]).abs().max().item()
        check(e_out <= 3e-2 and e_lse <= 1e-3 and torch.equal(live, torch.isfinite(sl)),
              f"bf16 [2, 1000, 3, 64], {kind}: out err {e_out:.3e}, lse err {e_lse:.3e}")
    print(f"  flagship: a tag-range skip would save {100 * range_rule_share(torch, qtag, ktag):.1f} % "
          f"of the 64 x 64 (query tile, key tile) pairs; the kernels visit every tile")

    # Times at the flagship shape, main-path call (no lse).
    ms = cuda_ms(torch, lambda: flash_attention_cuda(q, k, v, qtag, ktag))
    plain_ms = cuda_ms(torch, lambda: flash_attention_plain(q, k, v, qtag, ktag), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    live = tag_mask(qtag, ktag)
    mask = live[:, None]
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    live_pairs = int(live.sum())
    bytes_moved = 4 * q.numel() * q.element_size() + 2 * qtag.numel() * 4
    bound_ms, bound_by = bound(bytes_moved, 4 * d * h * live_pairs, BF16_FLOPS)
    print(f"  flagship times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{bytes_moved} bytes, {live_pairs} live pairs)")
    results["flash_attention"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )

    # Times at flash_probe's four shapes, every key live, by CUDA events;
    # SDPA without a mask (the same function here) and under an all-ones
    # boolean mask (as at the flagship shape). B1 is timed twice, before
    # and after SDPA, over at least 2 ms of launches each.
    card = nvidia_smi()
    for b, t in flash_probe.SHAPES:
        q, k, v = qkv(b, t, h, d, torch.bfloat16)
        ones = torch.ones(b, t, dtype=torch.int32, device=dev)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = torch.ones(b, 1, 1, t, dtype=torch.bool, device=dev)
        iters = 100 if t <= 2048 else 20
        first_ms = cuda_ms(torch, lambda: flash_attention_cuda(q, k, v, ones, ones), iters=iters)
        sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=iters)
        masked_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                            iters=iters)
        ms = cuda_ms(torch, lambda: flash_attention_cuda(q, k, v, ones, ones), iters=iters)
        bytes_moved = 4 * q.numel() * q.element_size() + 2 * ones.numel() * 4
        bound_ms, bound_by = bound(bytes_moved, 4 * d * h * b * t * t, BF16_FLOPS)
        print(f"  [{card}] B1 [{b}, {t}, 12, 64] bf16, all live: kernel {first_ms:.4f} ms before SDPA, "
              f"{ms:.4f} ms after ({iters} launches each), SDPA {sdpa_ms:.4f} ms (all-ones mask "
              f"{masked_ms:.4f} ms), bound {bound_ms:.4f} ms ({bound_by})")
        del qt, kt, vt


@phase("2b. flash backward: kernels vs plain")
def flash_bwd_phase(torch, results):
    import torch.nn.functional as F

    from svoc_torch.ops.flash_attention import (
        attention_delta, attention_tags, flash_attention_bwd_plain, flash_attention_cuda,
        flash_dkv_cuda, flash_dq_cuda, tag_mask,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def normal(b, t, h, d, dtype):
        return torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)

    def run(q, k, v, qtag, ktag, dout, atol, rtol):
        """Both kernels and the plain backward's fp32 result (the plain
        arithmetic before its cast to q's dtype) on one input: the
        kernels' outputs, each one's max |kernel - plain|, whether every
        element is within atol + rtol * |plain|, and the largest |plain|."""
        out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
        delta = attention_delta(out, dout)
        got = (flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta),
               *flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta))
        ref = flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), qtag, ktag, out.float(), lse, dout.float())
        torch.cuda.synchronize()
        errs, ok = [], True
        for g, r in zip(got, ref):
            diff = (g.float() - r).abs()
            errs.append(diff.max().item())
            ok &= bool(torch.all(diff <= atol + rtol * r.abs()))
        return got, errs, ok, max(r.abs().max().item() for r in ref)

    # Flagship shape, segment ids of a real packed batch.
    b, t, h, d = 256, 128, 12, 64
    seg = torch.from_numpy(packed_batch(seed=1).seg).to(dev)
    q, k, v, dout = (normal(b, t, h, d, torch.bfloat16) for _ in range(4))
    qtag, ktag = attention_tags(q, segment_ids=seg)
    bf16_rtol = 2.0 ** -8  # one bf16 rounding of the kernel's output
    (dq, dk, dv), errs, ok, peak = run(q, k, v, qtag, ktag, dout, 3e-2, bf16_rtol)
    check(ok, "flagship bf16 segments: max |kernel - plain| dq {:.3e}, dk {:.3e}, dv {:.3e} "
              "<= 3e-2 + 2^-8 |plain| (max |plain| {:.3f})".format(*errs, peak))
    pad = seg == 0
    check(bool(torch.all(dq[pad] == 0) and torch.all(dk[pad] == 0) and torch.all(dv[pad] == 0)),
          f"flagship: dq, dk and dv of all {int(pad.sum())} padding tokens exactly 0")
    out_, lse_ = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    again = flash_dq_cuda(q, k, v, qtag, ktag, dout, lse_, attention_delta(out_, dout))
    check(torch.equal(again, dq), "flagship: dq of two launches bit for bit equal")

    kmask = seg > 0
    kmask[3] = False  # a row whose every key is masked
    kq, kk = attention_tags(q, kmask=kmask)
    (kdq, kdk, kdv), kerrs, kok, kpeak = run(q, k, v, kq, kk, dout, 3e-2, bf16_rtol)
    check(kok and bool(torch.all(kdq[3] == 0))
          and bool(torch.all(kdk[~kmask] == 0) and torch.all(kdv[~kmask] == 0)),
          "flagship bf16 kmask: max err dq {:.3e}, dk {:.3e}, dv {:.3e} (max |plain| {:.3f}); "
          "fully masked row's dq and masked keys' dk, dv exactly 0".format(*kerrs, kpeak))

    for hd in (16, 32, 64, 128):
        sq, sk, sv, sdo = (normal(2, 77, 3, hd, torch.float32) for _ in range(4))
        sseg = torch.randint(0, 4, (2, 77), generator=gen, device=dev, dtype=torch.int32).sort(dim=1).values
        a, b_ = attention_tags(sq, segment_ids=sseg)
        (gq, gk, gv), ferrs, fok, _ = run(sq, sk, sv, a, b_, sdo, 1e-4, 0.0)
        dead = sseg == 0
        check(fok and bool(torch.all(gq[dead] == 0) and torch.all(gk[dead] == 0)
                           and torch.all(gv[dead] == 0)),
              "f32 [2, 77, 3, {}] segments: dq {:.3e}, dk {:.3e}, dv {:.3e} <= 1e-4; "
              "padding exactly 0".format(hd, *ferrs))

    # bf16 (dq and dk/dv through the tensor-core bodies) at every head
    # width, T from one token to 16 tiles, both mask modes; dead keys and
    # rows exactly 0, two launches bit for bit the same; then T = 1000 as
    # one segment and in runs of 50 tokens.
    for hd in (16, 32, 64, 128):
        for t_ in (1, 77, 1000):
            case_errs, ok = [], True
            for mode in ("segments", "kmask"):
                sq, sk, sv, sdo = (normal(3, t_, 2, hd, torch.bfloat16) for _ in range(4))
                a, b_ = small_tags(torch, sq, mode, gen)
                (gq, gk, gv), berrs, bok, _ = run(sq, sk, sv, a, b_, sdo, 3e-2, bf16_rtol)
                out_, lse_ = flash_attention_cuda(sq, sk, sv, a, b_, return_lse=True)
                delta_ = attention_delta(out_, sdo)
                again = (flash_dq_cuda(sq, sk, sv, a, b_, sdo, lse_, delta_),
                         *flash_dkv_cuda(sq, sk, sv, a, b_, sdo, lse_, delta_))
                torch.cuda.synchronize()
                dead_k, dead_q = b_ == 0, ~torch.isfinite(lse_).all(dim=-1)
                case_errs += berrs
                ok &= (bok and all(torch.equal(x, y) for x, y in zip(again, (gq, gk, gv)))
                       and bool(torch.all(gk[dead_k] == 0) and torch.all(gv[dead_k] == 0)
                                and torch.all(gq[dead_q] == 0)))
            check(ok, "bf16 [3, {}, 2, {}]: segments dq {:.3e}, dk {:.3e}, dv {:.3e}; kmask dq {:.3e}, "
                      "dk {:.3e}, dv {:.3e} <= 3e-2 + 2^-8 |plain|; dead keys' dk, dv and dead rows' dq "
                      "exactly 0; dq, dk, dv of two launches equal".format(t_, hd, *case_errs))
    for kind in ("one segment", "runs of 50"):
        sq, sk, sv, sdo = (normal(2, 1000, 3, 64, torch.bfloat16) for _ in range(4))
        seg_ = run_segments(torch, 2, 1000, 1000 if kind == "one segment" else 50, dev)
        a, b_ = attention_tags(sq, segment_ids=seg_)
        _, berrs, bok, _ = run(sq, sk, sv, a, b_, sdo, 3e-2, bf16_rtol)
        check(bok, "bf16 [2, 1000, 3, 64], {}: dq {:.3e}, dk {:.3e}, dv {:.3e}".format(kind, *berrs))

    # Times at the flagship shape, main-path calls.
    out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    delta = attention_delta(out, dout)
    dq_ms = cuda_ms(torch, lambda: flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta))
    dkv_ms = cuda_ms(torch, lambda: flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta))
    plain_ms = cuda_ms(
        torch, lambda: flash_attention_bwd_plain(q, k, v, qtag, ktag, out, lse, dout), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    live = tag_mask(qtag, ktag)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=live[:, None])
    dout_t = dout.transpose(1, 2).contiguous()
    library_ms = cuda_ms(
        torch, lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t, retain_graph=True))
    live_pairs = int(live.sum())
    tensor_bytes = q.numel() * q.element_size()
    reads = 4 * tensor_bytes + 2 * lse.numel() * 4 + 2 * qtag.numel() * 4  # q, k, v, dO, lse, delta, tags
    for name, ms, writes, flops in (
        ("flash_dq", dq_ms, 1, 6), ("flash_dkv", dkv_ms, 2, 8),
    ):
        bytes_moved = reads + writes * tensor_bytes
        bound_ms, bound_by = bound(bytes_moved, flops * d * h * live_pairs, BF16_FLOPS)
        print(f"  flagship {name}: kernel {ms:.4f} ms, plain backward {plain_ms:.4f} ms, "
              f"SDPA backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{bytes_moved} bytes, {live_pairs} live pairs)")
        results[name] = dict(
            max_abs_err=errs[0] if name == "flash_dq" else max(errs[1:]), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        )

    backward_times(torch)


def backward_times(torch):
    """B4 (dq) and B5 (dk/dv) at flash_probe's four shapes (bf16, 12 heads
    of 64, every key live) by CUDA events, beside SDPA's whole backward
    (no mask: the same function here) and each kernel's bound; B4's
    CUDA-core times from before its tensor-core body in brackets. Imports
    ``svoc_torch`` from ``sys.path``, so it times whichever tree comes
    first there."""
    import torch.nn.functional as F

    from svoc_torch.ops.flash_attention import (
        attention_delta, flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda,
    )
    from svoc_torch.tools import flash_probe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    h, d = 12, 64
    card = nvidia_smi()
    for b, t in flash_probe.SHAPES:
        q, k, v, dout = (torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16() for _ in range(4))
        ones = torch.ones(b, t, dtype=torch.int32, device=dev)
        out, lse = flash_attention_cuda(q, k, v, ones, ones, return_lse=True)
        delta = attention_delta(out, dout)
        iters = 20 if t <= 2048 else 5
        dq_ms = cuda_ms(torch, lambda: flash_dq_cuda(q, k, v, ones, ones, dout, lse, delta), iters=iters)
        ms = cuda_ms(torch, lambda: flash_dkv_cuda(q, k, v, ones, ones, dout, lse, delta), iters=iters)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
        dout_t = dout.transpose(1, 2).contiguous()
        library_ms = cuda_ms(
            torch, lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t, retain_graph=True),
            iters=iters)
        tensor_bytes = q.numel() * q.element_size()
        reads = 4 * tensor_bytes + 2 * lse.numel() * 4 + 2 * ones.numel() * 4
        dq_bound, dq_by = bound(reads + tensor_bytes, 6 * d * h * b * t * t, BF16_FLOPS)
        bound_ms, bound_by = bound(reads + 2 * tensor_bytes, 8 * d * h * b * t * t, BF16_FLOPS)
        print(f"  [{card}] [{b}, {t}, 12, 64] bf16, all live: B4 {dq_ms:.4f} ms "
              f"[CUDA cores before: {OLD_DQ_MS.get((b, t), 'not measured')}], bound {dq_bound:.4f} ms "
              f"({dq_by}); B5 {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); SDPA backward "
              f"{library_ms:.4f} ms")
        del out, qt, kt, vt, sdpa_out


@phase("2c. flash against dense attention (flash_probe)")
def flash_dense_phase(torch):
    import torch.nn.functional as F

    from svoc_torch.tools import flash_probe

    dev = torch.device("cuda")
    verdict = flash_probe.parity_only()
    check(verdict["verdict"] == "rounding-equivalent" and len(verdict["entries"]) == 2,
          "parity_only: " + "; ".join(
              f"[{e['b']}, {e['t']}] flash err {e['err_flash_vs_f32_truth']:.4f}, dense err "
              f"{e['err_dense_vs_f32_truth']:.4f}, bound {e['bound']:.4f}" for e in verdict["entries"])
          + f": verdict {verdict['verdict']}")
    entries = flash_probe.main()
    check([(e["b"], e["t"]) for e in entries] == list(flash_probe.SHAPES),
          f"flash_probe.main: {len(entries)} shapes, forward and backward")
    on_disk = [json.loads(Path(name).read_text()) for name in
               ("FLASH_PROBE_GPU.json", "FLASH_PARITY_GPU.json")]
    check(on_disk[0] == entries and on_disk[1]["verdict"] == verdict["verdict"],
          "FLASH_PROBE_GPU.json and FLASH_PARITY_GPU.json readable and current")
    card = nvidia_smi()
    for e in entries:
        b, t = e["b"], e["t"]
        # Two bf16 results of magnitude up to 8 (ulp 2^-5) may differ by
        # two ulps forward (one measured); the backward sums three such
        # gradients (0.094 measured at T = 8192 on an NVIDIA H100 80GB HBM3).
        check(e["max_abs_diff"] <= 2 * 2.0 ** -5 and e["bwd_max_abs_diff"] <= 0.125
              and all(math.isfinite(e[k]) and e[k] > 0 for k in
                      ("dense_ms", "flash_ms", "dense_bwd_ms", "flash_bwd_ms")),
              f"[{b}, {t}, 12, 64] bf16: flash vs dense max diff forward {e['max_abs_diff']:.5f} "
              f"<= 0.0625, backward {e['bwd_max_abs_diff']:.5f} <= 0.125")
        # The library yardstick by the same protocol, on inputs of the
        # same shape, under the same all-ones key mask.
        qs = [torch.randn(b, flash_probe.HEADS, t, flash_probe.HEAD_DIM, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(i)).bfloat16()
              for i in range(4)]
        mask = torch.ones(b, 1, 1, t, dtype=torch.bool, device=dev)

        def sdpa(q):
            return F.scaled_dot_product_attention(q, q, q, attn_mask=mask)

        def sdpa_grad(q):
            q = q.detach().requires_grad_()
            return torch.autograd.grad(sdpa(q).float().sum(), q)[0]

        with torch.inference_mode():
            sdpa_ms = flash_probe.amortized_ms(lambda i: sdpa(qs[i % 4]), n=12)
        sdpa_bwd_ms = flash_probe.amortized_ms(lambda i: sdpa_grad(qs[i % 4]), n=12)
        print(f"  [{card}] [{b}, {t}, 12, 64] bf16 forward: flash {e['flash_ms']:.3f} ms "
              f"(peak {e['flash_peak_gib']} GiB), dense {e['dense_ms']:.3f} ms (peak "
              f"{e['dense_peak_gib']} GiB), SDPA {sdpa_ms:.3f} ms; forward + backward: flash "
              f"{e['flash_bwd_ms']:.3f} ms (peak {e['flash_bwd_peak_gib']} GiB), dense "
              f"{e['dense_bwd_ms']:.3f} ms (peak {e['dense_bwd_peak_gib']} GiB), SDPA "
              f"{sdpa_bwd_ms:.3f} ms; first calls {e['flash_first_call_s']} s, "
              f"{e['flash_bwd_first_call_s']} s")
        del qs, mask
        torch.cuda.empty_cache()


@phase("3. fused consensus: kernel vs plain")
def consensus_phase(torch, results):
    from svoc_torch.consensus.kernel import ConsensusConfig
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0

    def compare(name, values, cfg):
        nonlocal worst
        out = fused_consensus_cuda(values, cfg)
        ref = fused_consensus_plain(values, cfg)
        torch.cuda.synchronize()
        errs = {f: (getattr(out, f) - getattr(ref, f)).abs().max().item() for f in (
            "essence", "essence_first_pass", "quadratic_risk", "reliability_first_pass",
            "reliability_second_pass", "skewness", "kurtosis")}
        worst = max(worst, *(errs[f] for f in ("essence", "essence_first_pass", "quadratic_risk")))
        ok = (torch.equal(out.reliable, ref.reliable)
              and all(errs[f] <= 1e-5 for f in list(errs)[:5])
              and errs["skewness"] <= 1e-4 and errs["kurtosis"] <= 1e-3)
        check(ok, f"{name}: mask exact, " + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()))

    flagship = ConsensusConfig(n_failing=128, constrained=True)
    uniform = 0.01 + 0.98 * torch.rand(1024, 6, generator=gen, device=dev)
    compare("N=1024 constrained", uniform, flagship)
    compare("N=1024 unconstrained",
            20.0 + 3.0 * torch.randn(1024, 6, generator=gen, device=dev),
            ConsensusConfig(n_failing=128, constrained=False))
    ties = torch.round(torch.rand(1024, 6, generator=gen, device=dev) * 100) / 100
    compare("N=1024 quantised to 1e-2 (ties)", ties.contiguous(), flagship)
    # Every row equal (3/8: every sum exact, so the moments of a constant
    # column are exact too), and values from {-0.0, +0.0, 0.25, 0.5}.
    compare("N=1024 all rows equal", torch.full((1024, 6), 0.375, device=dev), flagship)
    zeros = torch.tensor([-0.0, 0.0, 0.25, 0.5], device=dev)
    signed = zeros[torch.randint(0, 4, (1024, 6), generator=gen, device=dev)].contiguous()
    compare("N=1024 -0.0 and +0.0 mixed", signed, flagship)
    compare("N=7", torch.rand(7, 6, generator=gen, device=dev), ConsensusConfig(n_failing=2))
    compare("N=1000", torch.rand(1000, 6, generator=gen, device=dev), ConsensusConfig(n_failing=125))

    ms = cuda_ms(torch, lambda: fused_consensus_cuda(uniform, flagship), iters=200)
    plain_ms = cuda_ms(torch, lambda: fused_consensus_plain(uniform, flagship), iters=10)
    n, m = uniform.shape
    bytes_moved = 4 * (n * m + 2 * m + 2 + n + n + 2 * m)
    ops = (4 * m + 1) * n + 12 * n * m  # each of the 4M + 1 ranks reads every key once; moments
    bound_ms, bound_by = bound(bytes_moved, ops, FP32_FLOPS)
    print(f"  [{nvidia_smi()}] N=1024 times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by})")
    results["fused_consensus"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
    )


GATED_FLOATS = ("essence", "essence_first_pass", "reliability_first_pass",
                "reliability_second_pass")


def gated_errors(torch, out, ref):
    """Whether a claim-cube output meets the reference's bars against
    ``ref``, and its errors: reliable and interval_valid exact; the
    floats and the finite risks within 1e-5, infinite risks equal;
    skewness within 1e-4; kurtosis within 1e-3."""
    errs = {f: (getattr(out, f) - getattr(ref, f)).abs().max().item() for f in GATED_FLOATS}
    inf = torch.isinf(ref.quadratic_risk)
    errs["finite risk"] = ((out.quadratic_risk[~inf] - ref.quadratic_risk[~inf]).abs().max().item()
                           if bool((~inf).any()) else 0.0)
    errs["skewness"] = (out.skewness - ref.skewness).abs().max().item()
    errs["kurtosis"] = (out.kurtosis - ref.kurtosis).abs().max().item()
    ok = (torch.equal(out.reliable, ref.reliable)
          and torch.equal(out.interval_valid, ref.interval_valid)
          and torch.equal(torch.isinf(out.quadratic_risk), inf)
          and torch.equal(out.quadratic_risk[inf], ref.quadratic_risk[inf])
          and all(errs[f] <= 1e-5 for f in (*GATED_FLOATS, "finite risk"))
          and errs["skewness"] <= 1e-4 and errs["kurtosis"] <= 1e-3)
    return ok, errs, int(inf.sum())


def host_s(torch, fn, iters: int = 20) -> float:
    """Mean host time of ``fn`` (which ends in a fetch to the host) over
    ``iters`` calls after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


@phase("3b. gated claim-cube consensus: kernel vs plain")
def gated_claims_phase(torch, results):
    import numpy as np

    from svoc_torch.consensus.batch import pad_claim_cube
    from svoc_torch.consensus.kernel import ConsensusConfig
    from svoc_torch.ops.fused_consensus import (
        fused_consensus_gated_claims_cuda, fused_consensus_gated_claims_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0

    def compare(name, values, ok, cfg):
        nonlocal worst
        values, ok, mask = (t.to(dev) for t in pad_claim_cube(values, ok))
        out = fused_consensus_gated_claims_cuda(values, ok, mask, cfg)
        ref = fused_consensus_gated_claims_plain(values, ok, mask, cfg)
        torch.cuda.synchronize()
        good, errs, n_inf = gated_errors(torch, out, ref)
        worst = max(worst, *(errs[f] for f in ("essence", "essence_first_pass", "finite risk")))
        check(good, f"{name}: reliable and interval_valid exact, {n_inf} infinite risks equal, "
                    + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()))
        return out, mask

    # bench.py --claims 64 --claims-oracles 1024 (bench.py:2587-2629).
    rng = np.random.default_rng(0)
    bench = rng.uniform(0.0, 1.0, size=(CLAIMS, ORACLES, 6)).astype(np.float32)
    bench_ok = np.ones((CLAIMS, ORACLES), dtype=bool)
    bench_ok[:: max(1, CLAIMS // 8), -1] = False
    bench_cfg = ConsensusConfig(n_failing=256, constrained=True)
    compare("bench_claims cube [64, 1024, 6], n_failing 256", bench, bench_ok, bench_cfg)

    for n in (1024, 7):
        values = torch.rand(4, n, 6, generator=gen, device=dev)
        ok = torch.ones(4, n, dtype=torch.bool, device=dev)
        ok[1, : max(1, n // 4)] = False
        values[1, 0] = float("nan")
        ok[2] = False
        ok[3, : n - 1] = False
        cfg = ConsensusConfig(n_failing=max(2, n // 8))
        out, _ = compare(f"degenerate spectrum N={n}", values, ok, cfg)
        check(not bool(out.interval_valid[2:].any()) and bool(torch.isinf(out.quadratic_risk[2]).all())
              and bool((out.essence[2:] == 0).all()) and bool((out.essence_first_pass[2] == 0).all()),
              f"N={n}: all-quarantined and single-survivor claims invalid, "
              f"risks +inf with n_ok = 0, essences zeroed")
        out, mask = compare(f"degenerate spectrum N={n}, 3 claims padded to 4", values[:3], ok[:3], cfg)
        check(not bool(mask[3]) and not bool(out.interval_valid[3]) and not bool(out.reliable[3].any())
              and bool((out.essence[3] == 0).all()) and bool((out.quadratic_risk[3] == 0).all()),
              f"N={n}: the padding claim comes back inactive")

    ties = torch.round(torch.rand(CLAIMS, ORACLES, 6, generator=gen, device=dev) * 100) / 100
    tie_ok = torch.rand(CLAIMS, ORACLES, generator=gen, device=dev) > 0.02
    compare("[64, 1024, 6] quantised to 1e-2 (ties)", ties, tie_ok, ConsensusConfig(n_failing=128))
    unc = 20.0 + 3.0 * torch.randn(16, ORACLES, 6, generator=gen, device=dev)
    compare("[16, 1024, 6] unconstrained", unc, tie_ok[:16],
            ConsensusConfig(n_failing=128, constrained=False))

    values, ok, mask = (t.to(dev) for t in pad_claim_cube(bench, bench_ok))
    for name, args in (
        ("smooth_mode 'true'", (values, ok, mask, ConsensusConfig(smooth_mode="true"))),
        ("a [2, 8192, 6] cube beyond shared memory",
         (torch.zeros(2, 8192, 6, device=dev), torch.ones(2, 8192, dtype=torch.bool, device=dev),
          mask[:2], bench_cfg)),
    ):
        before = fused_consensus_gated_claims_cuda.launches
        try:
            fused_consensus_gated_claims_cuda(*args)
            refused = False
        except ValueError:
            refused = True
        check(refused and fused_consensus_gated_claims_cuda.launches == before,
              f"refuses {name} with ValueError before any launch")

    ms = cuda_ms(torch, lambda: fused_consensus_gated_claims_cuda(values, ok, mask, bench_cfg), iters=50)
    plain_ms = cuda_ms(
        torch, lambda: fused_consensus_gated_claims_plain(values, ok, mask, bench_cfg), iters=10)
    c, n, m = values.shape
    out = fused_consensus_gated_claims_cuda(values, ok, mask, bench_cfg)
    bytes_moved = sum(t.numel() * t.element_size() for t in (values, ok, mask, *out))
    sorts = 2 * m + 1  # constrained: the first pass, the ranking, the second pass
    ops = c * (sorts * n * math.ceil(math.log2(n)) + 12 * n * m)
    bound_ms, bound_by = bound(bytes_moved, ops, FP32_FLOPS)

    # bench_claims's batched-against-sequential comparison (bench.py:2666-2700):
    # one launch over the cube, or one launch per claim, each ending in
    # a fetch of the essences' sum to the host.
    per_claim = [(values[i: i + 1], ok[i: i + 1], mask[i: i + 1]) for i in range(c)]
    batched_s = host_s(
        torch, lambda: fused_consensus_gated_claims_cuda(values, ok, mask, bench_cfg).essence.sum().item())
    sequential_s = host_s(torch, lambda: sum(
        fused_consensus_gated_claims_cuda(*a, bench_cfg).essence.sum() for a in per_claim).item())
    seq_ms = cuda_ms(torch, lambda: [fused_consensus_gated_claims_cuda(*a, bench_cfg) for a in per_claim],
                     iters=10)
    print(f"  [{nvidia_smi()}] [64, 1024, 6] times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}; {bytes_moved} bytes, {ops} operations); "
          f"64 one-claim launches {seq_ms:.4f} ms (CUDA events)")
    print(f"  claims/s with a host fetch: batched {c / batched_s:.1f} ({batched_s * 1e3:.4f} ms), "
          f"sequential {c / sequential_s:.1f} ({sequential_s * 1e3:.4f} ms), "
          f"ratio {sequential_s / batched_s:.2f}")
    results["gated_claims_consensus"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
    )


@phase("4a. small serving step: card vs CPU")
def small_step_phase(torch):
    from svoc_torch.flagship import FlagshipStep
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.models.encoder import init_params

    params = init_params(TINY_TEST, seed=3, device="cpu")
    kw = dict(rows=16, seq=32, max_seg=4, n_oracles=64, params_dtype=None, params=params)
    for variant in ("packed_flash", "packed", "dense"):
        card = FlagshipStep(TINY_TEST, variant=variant, device="cuda", **kw)
        cpu = FlagshipStep(TINY_TEST, variant=variant, device="cpu", **kw)
        batch, _ = next(card.comments(SyntheticSource(batch=16, seed=5)))
        draws = card.draws(torch.Generator(device="cuda").manual_seed(1))
        w_card, w_cpu = card.window(batch), cpu.window(batch)
        out_card, _ = card.consensus(w_card, draws)
        out_cpu, _ = cpu.consensus(w_cpu, type(draws)(*(x.cpu() for x in draws)))
        w_err = (w_card.cpu() - w_cpu).abs().max().item()
        e_err = (out_card.essence.cpu() - out_cpu.essence).abs().max().item()
        check(w_err <= 1e-4,
              f"TINY_TEST f32 {variant} window: card vs CPU max err {w_err:.3e} <= 1e-4")
        check(torch.equal(out_card.reliable.cpu(), out_cpu.reliable) and e_err <= 1e-5,
              f"TINY_TEST {variant} consensus: mask exact, essence err {e_err:.3e} <= 1e-5")


@phase("4b. main path: full-width packed-flash serving step")
def main_path_phase(torch, launches):
    from svoc_torch.flagship import FlagshipStep
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.ops.flash_attention import flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_plain
    from svoc_torch.sim.oracle import assemble_fleet

    step = FlagshipStep(device="cuda")  # ROBERTA_GO_EMOTIONS, bf16 weights
    n_layers = step.pipe.cfg.n_layers
    feed = step.comments(SyntheticSource(batch=256, seed=0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()

    for wrapper in (flash_attention_cuda, fused_consensus_cuda, flash_dq_cuda, flash_dkv_cuda):
        wrapper.launches = 0
    essences, rows = [], []
    for i in range(1 + MAIN_STEPS):
        t0 = time.perf_counter()
        batch, n_comments = next(feed)
        t1 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        window = step.window(batch)
        ev[1].record()
        out, honest = step.consensus(window, step.draws(gen))
        ev[2].record()
        essence = out.essence.cpu()  # fetched to the host: the step is done
        t2 = time.perf_counter()
        essences.append(tuple(essence.tolist()))
        rows.append(dict(feed_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
                         forward_ms=ev[0].elapsed_time(ev[1]),
                         consensus_ms=ev[1].elapsed_time(ev[2]), comments=n_comments))
    launches["flash_attention"] = flash_attention_cuda.launches
    launches["fused_consensus"] = fused_consensus_cuda.launches
    backward = (flash_dq_cuda.launches, flash_dkv_cuda.launches)

    steps = 1 + MAIN_STEPS
    check(launches["flash_attention"] == n_layers * steps,
          f"flash kernel launches {launches['flash_attention']} == {n_layers} x {steps} steps")
    check(launches["fused_consensus"] == steps,
          f"consensus kernel launches {launches['fused_consensus']} == {steps} steps")
    check(backward == (0, 0), f"backward kernel launches while serving (dq, dk/dv) {backward} == (0, 0)")
    check(len(set(essences)) == steps, f"{steps} distinct essences on distinct batches")
    e = torch.tensor(essences)
    check(bool(torch.isfinite(e).all()) and e.shape == (steps, 6),
          f"essences finite, shape {tuple(e.shape)}")
    check(int(out.reliable.sum()) == 1024 - step.ccfg.n_failing and honest.shape == (1024,),
          f"last step: {int(out.reliable.sum())} reliable of 1024")
    values, _ = assemble_fleet(window, *step.draws(torch.Generator(device="cuda").manual_seed(99)))
    ref = fused_consensus_plain(values, step.ccfg)
    got = fused_consensus_cuda(values.contiguous(), step.ccfg)
    check(torch.equal(ref.reliable, got.reliable)
          and (ref.essence - got.essence).abs().max().item() <= 1e-5,
          "a full-width fleet of the last window: kernel consensus == plain")

    timed = rows[1:]
    mean = lambda key: sum(r[key] for r in timed) / len(timed)  # noqa: E731
    n_comments = sum(r["comments"] for r in timed)
    wall_s = sum(r["feed_ms"] + r["step_ms"] for r in timed) / 1e3
    device_s = sum(r["step_ms"] for r in timed) / 1e3
    card = nvidia_smi()
    print(f"  [{card}] {len(timed)} timed steps: step {mean('step_ms'):.3f} ms "
          f"(forward {mean('forward_ms'):.3f} ms, consensus {mean('consensus_ms'):.3f} ms), "
          f"host feed {mean('feed_ms'):.3f} ms")
    print(f"  [{card}] {n_comments / len(timed):.1f} comments/step: "
          f"{n_comments / device_s:.1f} comments/s over the step, "
          f"{n_comments / wall_s:.1f} comments/s with the serial host feed")
    print("  per step: " + json.dumps(rows))
    batch, _ = next(feed)
    profile_one_step(torch, lambda: step(batch, gen)[0].essence.cpu())


@phase("4c. the packed and dense flagship variants at full width")
def variants_phase(torch, launches):
    import numpy as np

    from svoc_torch.flagship import FlagshipStep, TokenBatch
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS
    from svoc_torch.models.encoder import init_params
    from svoc_torch.models.packing import pack_tokens, strip_padding
    from svoc_torch.ops.flash_attention import flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda

    # One set of bf16 weights (seed 0, as phase 4b draws them) under all
    # three variants.
    params = {k: v.bfloat16() for k, v in
              init_params(ROBERTA_GO_EMOTIONS, seed=0, device="cuda").items()}
    steps = {v: FlagshipStep(variant=v, params=params, device="cuda")
             for v in ("packed_flash", "packed", "dense")}
    counted = (flash_attention_cuda, fused_consensus_cuda, flash_dq_cuda, flash_dkv_cuda)
    card = nvidia_smi()
    for variant in ("packed", "dense"):
        step = steps[variant]
        feed = step.comments(SyntheticSource(batch=256, seed=0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        for wrapper in counted:
            wrapper.launches = 0
        essences, rows = [], []
        for _ in range(1 + MAIN_STEPS):
            t0 = time.perf_counter()
            batch, n_comments = next(feed)
            t1 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            window = step.window(batch)
            ev[1].record()
            out, _ = step.consensus(window, step.draws(gen))
            ev[2].record()
            essences.append(tuple(out.essence.cpu().tolist()))  # on the host: the step is done
            t2 = time.perf_counter()
            rows.append(dict(feed_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
                             forward_ms=ev[0].elapsed_time(ev[1]),
                             consensus_ms=ev[1].elapsed_time(ev[2]), comments=n_comments))
        counts = [w.launches for w in counted]
        launches["fused_consensus"] = launches.get("fused_consensus", 0) + counts[1]
        steps_run = 1 + MAIN_STEPS
        check(counts == [0, steps_run, 0, 0],
              f"{variant}: launches (flash, consensus, dq, dk/dv) {counts} == [0, {steps_run}, 0, 0]")
        e = torch.tensor(essences)
        check(len(set(essences)) == steps_run and bool(torch.isfinite(e).all())
              and int(out.reliable.sum()) == 1024 - step.ccfg.n_failing,
              f"{variant}: {steps_run} distinct finite essences on distinct batches, "
              f"{int(out.reliable.sum())} reliable of 1024")
        timed = rows[1:]
        mean = lambda key: sum(r[key] for r in timed) / len(timed)  # noqa: E731
        n_comments = sum(r["comments"] for r in timed)
        print(f"  [{card}] {variant}: {len(timed)} timed steps: step {mean('step_ms'):.3f} ms "
              f"(forward {mean('forward_ms'):.3f} ms, consensus {mean('consensus_ms'):.3f} ms), "
              f"host feed {mean('feed_ms'):.3f} ms; {n_comments / len(timed):.1f} comments/step, "
              f"{n_comments / (sum(r['step_ms'] for r in timed) / 1e3):.1f} comments/s over the step")
        print(f"  {variant} per step: " + json.dumps(rows))

    # One shared set of comments through all three forwards.
    pipe = steps["dense"].pipe
    texts = SyntheticSource(batch=256, seed=42)()
    ids, mask = pipe.tokenizer(texts, 128)
    batch, n = pack_tokens(strip_padding(ids, mask), 128, 8, pipe.tokenizer.pad_id, rows=256)
    valid = batch.seg_valid > 0
    owner = torch.from_numpy(batch.owner[valid].astype(np.int64)).to("cuda")
    arrays = [torch.from_numpy(a).to("cuda") for a in (batch.ids, batch.pos, batch.seg, batch.cls_pos)]
    vectors = {"dense": pipe.forward(*(torch.from_numpy(a).to("cuda") for a in TokenBatch(ids, mask)))}
    for variant in ("packed", "packed_flash"):
        vecs = steps[variant].pipe.packed_forward(*arrays)
        by_comment = torch.empty_like(vectors["dense"])
        by_comment[owner] = vecs[torch.from_numpy(valid).to("cuda")]
        vectors[variant] = by_comment
    diffs = {f"{a} vs {b}": (vectors[a].float() - vectors[b].float()).abs().max().item()
             for a, b in (("packed", "dense"), ("packed_flash", "dense"), ("packed_flash", "packed"))}
    check(n == 256 and all(bool(torch.isfinite(v).all()) for v in vectors.values())
          and max(diffs.values()) <= VARIANT_BAR,
          f"256 shared comments, per-comment vectors in bf16: max differences {diffs} <= {VARIANT_BAR}")


def profile_one_step(torch, run):
    """One more step, ``run()`` (which ends by fetching its result to the
    host), under ``torch.profiler``: device busy time, idle share within
    the step, and the kernels by device time. Informational: it runs
    after the launch counts are read and never fails the run."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # A user annotation (the optimizer's "Optimizer.step#..." range)
        # also shows on the device timeline; it spans kernels counted
        # on their own.
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]

        def device_us(e):
            return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

        busy_ms = sum(device_us(e) for e in kernels) / 1e3
        print(f"  profiled step (informational): wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for e in sorted(kernels, key=device_us, reverse=True)[:12]:
            print(f"    {device_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    except Exception:  # the profiler is an observation, not a check
        traceback.print_exc()
        print("  profile unavailable (informational, not a check)")


def train_batch(torch, batch, n_comments, rng, n_labels, device):
    """A packed batch with multi-hot labels (density 0.05, about one
    label in 28 per comment, as go_emotions has) on ``device``."""
    from svoc_torch.models.packing import pack_labels
    from svoc_torch.train.trainer import PackedTrainBatch

    labels = (rng.random((n_comments, n_labels)) < 0.05).astype("float32")
    arrays = (batch.ids, batch.pos, batch.seg, batch.cls_pos, batch.seg_valid,
              pack_labels(batch, labels))
    return PackedTrainBatch(*(torch.from_numpy(a).to(device) for a in arrays))


def packed_state(torch, cfg, params, tx, device):
    """A fresh train state of the packed encoder holding float32 copies
    of ``params``."""
    from svoc_torch.models.packing import PackedSentimentEncoder
    from svoc_torch.train.trainer import init_state

    with torch.device("meta"):
        model = PackedSentimentEncoder(cfg)
    return init_state(model, params, tx, device=device)


@phase("5a. small train step: card vs CPU")
def small_train_phase(torch):
    import numpy as np

    from svoc_torch.flagship import packed_comment_stream
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.models.encoder import init_params
    from svoc_torch.models.tokenizer import HashingTokenizer
    from svoc_torch.train.trainer import adamw, make_packed_train_step, sgd

    cfg = dataclasses.replace(TINY_TEST, attention="flash")
    tok = HashingTokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=32)
    batch, n = next(packed_comment_stream(tok, SyntheticSource(batch=16, seed=5), 16, 32, 4))
    params = init_params(cfg, seed=3, device="cpu")
    step = make_packed_train_step()
    # Bars from the card's own runs (NVIDIA H100 80GB HBM3): SGD's
    # parameters agree within 1.2e-7. AdamW's first step moves a weight
    # by about ±lr whatever the gradient's size, so a near-zero gradient
    # whose sign differs between card and CPU puts it up to 2 lr apart
    # (1.0e-5 measured at lr 1e-5).
    for name, tx, bar in (("SGD(0.1)", sgd(0.1), 1e-6), ("AdamW(1e-5)", adamw(1e-5), 2.5e-5)):
        ends = []
        for dev in ("cuda", "cpu"):
            state = packed_state(torch, cfg, params, tx, dev)
            tb = train_batch(torch, batch, n, np.random.default_rng(0), cfg.n_labels, dev)
            state, metrics = step(state, tb)
            ends.append((metrics["loss"].item(),
                         {k: p.detach().cpu() for k, p in state.model.named_parameters()}))
        (loss_card, p_card), (loss_cpu, p_cpu) = ends
        p_err = max((p_card[k] - p_cpu[k]).abs().max().item() for k in p_cpu)
        loss_err = abs(loss_card - loss_cpu)
        check(loss_err <= 1e-6 and p_err <= bar,
              f"TINY_TEST f32 {name} step: loss {loss_card:.7f} vs {loss_cpu:.7f} "
              f"(err {loss_err:.3e} <= 1e-6), max parameter err {p_err:.3e} <= {bar:g}")


@phase("5b. main path: full-width packed fine-tune steps")
def train_path_phase(torch, launches):
    import tempfile

    import numpy as np

    from svoc_torch.flagship import packed_comment_stream
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS
    from svoc_torch.models.encoder import init_params
    from svoc_torch.models.tokenizer import HashingTokenizer
    from svoc_torch.ops.flash_attention import flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda
    from svoc_torch.train.trainer import adamw, make_packed_train_step
    from svoc_torch.utils.checkpoint import restore_train_state, save_train_state

    cfg = dataclasses.replace(ROBERTA_GO_EMOTIONS, attention="flash")
    dev = torch.device("cuda")
    tok = HashingTokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=128)
    feed = packed_comment_stream(tok, SyntheticSource(batch=256, seed=7), 256, 128, 8)
    rng = np.random.default_rng(0)

    def next_batch():
        batch, n = next(feed)
        return train_batch(torch, batch, n, rng, cfg.n_labels, dev), n, int((batch.seg > 0).sum())

    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=dev)  # float32 master parameters
    state = packed_state(torch, cfg, params, adamw(1e-4), dev)
    step = make_packed_train_step()

    # CUDA events at the model's forward and the optimizer's step split a
    # step into forward, backward (loss, backward, grad norm) and update.
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    state.model.register_forward_pre_hook(lambda *_: mark("forward"))
    state.model.register_forward_hook(lambda *_: mark("backward"))
    state.optimizer.register_step_pre_hook(lambda *_: mark("update"))
    state.optimizer.register_step_post_hook(lambda *_: mark("end"))

    counted = (flash_attention_cuda, flash_dq_cuda, flash_dkv_cuda)
    qkv = [f"block_{i}.attention.{w}.weight" for i in range(cfg.n_layers)
           for w in ("query", "key", "value")]
    fixed, _, _ = next_batch()
    torch.cuda.synchronize()
    for wrapper in counted:
        wrapper.launches = 0
    rows, per_step = [], []
    for i in range(1 + MAIN_STEPS + FIXED_STEPS):
        tb, n_comments, n_tokens = next_batch() if i <= MAIN_STEPS else (fixed, 0, 0)
        before = [w.launches for w in counted]
        if i == 0:
            start = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        t0 = time.perf_counter()
        state, metrics = step(state, tb)
        loss, grad_norm = metrics["loss"].item(), metrics["grad_norm"].item()  # on the host: done
        t1 = time.perf_counter()
        per_step.append(tuple(w.launches - b for w, b in zip(counted, before)))
        rows.append(dict(step_ms=(t1 - t0) * 1e3, loss=loss, grad_norm=grad_norm,
                         forward_ms=events["forward"].elapsed_time(events["backward"]),
                         backward_ms=events["backward"].elapsed_time(events["update"]),
                         update_ms=events["update"].elapsed_time(events["end"]),
                         comments=n_comments, tokens=n_tokens))
        if i == 0:
            moved = [k for k, p in state.model.named_parameters() if not torch.equal(p, start[k])]
            params_of = dict(state.model.named_parameters())
            check(len(moved) == len(start),
                  f"first step moved {len(moved)} of {len(start)} parameter tensors")
            check(all(bool(params_of[k].grad.abs().sum() > 0) and k in moved for k in qkv),
                  f"all {len(qkv)} query/key/value projections got a gradient and moved")
            del start
    steps = len(rows)
    for wrapper, name in zip(counted, ("flash_attention", "flash_dq", "flash_dkv")):
        launches[name] = launches.get(name, 0) + wrapper.launches
    check(all(c == (cfg.n_layers,) * 3 for c in per_step),
          f"every step launched flash forward, dq and dk/dv {cfg.n_layers} times each "
          f"({steps} steps; totals {[w.launches for w in counted]})")

    distinct = rows[: 1 + MAIN_STEPS]
    losses = [r["loss"] for r in rows]
    check(all(math.isfinite(x) for x in losses)
          and len({r["loss"] for r in distinct}) == len(distinct),
          f"finite losses, distinct on {len(distinct)} distinct batches")
    check(all(math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in rows),
          "finite, positive grad norms")
    on_fixed = losses[1 + MAIN_STEPS:]
    check(on_fixed[-1] < FIXED_LOSS_RATIO * on_fixed[0],
          f"loss on one fixed batch over {FIXED_STEPS} steps: {on_fixed[0]:.5f} -> "
          f"{on_fixed[-1]:.5f} (< {FIXED_LOSS_RATIO} x the first)")

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "state.pt")
        save_train_state(path, state)
        restored = restore_train_state(path, packed_state(torch, cfg, params, adamw(1e-4), dev))
    saved_opt, restored_opt = state.optimizer.state_dict(), restored.optimizer.state_dict()
    same = (restored.step == state.step
            and all(torch.equal(p, q) for p, q in zip(state.model.parameters(), restored.model.parameters()))
            and all(torch.equal(saved_opt["state"][i][key], restored_opt["state"][i][key])
                    for i in saved_opt["state"] for key in saved_opt["state"][i]))
    check(same, f"save -> restore at step {state.step}: parameters and optimizer state exact")
    del restored, saved_opt, restored_opt

    timed = rows[1: 1 + MAIN_STEPS]
    mean = lambda key: sum(r[key] for r in timed) / len(timed)  # noqa: E731
    step_s = sum(r["step_ms"] for r in timed) / 1e3
    card = nvidia_smi()
    print(f"  [{card}] {len(timed)} timed steps: step {mean('step_ms'):.3f} ms (forward "
          f"{mean('forward_ms'):.3f} ms, backward {mean('backward_ms'):.3f} ms, AdamW update "
          f"{mean('update_ms'):.3f} ms)")
    print(f"  [{card}] trained {sum(r['comments'] for r in timed) / step_s:.1f} comments/s, "
          f"{sum(r['tokens'] for r in timed) / step_s:.1f} live tokens/s over the step; "
          f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print("  per step: " + json.dumps(rows))
    tb, _, _ = next_batch()
    profile_one_step(torch, lambda: step(state, tb)[1]["loss"].item())


def claim_names(n: int):
    """The fabric scenario's claim ids (``svoc_tpu/fabric/scenario.py``)."""
    first = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")
    return list(first[:n]) + [f"claim{i}" for i in range(len(first), n)]


@phase("6. main path: full-width multi-claim serving step")
def claims_path_phase(torch, launches):
    import numpy as np

    from svoc_torch.consensus.batch import pad_claim_cube
    from svoc_torch.fabric.registry import ClaimSpec
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.ops.flash_attention import flash_attention_cuda, flash_dkv_cuda, flash_dq_cuda
    from svoc_torch.ops.fused_consensus import (
        fused_consensus_cuda, fused_consensus_gated_claims_cuda, fused_consensus_gated_claims_plain,
    )
    from svoc_torch.robustness.sanitize import QuarantineGate, SanitizeConfig, quarantine_mask_claims
    from svoc_torch.serving.batcher import ClaimQueues
    from svoc_torch.serving.tier import ClaimServingStep
    from svoc_torch.sim.generators import claim_seed

    names = claim_names(CLAIMS)
    offender, slot = names[-1], ORACLES - 1
    rotation = ("nan", "inf", "range")

    def kind_of(cycle):  # the first step clean, then the rotation
        return None if cycle == 0 else rotation[(cycle - 1) % len(rotation)]

    def tamper(cycle, block):  # fabric/scenario.py:140-152, on slot N-1: a host float64 block
        kind = kind_of(cycle)
        if kind is None:
            return block
        block = np.array(block, copy=True)
        if kind == "nan":
            block[slot, 0] = np.nan
        elif kind == "inf":
            block[slot, :] = np.inf
        else:
            block[slot, :] = 7.5  # out of the constrained [0, 1] domain
        return block

    def specs(tampered):
        return [ClaimSpec(cid, seed=claim_seed(0, cid), n_oracles=ORACLES, n_failing=ORACLES // 8,
                          tamper=tamper if tampered and cid == offender else None)
                for cid in names]

    counted = {"flash_attention": flash_attention_cuda, "gated_claims_consensus":
               fused_consensus_gated_claims_cuda, "fused_consensus": fused_consensus_cuda,
               "flash_dq": flash_dq_cuda, "flash_dkv": flash_dkv_cuda}

    def run(step, timed):
        """CLAIM_STEPS steps on fresh per-claim comment sources; the
        results of each, and (when timed) one row of times per step."""
        sources = {cid: SyntheticSource(batch=REQUESTS_PER_CLAIM, seed=claim_seed(0, cid))
                   for cid in names}
        queues = ClaimQueues(names)
        results, rows, per_step = [], [], []
        for _ in range(CLAIM_STEPS):
            for cid in names:
                for text in sources[cid]():
                    queues.submit(cid, text)
            requests = queues.assemble(CLAIMS * REQUESTS_PER_CLAIM)
            before = {k: w.launches for k, w in counted.items()}
            t0 = time.perf_counter()
            batch = step.pack(requests)
            t1 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            vectors = step.forward(batch)
            ev[1].record()
            groups = step.fleets(requests, vectors)
            ev[2].record()
            (res,) = step.consensus(groups)
            ev[3].record()
            essence = res.out.essence.cpu()  # fetched to the host: the step is done
            t2 = time.perf_counter()
            per_step.append({k: w.launches - before[k] for k, w in counted.items()})
            results.append((res, essence))
            if timed:
                rows.append(dict(feed_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
                                 forward_ms=ev[0].elapsed_time(ev[1]),
                                 fleets_ms=ev[1].elapsed_time(ev[2]),
                                 consensus_ms=ev[2].elapsed_time(ev[3]),
                                 requests=len(requests), claims=len(res.claims)))
        return results, rows, per_step

    step = ClaimServingStep(specs(True), device="cuda")  # ROBERTA_GO_EMOTIONS, bf16 weights
    n_layers = step.pipe.cfg.n_layers
    torch.cuda.synchronize()
    for wrapper in counted.values():
        wrapper.launches = 0
    results, rows, per_step = run(step, timed=True)
    for name in ("flash_attention", "gated_claims_consensus"):
        launches[name] = launches.get(name, 0) + counted[name].launches
    want = dict(flash_attention=n_layers, gated_claims_consensus=1, fused_consensus=0,
                flash_dq=0, flash_dkv=0)
    check(all(c == want for c in per_step),
          f"every step launched {want} ({CLAIM_STEPS} steps; totals "
          f"{ {k: w.launches for k, w in counted.items()} })")

    gate = QuarantineGate(SanitizeConfig.for_consensus(True))
    cfg = specs(False)[0].consensus_config()
    for i, (res, essence) in enumerate(results):
        kind = kind_of(i)
        report = gate.inspect(res.blocks[-1])
        check(res.claims == tuple(names) and bool(res.ok[:-1].all()),
              f"step {i + 1}: {len(res.claims)} claims in registration order, "
              f"every sibling oracle admitted")
        if kind is None:
            check(bool(res.ok[-1].all()) and report.clean, f"step {i + 1} (clean): offender all admitted")
            continue
        admitted = int(res.ok[-1].sum())
        check(not bool(res.ok[-1, slot]) and not bool(res.out.reliable[-1, slot])
              and admitted == ORACLES - 1 and report.reasons == {slot: kind}
              and bool(torch.isfinite(res.out.essence[-1]).all())
              and bool(torch.isfinite(res.out.essence_first_pass[-1]).all())
              and bool(res.out.interval_valid[-1]),
              f"step {i + 1} ({kind}): slot {slot} quarantined and unreliable, host gate "
              f"{report.reasons}, {admitted} admitted, finite essences, valid")

    res = results[-1][0]
    values, ok, mask = pad_claim_cube(torch.stack(res.blocks))
    plain_ok = quarantine_mask_claims(values, 0.0, 1.0)
    plain = fused_consensus_gated_claims_plain(values, plain_ok, mask, cfg)
    good, errs, _ = gated_errors(torch, res.out, type(plain)(*(f[:CLAIMS] for f in plain)))
    check(good and torch.equal(plain_ok[:CLAIMS], res.ok),
          "last step's cube through the plain gate and consensus: "
          + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()))
    essences = torch.stack([e for _, e in results])  # [steps, claims, 6]
    distinct = len({tuple(r) for r in essences.reshape(-1, 6).tolist()})
    check(distinct == CLAIM_STEPS * CLAIMS and bool(torch.isfinite(essences).all()),
          f"{distinct} distinct finite essences over {CLAIM_STEPS} steps x {CLAIMS} claims")

    clean = ClaimServingStep(specs(False), pipe=step.pipe)
    clean_results, _, _ = run(clean, timed=False)
    same = all(torch.equal(getattr(a[0].out, f)[:-1], getattr(b[0].out, f)[:-1])
               for a, b in zip(results, clean_results) for f in a[0].out._fields)
    check(same, f"{CLAIMS - 1} sibling claims bit for bit the same with and without the tamper, "
                f"{CLAIM_STEPS} steps, every output field")

    timed = rows[-CLAIM_TIMED:]
    mean = lambda key: sum(r[key] for r in timed) / len(timed)  # noqa: E731
    step_s = sum(r["step_ms"] for r in timed) / 1e3
    b3_ms = cuda_ms(torch, lambda: fused_consensus_gated_claims_cuda(values, plain_ok, mask, cfg),
                    iters=50)
    card = nvidia_smi()
    print(f"  [{card}] steps {CLAIM_STEPS - CLAIM_TIMED + 1}-{CLAIM_STEPS}: step {mean('step_ms'):.3f} ms "
          f"(forward {mean('forward_ms'):.3f} ms, fleets {mean('fleets_ms'):.3f} ms, gate + "
          f"consensus {mean('consensus_ms'):.3f} ms), host feed {mean('feed_ms'):.3f} ms")
    print(f"  [{card}] {sum(r['requests'] for r in timed) / step_s:.1f} requests/s, "
          f"{sum(r['claims'] for r in timed) / step_s:.1f} claims/s over the step; the claim-cube "
          f"kernel {b3_ms:.4f} ms on the last cube, {100 * b3_ms / mean('step_ms'):.2f} % of the step")
    print("  per step: " + json.dumps(rows))
    sources = {cid: SyntheticSource(batch=REQUESTS_PER_CLAIM, seed=1) for cid in names}
    queues = ClaimQueues(names)
    for cid in names:
        for text in sources[cid]():
            queues.submit(cid, text)
    requests = queues.assemble(CLAIMS * REQUESTS_PER_CLAIM)
    profile_one_step(torch, lambda: clean(requests)[0].out.essence.cpu())


@phase("7. the probe path (svoc_torch.tools.probe)")
def probe_phase(torch, launches):
    from svoc_torch.ops.grid_copy import grid_copy_cuda
    from svoc_torch.tools import probe

    before = grid_copy_cuda.launches
    t0 = time.perf_counter()
    rc = probe.main(["--timeout", str(PROBE_TIMEOUT_S)])  # prints each record as it lands
    elapsed = time.perf_counter() - t0
    records = json.loads((Path(probe.REPO) / "GPU_PROBE.json").read_text())
    by_name = {r["probe"]: r for r in records}
    check(rc == 0 and tuple(r["probe"] for r in records) == PROBE_RECORDS,
          f"probe.main returned {rc}; GPU_PROBE.json holds {[r['probe'] for r in records]} "
          f"({elapsed:.1f} s)")
    for r in records:
        check(r.get("ok") is True and not r.get("timeout"),
              f"{r['probe']}: ok ({r.get('elapsed_s')} s)"
              + ("" if r.get("ok") else f" {r.get('stderr_tail') or r.get('stdout_tail')}"))
    if len(by_name) != len(PROBE_RECORDS) or not all(r.get("ok") for r in records):
        return
    counts = {name: r["launches"] for name, r in by_name.items()}
    check(by_name["backend"]["platform"] == "gpu"
          and by_name["backend"]["device_kind"] == torch.cuda.get_device_name(0),
          f"backend: {by_name['backend']['device_kind']}, {by_name['backend']['nvidia_smi']}")
    check(by_name["grid_copy"]["correct"] is True and counts["grid_copy"]["grid_copy"] >= 1,
          f"grid_copy: correct, {counts['grid_copy']['grid_copy']} launches in its interpreter, "
          f"build {by_name['grid_copy']['build_s']} s, copy {by_name['grid_copy']['copy_ms']} ms")
    for n in (128, 256, 512, 1024):
        r = by_name[f"consensus{n}"]
        check(r["essence_match"] is True and r["n_oracles"] == n
              and counts[f"consensus{n}"]["fused_consensus"] >= 1,
              f"consensus{n}: essence_match, kernel {r['kernel_ms']} ms, plain {r['plain_ms']} ms")
    r = by_name["flash512"]
    check(r["match_dense"] is True and counts["flash512"]["flash_attention"] >= 1,
          f"flash512: match_dense (max diff {r['max_abs_diff']:.3e}, dtype bound {r['dtype_bound']}, "
          f"within the 2e-5 float32 bar: {r['within_f32_bar']}), flash {r['flash_ms']} ms, "
          f"dense {r['dense_ms']} ms")
    forwards = 18  # the first call, one warm call and 16 timed calls
    check(counts["encoder512_dense"]["flash_attention"] == 0
          and counts["encoder512_flash"]["flash_attention"] == 12 * forwards,
          f"encoder512: flash launches dense {counts['encoder512_dense']['flash_attention']} == 0, "
          f"flash {counts['encoder512_flash']['flash_attention']} == 12 x {forwards}; forward "
          f"dense {by_name['encoder512_dense']['forward_ms']} ms, "
          f"flash {by_name['encoder512_flash']['forward_ms']} ms")
    check(grid_copy_cuda.launches == before,
          "the probes ran in their own interpreters (no launch counted in this one)")
    for kernel in KERNEL_ROWS:
        launches[kernel] = launches.get(kernel, 0) + sum(c[kernel] for c in counts.values())
    print(f"  [{nvidia_smi()}] launches inside the probes: "
          + json.dumps({k: v for k, v in ((k, sum(c[k] for c in counts.values())) for k in KERNEL_ROWS) if v}))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import svoc_torch  # noqa: F401
    except ImportError:
        print("FAIL: the svoc_torch package is not beside chip_smoke.py", file=sys.stderr)
        return 2

    results, launches = {}, {}
    if environment(torch):
        grid_copy_phase(torch, results)
        flash_phase(torch, results)
        flash_bwd_phase(torch, results)
        flash_dense_phase(torch)
        consensus_phase(torch, results)
        gated_claims_phase(torch, results)
        small_step_phase(torch)
        main_path_phase(torch, launches)
        variants_phase(torch, launches)
        serving = dict(launches)
        small_train_phase(torch)
        train_path_phase(torch, launches)
        trained = dict(launches)
        claims_path_phase(torch, launches)
        claimed = dict(launches)
        probe_phase(torch, launches)
        print(f"  launches: serving paths {serving}; with the train path {trained}; "
              f"with the multi-claim path {claimed}; with the probe path {launches}")
    check(all(launches.get(name, 0) > 0 for name in KERNEL_ROWS),
          f"every kernel launched on its path: { {k: launches.get(k, 0) for k in KERNEL_ROWS} }")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "svoc_tpu"))
    check(not leaked, f"no JAX or svoc_tpu module loaded ({leaked})")

    if len(results) == len(KERNEL_ROWS):
        print(json.dumps({"kernels": [
            dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches.get(name, 0), **results[name])
            for name, (source, replaces) in KERNEL_ROWS.items()
        ]}))
    if failures:
        print(f"FAILED: {len(failures)} check(s): {failures}", file=sys.stderr)
        return 1
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
