#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``svoc_torch``) on one NVIDIA GPU and check it.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

Phases:

1. Environment: the card's name and power limit, the torch and CUDA
   versions, and the build of every CUDA kernel from ``svoc_torch/csrc``
   (one ``nvcc`` per source, all at once, into ``svoc_torch/_build``).
2. The flash-attention kernel against its plain PyTorch version: the
   flagship shape [256, 128, 12, 64] in bf16 with segment ids from a real
   packed batch (3e-2), the per-key mask mode, float32 at every head width
   (2e-5), dead rows (exactly 0 and lse -inf) and the lse.
3. The fused-consensus kernel against its plain version: N = 1024, M = 6,
   n_failing = 128, constrained and unconstrained, a tie-heavy fleet,
   N = 7 and N = 1000. The reliable mask exact; essence, risk and
   reliabilities within 1e-5; skewness within 1e-4; kurtosis within 1e-3.
4. The serving step: first a small float32 step on the card against the
   same step on the CPU (the plain versions the CPU tests hold against the
   JAX package); then the main path at full width, ROBERTA_GO_EMOTIONS
   with bf16 weights, 256 packed rows of 128 tokens with up to 8 comments,
   a 50-comment window, 1024 oracles, subsets of 10: one warm-up step and
   five timed steps on distinct batches. Every kernel's launch count is
   set to 0 just before the main path and read just after it. One more
   step then runs under ``torch.profiler`` for a breakdown of device time
   (informational: it cannot fail the run).

It then prints one JSON line of per-kernel numbers, the card's
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. It exits non-zero, and prints no
result, if any check fails, if there is no CUDA device, or if the
``svoc_torch`` package is not beside it. Bounds use the H100 SXM data
sheet: 3.35 TB/s, 989 TFLOP/s bf16 and 67 TFLOP/s fp32.
"""

from __future__ import annotations

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
KERNELS = ("flash_attention", "fused_consensus")
MAIN_STEPS = 5  # timed steps after one warm-up step

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


def packed_batch(seed: int):
    from svoc_torch.flagship import packed_comment_stream
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS as cfg
    from svoc_torch.models.tokenizer import HashingTokenizer

    tok = HashingTokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=128)
    batch, _ = next(packed_comment_stream(tok, SyntheticSource(batch=256, seed=seed), 256, 128, 8))
    return batch


@phase("2. flash attention: kernel vs plain")
def flash_phase(torch, results):
    import torch.nn.functional as F

    from svoc_torch.ops.flash_attention import (
        attention_tags, flash_attention_cuda, flash_attention_plain,
    )

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

    # Times at the flagship shape, main-path call (no lse).
    ms = cuda_ms(torch, lambda: flash_attention_cuda(q, k, v, qtag, ktag))
    plain_ms = cuda_ms(torch, lambda: flash_attention_plain(q, k, v, qtag, ktag), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    live = (qtag[:, :, None] == ktag[:, None, :]) & (ktag[:, None, :] > 0)
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
    compare("N=7", torch.rand(7, 6, generator=gen, device=dev), ConsensusConfig(n_failing=2))
    compare("N=1000", torch.rand(1000, 6, generator=gen, device=dev), ConsensusConfig(n_failing=125))

    ms = cuda_ms(torch, lambda: fused_consensus_cuda(uniform, flagship), iters=50)
    plain_ms = cuda_ms(torch, lambda: fused_consensus_plain(uniform, flagship), iters=10)
    n, m = uniform.shape
    bytes_moved = 4 * (n * m + 2 * m + 2 + n + n + 2 * m)
    ops = 13 * n * math.ceil(math.log2(n)) + 12 * n * m  # 13 sorts' comparisons + moments
    bound_ms, bound_by = bound(bytes_moved, ops, FP32_FLOPS)
    print(f"  N=1024 times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by})")
    results["fused_consensus"] = dict(
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
    card = FlagshipStep(TINY_TEST, device="cuda", **kw)
    cpu = FlagshipStep(TINY_TEST, device="cpu", **kw)
    batch, _ = next(card.comments(SyntheticSource(batch=16, seed=5)))
    draws = card.draws(torch.Generator(device="cuda").manual_seed(1))
    w_card, w_cpu = card.window(batch), cpu.window(batch)
    out_card, _ = card.consensus(w_card, draws)
    out_cpu, _ = cpu.consensus(w_cpu, type(draws)(*(x.cpu() for x in draws)))
    w_err = (w_card.cpu() - w_cpu).abs().max().item()
    e_err = (out_card.essence.cpu() - out_cpu.essence).abs().max().item()
    check(w_err <= 1e-4, f"TINY_TEST f32 window: card vs CPU max err {w_err:.3e} <= 1e-4")
    check(torch.equal(out_card.reliable.cpu(), out_cpu.reliable) and e_err <= 1e-5,
          f"TINY_TEST consensus: mask exact, essence err {e_err:.3e} <= 1e-5")


@phase("4b. main path: full-width packed-flash serving step")
def main_path_phase(torch, launches):
    from svoc_torch.flagship import FlagshipStep
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.ops.flash_attention import flash_attention_cuda
    from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_plain
    from svoc_torch.sim.oracle import assemble_fleet

    step = FlagshipStep(device="cuda")  # ROBERTA_GO_EMOTIONS, bf16 weights
    n_layers = step.pipe.cfg.n_layers
    feed = step.comments(SyntheticSource(batch=256, seed=0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()

    flash_attention_cuda.launches = 0
    fused_consensus_cuda.launches = 0
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

    steps = 1 + MAIN_STEPS
    check(launches["flash_attention"] == n_layers * steps,
          f"flash kernel launches {launches['flash_attention']} == {n_layers} x {steps} steps")
    check(launches["fused_consensus"] == steps,
          f"consensus kernel launches {launches['fused_consensus']} == {steps} steps")
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
    profile_one_step(torch, step, feed, gen)


def profile_one_step(torch, step, feed, gen):
    """One more step under ``torch.profiler``: device busy time, idle
    share within the step, and the kernels by device time. Informational:
    it runs after the launch counts are read and never fails the run."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        batch, _ = next(feed)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out, _ = step(batch, gen)
            out.essence.cpu()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

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
        flash_phase(torch, results)
        consensus_phase(torch, results)
        small_step_phase(torch)
        main_path_phase(torch, launches)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "svoc_tpu"))
    check(not leaked, f"no JAX or svoc_tpu module loaded ({leaked})")

    sources = {
        "flash_attention": ("svoc_torch/csrc/flash_attention.cu", "svoc_tpu/ops/pallas_attention.py:71"),
        "fused_consensus": ("svoc_torch/csrc/fused_consensus.cu", "svoc_tpu/ops/pallas_consensus.py:209"),
    }
    if len(results) == len(KERNELS):
        print(json.dumps({"kernels": [
            dict(name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
                 launches=launches.get(name, 0), **results[name])
            for name in KERNELS
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
