"""On-card probes: does each kernel build and launch on this GPU, and
how does it compare with the plain (dense) path.

Mirrors ``tools/tpu_probe.py``, structure included, because the
structure is the point: each probe is Python **source** run in its own
interpreter under a hard timeout, so that a hung compiler or a wedged
device is contained and reported as ``{"ok": false, "timeout": true}``
instead of wedging the caller.  Every record is printed as a JSON line
and the list so far is written to ``GPU_PROBE.json`` at the repository
root after every probe.

Probes:

1. ``backend``        — CUDA init and the device's name (the canary).
2. ``grid_copy``      — the gridded block-copy kernel
                        (``csrc/grid_copy.cu``): does the repository's
                        own path (``nvcc`` → shared library → ctypes → a
                        launch with a multi-dimensional grid on the
                        caller's stream) work, and is the copy exact.
3. ``consensus1024``  — the fused consensus kernel against the port's
                        plain ``consensus_step``; the fleet size comes
                        from ``SVOC_PROBE_N_ORACLES`` and ``main`` walks
                        128, 256, 512 upward before 1024.
4. ``flash512``       — flash attention at B=8 T=512 H=12 D=64 in float32
                        against ``dense_attention_reference``.
5. ``encoder512``     — the full-width encoder forward at B=32, T=512,
                        once with ``attention="dense"`` and once with
                        ``"flash"`` (``SVOC_PROBE_ATTENTION``).

A probe needs a CUDA device and fails without one: nothing here runs on
the CPU.  Every record carries ``launches``, the kernel wrappers' counts
inside that probe's interpreter.

Usage: ``python -m svoc_torch.tools.probe [--only NAME] [--timeout S]``
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from svoc_torch.utils.artifacts import atomic_write_json

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Each probe is Python source executed in a fresh interpreter; it must
# print exactly one JSON object on its last stdout line.  The prelude
# resolves the device (CUDA, or the probe fails), turns TF32 off (the
# float32 dense references must be full float32, or a probe's difference
# measures cuBLAS and not the kernel) and defines the timing protocol:
# warm once, `reps` calls back to back, one fetch to the host of a
# checksum over every output leaf.  On CUDA calls return before the
# device finishes; the fetch is what ends the clock.

PRELUDE = """
import json, os, time
import torch
from svoc_torch.device import resolve_device
from svoc_torch.ops.flash_attention import flash_attention_cuda, flash_dq_cuda, flash_dkv_cuda
from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_gated_claims_cuda
from svoc_torch.ops.grid_copy import grid_copy_cuda

DEV = resolve_device(None)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_WRAPPERS = {"flash_attention": flash_attention_cuda, "flash_dq": flash_dq_cuda,
             "flash_dkv": flash_dkv_cuda, "fused_consensus": fused_consensus_cuda,
             "gated_claims_consensus": fused_consensus_gated_claims_cuda,
             "grid_copy": grid_copy_cuda}

def launches():
    return {k: w.launches for k, w in _WRAPPERS.items()}

def _leaves(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [l for item in x for l in _leaves(item)]
    return []

def _fetch(x):
    return float(sum(l.float().sum() for l in _leaves(x)).cpu())

def lat(fn, reps=16):
    _fetch(fn())  # warm
    t0 = time.time()
    h = None
    for _ in range(reps):
        h = fn()
    _fetch(h)
    return (time.time() - t0) / reps * 1e3

def emit(**record):
    print(json.dumps(dict(record, launches=launches())))
"""

PROBES: dict = {}

PROBES["backend"] = """
import subprocess
t0 = time.time()
torch.zeros(1, device=DEV).cpu()  # creates the CUDA context
init_s = time.time() - t0
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, timeout=60)
emit(platform="gpu", device_kind=torch.cuda.get_device_name(0),
     n_devices=torch.cuda.device_count(), init_s=round(init_s, 1),
     nvidia_smi=smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else None)
"""

PROBES["grid_copy"] = """
from svoc_torch.ops import _build
from svoc_torch.ops.grid_copy import grid_copy

x = torch.arange(4 * 256 * 128, dtype=torch.float32, device=DEV).reshape(4, 256, 128)
block = (1, 128, 128)  # grid (4, 2, 1)
t0 = time.time()
_build.load("grid_copy")  # nvcc when no current library is in svoc_torch/_build
build_s = time.time() - t0
t0 = time.time()
out = grid_copy(x, block)
torch.cuda.synchronize()
first_call_s = time.time() - t0
ok = bool(torch.equal(out, x))
emit(grid_launches=True, correct=ok, grid=[4, 2, 1], build_s=round(build_s, 1),
     first_call_s=round(first_call_s, 4), copy_ms=round(lat(lambda: grid_copy(x, block)), 4))
"""

PROBES["consensus1024"] = """
from svoc_torch.consensus.kernel import ConsensusConfig, consensus_step
from svoc_torch.ops.fused_consensus import fused_consensus

# Size-bisect support: SVOC_PROBE_N_ORACLES lets main() walk the sizes
# upward and localize where a hang starts.
n, dim = int(os.environ.get("SVOC_PROBE_N_ORACLES", "1024")), 6
cfg = ConsensusConfig(n_failing=n // 4, constrained=True)
gen = torch.Generator(device=DEV).manual_seed(0)
values = 0.01 + 0.98 * torch.rand(n, dim, generator=gen, device=DEV)

t0 = time.time(); _fetch(consensus_step(values, cfg)); plain_first_s = time.time() - t0
t0 = time.time(); _fetch(fused_consensus(values, cfg)); kernel_build_s = time.time() - t0

plain_ms = lat(lambda: consensus_step(values, cfg))
kernel_ms = lat(lambda: fused_consensus(values, cfg))
a = fused_consensus(values, cfg); b = consensus_step(values, cfg)
match = bool(torch.allclose(a.essence, b.essence, rtol=0, atol=1e-5))
emit(n_oracles=n, kernel_build_s=round(kernel_build_s, 1), plain_first_s=round(plain_first_s, 1),
     kernel_ms=round(kernel_ms, 3), plain_ms=round(plain_ms, 3),
     speedup=round(plain_ms / kernel_ms, 2), essence_match=match)
"""

PROBES["flash512"] = """
from svoc_torch.ops.dense_attention import dense_attention_reference
from svoc_torch.ops.flash_attention import flash_attention

b, t, h, d = 8, 512, 12, 64
gen = torch.Generator(device=DEV).manual_seed(0)
q = torch.randn(b, t, h, d, generator=gen, device=DEV)
mask = torch.ones(b, t, dtype=torch.int32, device=DEV)

t0 = time.time()
out = flash_attention(q, q, q, mask)
torch.cuda.synchronize()
build_s = time.time() - t0
ref = dense_attention_reference(q, q, q, mask)
# Dtype-aware verdict, as the reference's probe gives it: a bf16 ulp of
# the output scale with headroom.  These inputs are float32 and TF32 is
# off, so max_abs_diff is also printed beside the 2e-5 bar that the
# float32 attention tests hold the kernel to.
diff = float((out - ref).abs().max())
scale = float(ref.abs().max())
bound = 4.0 * 2.0 ** -8 * scale

flash_ms = lat(lambda: flash_attention(q, q, q, mask))
dense_ms = lat(lambda: dense_attention_reference(q, q, q, mask))
emit(flash_launches=True, build_s=round(build_s, 1), match_dense=diff <= bound,
     max_abs_diff=diff, dtype_bound=round(bound, 6), f32_bar=2e-5, within_f32_bar=diff <= 2e-5,
     flash_ms=round(flash_ms, 3), dense_ms=round(dense_ms, 3),
     speedup=round(dense_ms / flash_ms, 2))
"""

PROBES["encoder512"] = """
import dataclasses
from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS
from svoc_torch.models.encoder import SentimentEncoder, init_params, load_encoder

flash = os.environ.get("SVOC_PROBE_ATTENTION") == "flash"
cfg = dataclasses.replace(ROBERTA_GO_EMOTIONS, attention="flash" if flash else "dense")
model = load_encoder(SentimentEncoder, cfg, init_params(cfg, seed=0, device=DEV))
b, t = 32, 512
ids = torch.ones(b, t, dtype=torch.int32, device=DEV)
mask = torch.ones(b, t, dtype=torch.int32, device=DEV)

fwd = torch.inference_mode()(lambda: model(ids, mask))
t0 = time.time(); _fetch(fwd())
first_call_s = time.time() - t0

ms = lat(fwd)
emit(flash_enabled=flash, first_call_s=round(first_call_s, 1), forward_ms=round(ms, 3),
     comments_per_sec=round(b / (ms / 1e3), 1),
     peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
"""


def run_probe(name: str, timeout_s: float, extra_env: dict | None = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    env.update(extra_env or {})
    t0 = time.time()
    # Its own process group: a timeout must kill the whole group, or an
    # nvcc the probe started lives on and the next probe's build races it.
    proc = subprocess.Popen(
        [sys.executable, "-c", PRELUDE + PROBES[name]],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        env=env,
        cwd=REPO,
        process_group=0,
    )
    try:
        stdout, stderr = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        proc.communicate()
        return {
            "probe": name,
            "ok": False,
            "timeout": True,
            "elapsed_s": round(time.time() - t0, 1),
        }
    except BaseException:
        _kill_group(proc)
        proc.communicate()
        raise
    result: dict = {
        "probe": name,
        "ok": proc.returncode == 0,
        "elapsed_s": round(time.time() - t0, 1),
    }
    if proc.returncode == 0:
        try:
            result.update(json.loads(stdout.strip().splitlines()[-1]))
        except (ValueError, IndexError):
            result["ok"] = False
            result["stdout_tail"] = stdout[-300:]
    else:
        result["stderr_tail"] = (stderr or "").strip().splitlines()[-3:]
    return result


def _kill_group(proc: subprocess.Popen) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:  # the group is already gone
        pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--only", choices=sorted(PROBES), default=None)
    parser.add_argument("--timeout", type=float, default=420.0)
    args = parser.parse_args(argv)

    names = [args.only] if args.only else list(PROBES)
    results = []
    out_path = os.path.join(REPO, "GPU_PROBE.json")

    def record(r):
        """Print and persist after EVERY probe: a kill from outside must
        not lose the probes that had finished."""
        print(json.dumps(r), flush=True)
        results.append(r)
        atomic_write_json(out_path, results)

    for name in names:
        extra = {}
        if name == "consensus1024":
            # Size bisect, ascending; stop at the first hang: larger
            # sizes would only hang longer.
            hung = False
            for n_oracles in (128, 256, 512):
                r1 = run_probe(name, args.timeout, {"SVOC_PROBE_N_ORACLES": str(n_oracles)})
                r1["probe"] = f"consensus{n_oracles}"
                record(r1)
                if r1.get("timeout"):
                    hung = True
                    break
            if hung:
                continue
            extra = {"SVOC_PROBE_N_ORACLES": "1024"}
        if name == "encoder512":
            # run twice: dense, then the flash-attention encoder config
            r1 = run_probe(name, args.timeout, {"SVOC_PROBE_ATTENTION": "dense"})
            r1["probe"] = "encoder512_dense"
            record(r1)
            extra = {"SVOC_PROBE_ATTENTION": "flash"}
        r = run_probe(name, args.timeout, extra)
        if name == "encoder512":
            r["probe"] = "encoder512_flash"
        record(r)
        if name == "backend" and not r["ok"]:
            print(json.dumps({"abort": "backend unreachable"}))
            break

    return 0 if all(r.get("ok") for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
