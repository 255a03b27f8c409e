"""Builds the port's CUDA sources at first use (no ``svoc_tpu``
counterpart: a Pallas kernel compiles inside ``jax.jit``).

Each ``svoc_torch/csrc/<name>.cu`` has a plain C interface. ``nvcc``
compiles it for ``sm_90a`` into ``svoc_torch/_build/lib<name>-<hash>.so``
(git-ignored), and :func:`load` opens it with ctypes. The hash covers the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source or header builds anew and an unchanged one is reused. :func:`build` starts one ``nvcc`` per source, all at
once, so that a cold start waits for the slowest file only.

Every kernel launch goes through :func:`launch`, which makes the
tensors' device current when it is not, so that a kernel runs on its
tensors' device and that device's current stream whatever device the
caller has current.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source,
    every shared header ``csrc/*.cuh`` (any of them may be included) and
    the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every source in ``names`` that has no current library, in
    parallel; returns each new build's compiler report (``-Xptxas=-v``:
    registers, shared memory, spills).  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{report}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        reports[name] = report
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def launch(kernel: str, fn: Callable[..., int], device: torch.device, *args) -> None:
    """Call the C entry ``fn(*args, stream)`` of a kernel with ``device``
    current and that device's current stream as its last argument;
    raises ``RuntimeError`` naming ``kernel`` when it returns a CUDA
    error (a refused launch never runs, and no synchronise reports it).

    The device is switched only when it is not the current one, and the
    previous device is current again afterwards. The stream is asked for
    on every call, as a raw handle (no ``torch.cuda.Stream`` is built),
    so that a caller's ``torch.cuda.stream(s)`` is honoured."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index != current:
        torch.cuda.set_device(index)
    try:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    finally:
        if index != current:
            torch.cuda.set_device(current)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
