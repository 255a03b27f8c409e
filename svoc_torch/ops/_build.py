"""Builds the port's CUDA sources at first use (no ``svoc_tpu``
counterpart: a Pallas kernel compiles inside ``jax.jit``).

Each ``svoc_torch/csrc/<name>.cu`` has a plain C interface. ``nvcc``
compiles it for ``sm_90a`` into ``<build dir>/lib<name>-<hash>.so``, and
:func:`load` opens it with ctypes. The hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source or
header builds anew and an unchanged one is reused. :func:`build` starts
one ``nvcc`` per source, all at once, so that a cold start waits for the
slowest file only.

The build directory is ``svoc_torch/_build/`` (git-ignored) unless the
process points it elsewhere with :func:`set_build_dir`: the compile
plane's persistent kernel cache (:mod:`svoc_torch.compile.cache`) puts
it under a durability directory, so that a restarted process on a fresh
machine, or one whose package directory is read-only, loads what an
earlier process built.  Every ``nvcc`` run is reported to the listeners
of :func:`add_listener` as a ``"miss"`` with its seconds, and every
first load of a library this process did not build as a ``"hit"``
(:func:`svoc_torch.utils.metrics.install_compile_listener` counts both).
A hit in a directory the process pointed its builds at touches the file,
so that the cache's eviction drops the library loaded least recently; a
hit in ``svoc_torch/_build/`` touches nothing, and a file that refuses
the touch (a read-only directory, another owner's library) still loads.
:func:`load_all` builds every missing library of a list in parallel and
loads them all, as the prewarm worker does ahead of traffic.

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
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

from svoc_torch.utils.artifacts import fsync_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: The process's build directory (None: :data:`BUILD_DIR`).
_build_dir: Optional[Path] = None
#: Libraries this process built: their first load is no cache hit.
_built: set = set()
#: ``listener(event, name, seconds)``, event ``"hit"`` or ``"miss"``.
_listeners: List[Callable[[str, str, float], None]] = []


def build_dir() -> Path:
    """Where this process builds and loads its kernel libraries."""
    return BUILD_DIR if _build_dir is None else _build_dir


def set_build_dir(path) -> Path:
    """Point this process's builds and loads at ``path`` (None: back to
    :data:`BUILD_DIR`); returns the previous directory.  A library
    already loaded stays loaded."""
    global _build_dir
    with _lock:
        previous = build_dir()
        _build_dir = None if path is None else Path(path)
        return previous


def add_listener(fn: Callable[[str, str, float], None]) -> None:
    """Report every later build (``"miss"``) and cache hit to ``fn``."""
    with _lock:
        if fn not in _listeners:
            _listeners.append(fn)


def _report(event: str, name: str, seconds: float) -> None:
    for fn in list(_listeners):
        fn(event, name, seconds)


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
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every source in ``names`` that has no current library, in
    parallel; returns each new build's compiler report (``-Xptxas=-v``:
    registers, shared memory, spills).  Raises on a failed build.  Each
    ``nvcc`` run is reported as a miss with its seconds, a failed one too."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
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
        _report("miss", name, time.perf_counter() - t0)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{report}")
            continue
        # Durably: the file before the rename, the directory after it. A
        # persistent build directory (the compile plane's kernel cache)
        # outlives the process, and a crash must not leave an empty file
        # under the library's name, which would fail to load, not rebuild.
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        fsync_dir(str(out))
        _built.add(out)
        reports[name] = report
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def _touch(path: Path) -> None:
    """Make a cache hit the most recent load (the persistent cache's
    eviction order).  Only a directory set by :func:`set_build_dir` is
    touched, and a refused touch is no error: the library loads all the
    same."""
    if _build_dir is None:
        return
    try:
        os.utime(path)
    except OSError:
        pass


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use into
    the build directory; a library found there is a hit."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if path.exists() and path not in _built:
                _touch(path)
                _report("hit", name, 0.0)
            else:
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """The handles of every source in ``names``: those with no current
    library are built first, one ``nvcc`` each and all at once, so that
    the caller waits for the slowest source only."""
    with _lock:
        missing = [n for n in names if n not in _loaded and not library_path(n).exists()]
        if missing:
            build(missing)
    return {name: load(name) for name in names}


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
