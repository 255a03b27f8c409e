"""The persistent kernel cache under the durability directory.

Mirrors :mod:`svoc_tpu.compile.cache` (``cache.py:1-256``).  Where the
reference points JAX's persistent compilation cache under the durability
base directory, the port points its kernel build directory there
(:func:`svoc_torch.ops._build.set_build_dir`): the ``nvcc`` builds of
``svoc_torch/csrc`` then survive the same kill and restart as the WAL
and the snapshots, and a restarted process on a fresh machine, or one
whose package directory is read-only, loads its kernels instead of
building them inside its first served step.

Versioning: the cache lives under a salt directory,
``<base>/kernel_cache/<salt>``, where the salt covers the torch version,
the CUDA version torch was built for and :func:`kernel_revision`, a
digest of ``csrc/*.cu``, ``csrc/*.cuh`` and the ``nvcc`` flags.  Each
library's own name already hashes its source, so an edit would simply
miss; the salt makes the old entries go, loudly (the stale salt
directories are deleted when the cache is enabled and counted in
``compile_cache_invalidated{salt=}``).

Size cap: :func:`evict_cache` deletes the library loaded least recently
(``_build.load`` touches a library's file on every hit in this
directory, as JAX refreshes its ``-atime`` files) until the directory
fits ``max_bytes``; :func:`enable_persistent_cache` runs it once.  The
reference also evicts on the recovery manager's snapshot cadence; the
port does not, because a salt directory holds at most one library per
source (a few MiB against the 256 MiB cap), so there is nothing to
evict: the stale-salt removal is what bounds the cache.  The cache is
durable state but not journal state.
This module imports torch (through ``ops/_build.py``) only inside its
functions.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import threading
from typing import Dict, List, Optional, Tuple

from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry

#: Subdirectory of the durability base directory holding every salt's cache.
CACHE_DIRNAME = "kernel_cache"

#: Default size cap (bytes): the six kernel libraries take a few MiB;
#: the cap is an operator's knob.
DEFAULT_MAX_BYTES = 256 * 1024 * 1024

_state_lock = threading.Lock()
#: The enabled cache directory (None until :func:`enable_persistent_cache`).
_enabled_dir: Optional[str] = None


def kernel_revision() -> str:
    """sha256 over ``csrc/*.cu`` and ``csrc/*.cuh`` (sorted by name,
    name and content) and the ``nvcc`` flags: the repository's half of
    the salt."""
    from svoc_torch.ops._build import CSRC, NVCC_FLAGS

    digest = hashlib.sha256()
    for path in sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()


def cache_salt() -> str:
    """``torch<version>-cuda<version>-k<kernel digest>``: the versioned
    subdirectory's name."""
    import torch

    return f"torch{torch.__version__}-cuda{torch.version.cuda or 'none'}-k{kernel_revision()[:12]}"


def persistent_cache_dir(base_dir: str) -> str:
    """The salted cache directory under ``base_dir`` (not created)."""
    return os.path.join(base_dir, CACHE_DIRNAME, cache_salt())


def enabled_cache_dir() -> Optional[str]:
    """The directory the last :func:`enable_persistent_cache` enabled, or None."""
    with _state_lock:
        return _enabled_dir


def enable_persistent_cache(
    base_dir: str,
    *,
    max_bytes: int = DEFAULT_MAX_BYTES,
    metrics: Optional[MetricsRegistry] = None,
) -> Optional[str]:
    """Point this process's kernel builds and loads under ``base_dir``.

    Creates the salted directory, deletes its sibling stale salts, points
    :mod:`svoc_torch.ops._build` at it and runs one eviction pass.
    Idempotent.  Returns the cache directory, or None when it cannot be
    created: the failure is counted (``compile_cache_errors{op="enable"}``)
    and logged, and the builds stay where they were, as the reference
    serves uncached rather than fail a recovery."""
    from svoc_torch.ops import _build

    reg = metrics or _default_registry
    target = persistent_cache_dir(base_dir)
    try:
        os.makedirs(target, exist_ok=True)
        parent = os.path.dirname(target)
        for name in os.listdir(parent):
            stale = os.path.join(parent, name)
            if stale != target and os.path.isdir(stale):
                shutil.rmtree(stale, ignore_errors=True)
                reg.counter("compile_cache_invalidated", labels={"salt": name}).add(1)
    except OSError as e:
        reg.counter("compile_cache_errors", labels={"op": "enable"}).add(1)
        logging.getLogger(__name__).warning(
            "persistent kernel cache NOT enabled (%s: %s); kernels keep building "
            "into %s", type(e).__name__, e, _build.build_dir())
        return None
    _build.set_build_dir(target)
    global _enabled_dir
    with _state_lock:
        _enabled_dir = target
    evict_cache(target, max_bytes, metrics=reg)
    return target


def disable_persistent_cache() -> None:
    """Point the builds back at ``svoc_torch/_build/`` and forget the
    enabled directory."""
    from svoc_torch.ops import _build

    _build.set_build_dir(None)
    global _enabled_dir
    with _state_lock:
        _enabled_dir = None


def _entries(cache_dir: str) -> List[Tuple[str, float, int]]:
    """``(path, last loaded, bytes)`` of every library in ``cache_dir``
    (a build's ``.tmp`` file in progress is no entry)."""
    out: List[Tuple[str, float, int]] = []
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return out
    for name in names:
        if name.endswith(".tmp"):
            continue
        path = os.path.join(cache_dir, name)
        try:
            out.append((path, os.path.getmtime(path), os.path.getsize(path)))
        except OSError:
            continue
    return out


def evict_cache(
    cache_dir: str,
    max_bytes: int,
    *,
    metrics: Optional[MetricsRegistry] = None,
) -> Dict[str, float]:
    """Delete the libraries loaded least recently until ``cache_dir``
    fits ``max_bytes``; returns ``{bytes, evicted}``.  Evictions count
    into ``compile_cache_evictions`` and the resident size is the gauge
    ``compile_cache_bytes``.  A library a live process has loaded stays
    mapped; the next process builds it anew."""
    reg = metrics or _default_registry
    entries = sorted(_entries(cache_dir), key=lambda e: e[1])
    total = sum(size for _p, _t, size in entries)
    evicted = 0
    while entries and total > max_bytes:
        path, _last, size = entries.pop(0)
        try:
            os.remove(path)
        except OSError:
            continue
        total -= size
        evicted += 1
    if evicted:
        reg.counter("compile_cache_evictions").add(evicted)
    reg.gauge("compile_cache_bytes").set(float(max(0, total)))
    return {"bytes": float(max(0, total)), "evicted": float(evicted)}


def cache_stats(cache_dir: Optional[str] = None) -> Dict[str, float]:
    """``{entries, bytes}`` of the enabled (or given) cache directory;
    zeros when none is enabled."""
    cache_dir = cache_dir if cache_dir is not None else enabled_cache_dir()
    if not cache_dir:
        return {"entries": 0.0, "bytes": 0.0}
    entries = _entries(cache_dir)
    return {"entries": float(len(entries)), "bytes": float(sum(s for _p, _t, s in entries))}
