"""The compile plane's two routings, resolved once per constructor.

Mirrors ``svoc_tpu/consensus/dispatch.py:206-267``
(``ALLOWED_WARMUP_MODES``, ``resolve_warmup_mode``,
``ALLOWED_COMPILATION_CACHES``, ``resolve_compilation_cache``,
``CompilePlaneError``).  The reference reads its default from the
committed ``PERF_DECISIONS.json`` (``"warmup_mode": "prewarm"``,
``"compilation_cache": "persistent"``); the port reads no file of the
JAX package and keeps those decisions as :data:`DEFAULT_WARMUP_MODE` and
:data:`DEFAULT_COMPILATION_CACHE`, as
:func:`svoc_torch.resilience.retry.resolve_commit_mode` keeps the commit
mode's.  The environment still wins.
"""

from __future__ import annotations

import os

ALLOWED_WARMUP_MODES = ("none", "prewarm")
WARMUP_MODE_ENV = "SVOC_WARMUP"
#: The committed decision (``PERF_DECISIONS.json:6``).
DEFAULT_WARMUP_MODE = "prewarm"

ALLOWED_COMPILATION_CACHES = ("off", "persistent")
COMPILATION_CACHE_ENV = "SVOC_COMPILATION_CACHE"
#: The committed decision (``PERF_DECISIONS.json:7``).
DEFAULT_COMPILATION_CACHE = "persistent"


class CompilePlaneError(ValueError):
    """An unknown warmup mode or compilation-cache mode was requested."""


def _resolve(what: str, env: str, default: str, allowed) -> str:
    raw = os.environ.get(env, "").strip()
    mode, source = (raw, env) if raw else (default, "the committed default")
    if mode not in allowed:
        names = ", ".join(repr(v) for v in allowed)
        raise CompilePlaneError(
            f"{what} {mode!r} (from {source}) is not a known mode: allowed values "
            f"are {names}; set {env} to override the default"
        )
    return mode


def resolve_warmup_mode() -> str:
    """``SVOC_WARMUP`` when set, else :data:`DEFAULT_WARMUP_MODE`.
    ``"prewarm"`` walks the claim-cube shape universe ahead of traffic
    (:mod:`svoc_torch.compile.prewarm`) when the serving loop starts or a
    recovery asks; ``"none"`` leaves every first dispatch to load its
    kernel inline.  Warmup never journals and never changes numerics."""
    return _resolve("warmup_mode", WARMUP_MODE_ENV, DEFAULT_WARMUP_MODE, ALLOWED_WARMUP_MODES)


def resolve_compilation_cache() -> str:
    """``SVOC_COMPILATION_CACHE`` when set, else
    :data:`DEFAULT_COMPILATION_CACHE`.  ``"persistent"`` puts the kernel
    build directory under the durability directory
    (:func:`svoc_torch.compile.cache.enable_persistent_cache`) when a
    :class:`~svoc_torch.durability.recovery.RecoveryManager` is built; a
    cached and a fresh build are the same library."""
    return _resolve("compilation_cache", COMPILATION_CACHE_ENV, DEFAULT_COMPILATION_CACHE,
                    ALLOWED_COMPILATION_CACHES)
