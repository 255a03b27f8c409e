"""The compile plane (the port's counterpart of :mod:`svoc_tpu.compile`,
``compile/__init__.py:1-82``).

- :mod:`svoc_torch.compile.universe`: the reachable claim-cube dispatch
  keys, enumerated from live configuration;
- :mod:`svoc_torch.compile.prewarm`: the worker that walks that universe
  ahead of traffic (builds or loads the claim-cube kernel, primes each
  key's dispatch) with ``compile_prewarm{outcome=}`` accounting;
- :mod:`svoc_torch.compile.cache`: the persistent kernel cache under the
  durability directory (versioned salt, size-capped eviction), so that a
  restart loads its kernels instead of building them;
- :mod:`svoc_torch.compile.modes`: ``warmup_mode`` and
  ``compilation_cache``, resolved from the environment and the committed
  defaults.

The plane never journals and never changes numerics: the seeded
fingerprints are the same with it on or off
(:mod:`svoc_torch.tools.coldstart_smoke` is the gate).  The exports are
lazy (PEP 562), as the reference's are, so that importing one module
does not import the others.
"""

from typing import TYPE_CHECKING

_EXPORTS = {
    "cache_salt": "svoc_torch.compile.cache",
    "cache_stats": "svoc_torch.compile.cache",
    "enable_persistent_cache": "svoc_torch.compile.cache",
    "evict_cache": "svoc_torch.compile.cache",
    "kernel_revision": "svoc_torch.compile.cache",
    "persistent_cache_dir": "svoc_torch.compile.cache",
    "PrewarmConfig": "svoc_torch.compile.prewarm",
    "PrewarmWorker": "svoc_torch.compile.prewarm",
    "CompileKey": "svoc_torch.compile.universe",
    "dispatch_key": "svoc_torch.compile.universe",
    "enumerate_universe": "svoc_torch.compile.universe",
    "registry_groups": "svoc_torch.compile.universe",
}

__all__ = sorted(_EXPORTS)

if TYPE_CHECKING:  # pragma: no cover — the eager twins, for tooling
    from svoc_torch.compile.cache import (  # noqa: F401
        cache_salt,
        cache_stats,
        enable_persistent_cache,
        evict_cache,
        kernel_revision,
        persistent_cache_dir,
    )
    from svoc_torch.compile.prewarm import PrewarmConfig, PrewarmWorker  # noqa: F401
    from svoc_torch.compile.universe import (  # noqa: F401
        CompileKey,
        dispatch_key,
        enumerate_universe,
        registry_groups,
    )


def __getattr__(name: str):
    module_name = _EXPORTS.get(name)
    if module_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module_name), name)
