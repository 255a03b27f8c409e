"""The port's compile plane against the JAX package's, on the CPU.

Twins of ``tests/test_compile_plane.py``'s classes:

- ``TestUniverse``: the enumeration against the reference's, donate
  twins and the sharded kinds included, key for key and in order;
- ``TestPersistentCache``: the salt, stale-salt removal, eviction of the
  library loaded least recently and the stats, on fake library files,
  and loads from a directory that refuses the hit's touch;
- ``TestResolution``: ``SVOC_WARMUP`` and ``SVOC_COMPILATION_CACHE``
  over the committed defaults, pinned at construction;
- ``TestPrewarm``: outcomes, the budget, the defer gate's primary keys,
  the warmth accounting, and a worker that never journals;
- ``TestColdShapeDeferral``: the reference's ``_FakeWorker`` pattern
  through the port's serving tier;
- ``TestRecoveryIntegration``: the cache under the durability
  directory and the recovery prewarm;
- ``TestCompileMonitoring`` and ``TestProfiler``: the build listener's
  hit and miss series (a stand-in ``nvcc`` that builds a C library with
  the host compiler), the runtime gauges, the MFU gauge and the
  ``torch.profiler`` capture.

Every test that switches the process's kernel build directory puts it
back (the ``build_dir`` fixture).
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import stat

import numpy as np
import pytest

pytest.importorskip("jax")
import torch

from svoc_tpu.compile import universe as ref_universe
from svoc_tpu.consensus.kernel import ConsensusConfig as RefConfig
from svoc_tpu.fabric.registry import ClaimRegistry as RefRegistry
from svoc_tpu.fabric.registry import ClaimSpec as RefSpec

from svoc_torch.compile import cache, modes, prewarm, universe
from svoc_torch.compile.prewarm import PrewarmConfig, PrewarmWorker, warm_keys
from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.fabric.registry import ClaimRegistry, ClaimSpec
from svoc_torch.fabric.router import ClaimRouter
from svoc_torch.ops import _build
from svoc_torch.utils import metrics as metrics_mod
from svoc_torch.utils.metrics import MetricsRegistry

CFG = ConsensusConfig(n_failing=2, constrained=True)


@pytest.fixture
def build_dir():
    """Restore the process's kernel build directory and cache state."""
    previous = _build.build_dir()
    yield
    cache.disable_persistent_cache()
    _build.set_build_dir(previous)


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch, build_dir):
    """A stand-in ``nvcc`` (the host's C compiler building a one-function
    library at the ``-o`` path) over a scratch source directory, with the
    process's loaded libraries set aside; ``fail`` makes it exit 1."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("probe", *prewarm.SERVING_KERNELS):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        '[ -f "$0.fail" ] && exit 1\n'
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        "printf 'int svoc_probe(void) { return 7; }\\n' > \"$out.c\"\n"
        'cc -shared -fPIC -o "$out" "$out.c" && rm "$out.c"\n'
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_built", set())
    _build.set_build_dir(tmp_path / "build")
    return script


def _events(monkeypatch):
    """The build and hit events of ``_build`` from here on, as
    ``(event, name)`` pairs (the process's own listeners set aside)."""
    events = []
    monkeypatch.setattr(_build, "_listeners", [])
    _build.add_listener(lambda event, name, _seconds: events.append((event, name)))
    return events


def bare_registry(cls=ClaimRegistry, spec=ClaimSpec, n_claims=3, n_oracles=7, dimension=6):
    reg = cls()
    for i in range(n_claims):
        reg.add(spec(claim_id=f"c{i}", n_oracles=n_oracles, dimension=dimension), None, None)
    return reg


def ident(key):
    """A key's identity across the packages (the impl is each package's route)."""
    return (key.kind, key.bucket, key.n_oracles, key.dimension, dataclasses.astuple(key.cfg), key.donate,
            key.mesh)


def ref_groups(groups):
    return {(n, m, RefConfig(**dataclasses.asdict(cfg))): c for (n, m, cfg), c in groups.items()}


# ---------------------------------------------------------------------------
# The universe
# ---------------------------------------------------------------------------


class TestUniverse:
    def test_registry_groups_counts_unpaused_claims_per_group(self):
        reg = bare_registry()
        reg.add(ClaimSpec(claim_id="big", n_oracles=16, dimension=6), None, None)
        ref = bare_registry(RefRegistry, RefSpec)
        ref.add(RefSpec(claim_id="big", n_oracles=16, dimension=6), None, None)
        groups = universe.registry_groups(reg)
        assert groups[(7, 6, CFG)] == 3 and groups[(16, 6, CFG)] == 1
        assert ref_groups(groups) == ref_universe.registry_groups(ref)
        reg.get("c0").paused = True
        ref.get("c0").paused = True
        assert ref_groups(universe.registry_groups(reg)) == ref_universe.registry_groups(ref)

    @pytest.mark.parametrize("sanitized", [False, True])
    @pytest.mark.parametrize("cap,groups", [
        (8, {(7, 6, CFG): 3}),
        (4, {(7, 6, CFG): 4, (16, 6, ConsensusConfig(n_failing=4)): 1}),
        (64, {(7, 6, CFG): 64, (9, 6, ConsensusConfig(constrained=False)): 5}),
    ])
    @pytest.mark.parametrize("twins", [False, True])
    def test_universe_is_the_references_without_donate_twins(self, sanitized, cap, groups, twins):
        ours = universe.enumerate_universe(groups, max_claims_per_batch=cap, sanitized_dispatch=sanitized,
                                           impl="plain", include_twins=twins)
        ref = ref_universe.enumerate_universe(ref_groups(groups), max_claims_per_batch=cap,
                                              sanitized_dispatch=sanitized, donate=False, impl="xla",
                                              include_twins=twins)
        # The donate twins are the port's too now: the whole list, in order.
        assert [ident(k) for k in ours] == [ident(k) for k in ref]
        assert any(k.donate for k in ours) == twins
        assert len(ours) == len(set(ours)) and all(k.impl == "plain" for k in ours)
        assert universe.universe_summary(ours) == ref_universe.universe_summary(ref)

    def test_serving_critical_bucket_first_then_ladder_then_twins(self):
        keys = universe.enumerate_universe({(7, 6, CFG): 3}, max_claims_per_batch=8,
                                           sanitized_dispatch=True, impl="cuda")
        assert keys[0] == universe.CompileKey(kind="sanitized", bucket=4, n_oracles=7, dimension=6, cfg=CFG,
                                              impl="cuda")
        assert [k.bucket for k in keys[:4]] == [4, 1, 2, 8] and all(k.kind == "sanitized" for k in keys[:4])
        assert not any(k.donate for k in keys[:4])
        # Per bucket: the other fusion, the donate flip, then both flipped.
        assert [(k.bucket, k.kind, k.donate) for k in keys[4:]] == [
            (b, kind, donate) for b in (1, 2, 4, 8)
            for kind, donate in (("gated", False), ("sanitized", True), ("gated", True))]

    @pytest.mark.parametrize("sanitized", [False, True])
    @pytest.mark.parametrize("mesh,claim_size", [("2x4", 2), ("4x2", 4), ("8x1", 8), ("3x1", 3)])
    def test_sharded_universe_is_the_references(self, sanitized, mesh, claim_size):
        """A meshed router's universe: the ``sharded_*`` kind, labelled
        ``@mesh``, over a ladder padded to the claim axis, no twins."""
        groups = {(8, 6, CFG): 3, (16, 6, ConsensusConfig(n_failing=4)): 5}
        ours = universe.enumerate_universe(groups, max_claims_per_batch=8, sanitized_dispatch=sanitized,
                                           impl="plain", donate=True, mesh=mesh, mesh_claim_size=claim_size)
        ref = ref_universe.enumerate_universe(ref_groups(groups), max_claims_per_batch=8,
                                              sanitized_dispatch=sanitized, donate=True, impl="xla",
                                              mesh=mesh, mesh_claim_size=claim_size)
        assert [ident(k) for k in ours] == [ident(k) for k in ref]
        assert [k.label() for k in ours] == [k.label() for k in ref]
        assert all(k.kind.startswith("sharded_") and k.label().endswith(f"@{mesh}") for k in ours)
        assert all(k.bucket % claim_size == 0 and not k.donate for k in ours)

    @pytest.mark.parametrize("cap,multiple", [(1, 1), (8, 1), (8, 3), (64, 2), (100, 1)])
    def test_bucket_ladder_is_the_references(self, cap, multiple):
        assert universe.bucket_ladder(cap, multiple_of=multiple) == ref_universe.bucket_ladder(
            cap, multiple_of=multiple)

    def test_pending_universe_from_specs(self):
        specs = [ClaimSpec(claim_id=f"p{i}", n_oracles=7 + (i % 2)) for i in range(5)]
        ref_specs = [RefSpec(claim_id=f"p{i}", n_oracles=7 + (i % 2)) for i in range(5)]
        ours = universe.pending_universe(specs, max_claims_per_batch=4, sanitized_dispatch=True, impl="cuda")
        ref = ref_universe.pending_universe(ref_specs, max_claims_per_batch=4, sanitized_dispatch=True,
                                            donate=False, impl="xla")
        assert [ident(k) for k in ours] == [ident(k) for k in ref]

    def test_dispatch_key_matches_enumerated_identity_and_validation(self):
        key = universe.dispatch_key(sanitized=True, sharded=False, bucket=4, n_oracles=7, dimension=6,
                                    cfg=CFG, donate=False, impl="plain", mesh=None)
        assert key in universe.enumerate_universe({(7, 6, CFG): 4}, max_claims_per_batch=4,
                                                  sanitized_dispatch=True, impl="plain")
        with pytest.raises(ValueError):
            universe.CompileKey(kind="nope", bucket=1, n_oracles=7, dimension=6, cfg=CFG)
        with pytest.raises(ValueError):
            universe.CompileKey(kind="gated", bucket=0, n_oracles=7, dimension=6, cfg=CFG)
        with pytest.raises(ValueError):
            universe.bucket_ladder(0)


# ---------------------------------------------------------------------------
# The persistent kernel cache
# ---------------------------------------------------------------------------


def _write(path, size, age=0.0):
    with open(path, "w") as f:
        f.write("x" * size)
    if age:
        now = os.path.getmtime(path)
        os.utime(path, (now - age, now - age))


class TestPersistentCache:
    def test_salt_covers_torch_cuda_and_kernel_revision(self):
        salt = cache.cache_salt()
        assert torch.__version__ in salt and f"cuda{torch.version.cuda or 'none'}" in salt
        assert cache.kernel_revision()[:12] in salt

    def test_kernel_revision_covers_sources_headers_and_flags(self, tmp_path, monkeypatch):
        (tmp_path / "k.cu").write_text("// k\n")
        (tmp_path / "h.cuh").write_text("// h\n")
        (tmp_path / "notes.txt").write_text("not compiled")
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        first = cache.kernel_revision()
        (tmp_path / "notes.txt").write_text("still not compiled")
        assert cache.kernel_revision() == first
        (tmp_path / "h.cuh").write_text("// h2\n")
        second = cache.kernel_revision()
        assert second != first
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
        assert cache.kernel_revision() != second

    def test_salt_change_invalidates_old_entries(self, tmp_path, monkeypatch, build_dir):
        base = str(tmp_path)
        monkeypatch.setattr(cache, "cache_salt", lambda: "saltA")
        dir_a = cache.enable_persistent_cache(base, metrics=MetricsRegistry())
        assert dir_a.endswith("saltA") and str(_build.build_dir()) == dir_a
        _write(os.path.join(dir_a, "libold-0.so"), 100)
        monkeypatch.setattr(cache, "cache_salt", lambda: "saltB")
        reg = MetricsRegistry()
        dir_b = cache.enable_persistent_cache(base, metrics=reg)
        assert dir_b != dir_a and not os.path.exists(dir_a)
        assert str(_build.build_dir()) == dir_b == cache.enabled_cache_dir()
        assert reg.counter("compile_cache_invalidated", labels={"salt": "saltA"}).count == 1

    def test_eviction_drops_least_recently_loaded_until_under_cap(self, tmp_path):
        for i, age in [(0, 100), (1, 50), (2, 10)]:
            _write(tmp_path / f"libk{i}-0.so", 1000, age)
        _write(tmp_path / "libk3-0.so.77.tmp", 5000)  # a build in progress is no entry
        reg = MetricsRegistry()
        stats = cache.evict_cache(str(tmp_path), 2500, metrics=reg)
        assert stats == {"bytes": 2000.0, "evicted": 1.0}
        assert not (tmp_path / "libk0-0.so").exists() and (tmp_path / "libk2-0.so").exists()
        assert (tmp_path / "libk3-0.so.77.tmp").exists()
        assert reg.counter("compile_cache_evictions").count == 1
        assert reg.gauge("compile_cache_bytes").get() == 2000.0
        assert cache.cache_stats(str(tmp_path)) == {"entries": 2.0, "bytes": 2000.0}

    def test_a_load_makes_a_library_the_most_recent(self, fake_nvcc):
        reg = MetricsRegistry()
        _build.load("probe")
        path = _build.library_path("probe")
        _write(_build.build_dir() / "libother-0.so", path.stat().st_size, age=10)
        old = path.stat().st_mtime - 100
        os.utime(path, (old, old))
        _build._loaded.clear()
        _build._built.clear()
        _build.load("probe")  # a hit touches the file
        cache.evict_cache(str(_build.build_dir()), path.stat().st_size, metrics=reg)
        assert path.exists() and not (_build.build_dir() / "libother-0.so").exists()

    def test_a_hit_in_the_package_directory_touches_nothing(self, fake_nvcc, tmp_path, monkeypatch):
        _build.load("probe")
        monkeypatch.setattr(_build, "BUILD_DIR", _build.build_dir())
        _build.set_build_dir(None)  # the package's own directory, no cache enabled
        path = _build.library_path("probe")
        old = path.stat().st_mtime - 100
        os.utime(path, (old, old))
        _build._loaded.clear()
        _build._built.clear()
        assert _build.load("probe").svoc_probe() == 7
        assert path.stat().st_mtime == old

    def test_a_directory_that_refuses_the_touch_still_loads(self, fake_nvcc, monkeypatch):
        events = _events(monkeypatch)
        _build.load("probe")
        directory = _build.build_dir()

        def refused(*args, **kwargs):
            raise PermissionError(1, "Operation not permitted")

        monkeypatch.setattr(os, "utime", refused)  # another owner's library (root ignores the mode)
        mode = directory.stat().st_mode
        directory.chmod(0o555)
        try:
            _build._loaded.clear()
            _build._built.clear()
            assert _build.load("probe").svoc_probe() == 7
        finally:
            directory.chmod(mode)
        assert events == [("miss", "probe"), ("hit", "probe")]

    def test_a_build_is_fsynced_before_and_after_its_rename(self, fake_nvcc, monkeypatch):
        """The library, then its rename, then its directory: a persistent
        build directory must not come back from a crash with an empty
        library under the final name."""
        steps = []
        fsync, replace = os.fsync, os.replace

        def recording_fsync(fd):
            steps.append(("fsync", os.readlink(f"/proc/self/fd/{fd}")))
            return fsync(fd)

        def recording_replace(src, dst):
            steps.append(("replace", str(dst)))
            return replace(src, dst)

        monkeypatch.setattr(os, "fsync", recording_fsync)
        monkeypatch.setattr(os, "replace", recording_replace)
        out = _build.library_path("probe")
        assert _build.load("probe").svoc_probe() == 7
        assert [kind for kind, _ in steps] == ["fsync", "replace", "fsync"]
        assert steps[0][1].endswith(".tmp") and steps[1][1] == str(out) and steps[2][1] == str(out.parent)

    def test_load_all_builds_every_missing_source_at_once(self, fake_nvcc, monkeypatch):
        _build.load("probe")
        _build._loaded.clear()
        _build._built.clear()
        events = _events(monkeypatch)
        calls = []
        build = _build.build
        monkeypatch.setattr(_build, "build", lambda names: calls.append(list(names)) or build(names))
        libs = _build.load_all(("probe", *prewarm.SERVING_KERNELS))
        assert [lib.svoc_probe() for lib in libs.values()] == [7] * (1 + len(prewarm.SERVING_KERNELS))
        assert calls[0] == list(prewarm.SERVING_KERNELS)  # one parallel build; probe was on disk
        assert sorted(events) == sorted([("hit", "probe")] + [("miss", n) for n in prewarm.SERVING_KERNELS])
        n_calls = len(calls)
        assert _build.load_all(prewarm.SERVING_KERNELS).keys() == set(prewarm.SERVING_KERNELS)
        assert len(events) == 1 + len(prewarm.SERVING_KERNELS) and len(calls) == n_calls  # all loaded

    def test_enable_is_idempotent_salted_and_counts_failures(self, tmp_path, build_dir):
        reg = MetricsRegistry()
        d1 = cache.enable_persistent_cache(str(tmp_path), max_bytes=cache.DEFAULT_MAX_BYTES, metrics=reg)
        d2 = cache.enable_persistent_cache(str(tmp_path), metrics=reg)
        assert d1 == d2 == cache.persistent_cache_dir(str(tmp_path)) and os.path.isdir(d1)
        assert d1.startswith(os.path.join(str(tmp_path), "kernel_cache"))
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        assert cache.enable_persistent_cache(str(blocker), metrics=reg) is None
        assert reg.counter("compile_cache_errors", labels={"op": "enable"}).count == 1
        assert str(_build.build_dir()) == d1  # unchanged by the failure
        cache.disable_persistent_cache()
        assert _build.build_dir() == _build.BUILD_DIR and cache.enabled_cache_dir() is None


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


class TestResolution:
    def test_env_beats_the_committed_default(self, monkeypatch):
        monkeypatch.delenv("SVOC_WARMUP", raising=False)
        monkeypatch.delenv("SVOC_COMPILATION_CACHE", raising=False)
        assert modes.resolve_warmup_mode() == "prewarm"
        assert modes.resolve_compilation_cache() == "persistent"
        monkeypatch.setenv("SVOC_WARMUP", "none")
        monkeypatch.setenv("SVOC_COMPILATION_CACHE", "off")
        assert (modes.resolve_warmup_mode(), modes.resolve_compilation_cache()) == ("none", "off")
        monkeypatch.setenv("SVOC_COMPILATION_CACHE", "bogus")
        with pytest.raises(modes.CompilePlaneError, match="SVOC_COMPILATION_CACHE"):
            modes.resolve_compilation_cache()
        monkeypatch.setenv("SVOC_WARMUP", "bogus")
        with pytest.raises(modes.CompilePlaneError):
            modes.resolve_warmup_mode()

    def test_router_pins_warmup_mode_at_construction(self, monkeypatch):
        monkeypatch.setenv("SVOC_WARMUP", "prewarm")
        router = ClaimRouter(bare_registry(), metrics=MetricsRegistry(), device="cpu")
        monkeypatch.setenv("SVOC_WARMUP", "none")
        assert router.warmup_mode == "prewarm"
        assert ClaimRouter(bare_registry(), warmup_mode="none", device="cpu").warmup_mode == "none"


# ---------------------------------------------------------------------------
# The prewarm worker and the warmth accounting
# ---------------------------------------------------------------------------


def _worker(n_claims=2, cap=2, **config):
    reg = MetricsRegistry()
    registry = bare_registry(n_claims=n_claims)
    router = ClaimRouter(registry, max_claims_per_batch=cap, metrics=reg, warmup_mode="prewarm", device="cpu")
    worker = PrewarmWorker(router, registry, metrics=reg, config=PrewarmConfig(**config))
    return reg, router, worker


class TestPrewarm:
    def test_warm_all_primes_the_universe_and_marks_it_warm(self):
        reg, _router, worker = _worker(include_twins=False)
        report = worker.warm_all()
        assert report["outcomes"] == {"primed": 2}  # buckets 1 and 2, nothing to build on the CPU
        assert worker.stats()["warmed"] == report["warmed"] == 2
        assert all(worker.is_warm(k) for k in worker.universe())
        assert reg.counter("compile_prewarm", labels={"outcome": "primed"}).count == 2
        assert not worker.group_cold(7, 6, CFG)

    def test_budget_exhaustion_is_counted_and_cuts_the_tail(self):
        clock = {"t": 0.0}

        def fake_clock():
            clock["t"] += 10.0  # every reading costs 10 s
            return clock["t"]

        reg = MetricsRegistry()
        registry = bare_registry(n_claims=2)
        router = ClaimRouter(registry, max_claims_per_batch=4, metrics=reg, warmup_mode="prewarm", device="cpu")
        worker = PrewarmWorker(router, registry, metrics=reg, clock=fake_clock,
                               config=PrewarmConfig(budget_s=15.0, include_twins=False))
        report = worker.warm_all()
        assert report["outcomes"]["budget_exhausted"] > 0
        assert reg.counter("compile_prewarm", labels={"outcome": "budget_exhausted"}).count == (
            report["outcomes"]["budget_exhausted"])
        assert report["warmed"] >= 1 and worker.is_warm(worker.universe()[0])  # the head first

    def test_prewarmed_numerics_match_an_unwarmed_dispatch_bitwise(self):
        from svoc_torch.consensus.batch import claims_consensus_gated

        rng = np.random.default_rng(3)
        values = torch.from_numpy(rng.uniform(0.05, 0.95, size=(2, 7, 6)).astype(np.float32))
        ok, mask = torch.ones(2, 7, dtype=torch.bool), torch.ones(2, dtype=torch.bool)
        cold = claims_consensus_gated(values, ok, mask, CFG)
        _worker(include_twins=True)[2].warm_all()
        warm = claims_consensus_gated(values, ok, mask, CFG)
        for a, b in zip(cold, warm):
            assert torch.equal(a, b)

    def test_defer_gate_closes_on_primary_keys_not_twins(self):
        _reg, _router, worker = _worker(include_twins=True)
        worker.universe(refresh=True)
        worker._started = True  # mid-walk: active, nothing warm yet
        assert worker.group_cold(7, 6, CFG)
        for key in worker._primary_keys(7, 6, CFG):
            assert worker.step(key) == "primed"
        assert not worker.group_cold(7, 6, CFG)
        assert [k for k in worker.universe() if not worker.is_warm(k)]  # the twins
        assert worker.group_cold(9, 6, CFG)  # a group registered after the enumeration
        worker._done.set()
        assert not worker.group_cold(9, 6, CFG)  # a finished walk defers nothing

    def test_prime_less_walk_never_fakes_warmth_on_the_cpu(self):
        reg, _router, worker = _worker(n_claims=1, cap=1, prime=False, include_twins=False)
        key = worker.universe(refresh=True)[0]
        assert key.impl == "plain" and worker.step(key) == "skipped" and not worker.is_warm(key)
        assert reg.counter("compile_prewarm", labels={"outcome": "skipped"}).count == 1

    def test_cuda_keys_build_the_claim_kernel(self, fake_nvcc):
        reg, router, worker = _worker(n_claims=1, cap=2, prime=False, include_twins=False)
        router.consensus_impl = "cuda"  # the card's route, without dispatching
        report = worker.warm_all()
        assert report["outcomes"] == {"compiled": 2}
        assert all(_build.library_path(name).exists() for name in prewarm.SERVING_KERNELS)
        assert reg.histogram("prewarm_compile_seconds").count == 2
        keys = worker.universe()
        assert warm_keys(keys, metrics=reg) == {"compiled": 2, "skipped": 0, "deferred": 0}
        plain = [dataclasses.replace(k, impl="plain") for k in keys]
        assert warm_keys(plain, metrics=reg) == {"compiled": 0, "skipped": 2, "deferred": 0}
        clock = iter(range(100))
        assert warm_keys(keys, budget_s=0.5, clock=lambda: next(clock))["deferred"] == 2

    def test_a_cuda_walk_primes_each_group_once(self, fake_nvcc, monkeypatch):
        reg, router, worker = _worker(n_claims=4, cap=4, include_twins=False)
        router.consensus_impl = "cuda"
        primed = []
        monkeypatch.setattr(worker, "_prime", lambda key: primed.append(key.bucket))
        report = worker.warm_all()
        assert report["outcomes"] == {"compiled": 3} and report["warmed"] == 3  # buckets 1, 2 and 4
        assert primed == [worker.universe()[0].bucket]

    def test_a_failed_build_counts_error_and_the_walk_goes_on(self, fake_nvcc):
        reg, router, worker = _worker(n_claims=1, cap=2, include_twins=False)
        router.consensus_impl = "cuda"
        (fake_nvcc.parent / "nvcc.fail").write_text("")
        report = worker.warm_all()
        assert report["outcomes"] == {"error": 2}
        assert not any(worker.is_warm(k) for k in worker.universe())

    def test_worker_never_touches_a_journal(self):
        source = inspect.getsource(prewarm)
        for forbidden in ("resolve_journal", ".emit(", "svoc_torch.utils.events", "EventJournal"):
            assert forbidden not in source, forbidden

    def test_router_warmth_accounting_cold_then_warm_then_prewarmed(self):
        reg = MetricsRegistry()

        def count(warmth):
            return reg.counter("consensus_dispatch", labels={"warmth": warmth}).count

        registry = bare_registry(n_claims=2)
        router = ClaimRouter(registry, max_claims_per_batch=2, metrics=reg, warmup_mode="none", device="cpu")
        key, warmth = router._account_warmth(2, 7, 6, CFG)
        assert warmth == "cold"
        router._account_warmth(2, 7, 6, CFG)  # the dispatch raised: still cold
        assert (count("cold"), count("warm")) == (2.0, 0.0)
        router._warmth_seen.add(key)
        assert router._account_warmth(2, 7, 6, CFG)[1] == "warm"
        worker = PrewarmWorker(router, registry, metrics=reg, config=PrewarmConfig(include_twins=False))
        router.attach_prewarmer(worker)
        worker.warm_all()
        assert router._account_warmth(1, 7, 6, CFG)[1] == "prewarmed"
        assert count("prewarmed") == 1.0

    def test_background_walk_and_stats(self):
        _reg, _router, worker = _worker()
        thread = worker.start()
        assert worker.start() is thread or not thread.is_alive()
        assert worker.wait(60) and not worker.active
        stats = worker.stats()
        assert stats["universe"] == stats["warmed"] == 8 and stats["report"]["outcomes"] == {"primed": 8}


# ---------------------------------------------------------------------------
# Serving: cold shapes wait, nothing is lost
# ---------------------------------------------------------------------------


def _tier(**kwargs):
    from svoc_torch.fabric.session import MultiSession
    from svoc_torch.io.comment_store import CommentStore
    from svoc_torch.serving.tier import ServingTier
    from svoc_torch.utils.events import EventJournal

    def vec(texts):
        rng = np.random.default_rng([abs(hash(t)) % 2**31 for t in texts] or [0])
        v = rng.uniform(0.05, 0.95, size=(len(texts), 6))
        return v / v.sum(axis=1, keepdims=True)

    multi = MultiSession(base_seed=0, vectorizer=vec, store_factory=lambda cid: CommentStore(),
                         journal=EventJournal(), metrics=MetricsRegistry(), lineage_scope="cp",
                         sanitized_dispatch=True, warmup_mode="none", device="cpu")
    for name in ("alpha", "beta"):
        multi.add_claim(ClaimSpec(claim_id=name, n_oracles=7, dimension=6))
    return multi, ServingTier(multi, vectorizer=vec, **kwargs)


class _FakeWorker:
    """A controllable prewarmer double: active, and cold by group."""

    def __init__(self):
        self.active = True
        self.cold_groups = set()

    def claim_cold(self, spec):
        return (spec.n_oracles, spec.dimension, spec.consensus_config()) in self.cold_groups

    def is_warm(self, key):
        return False

    def stats(self):
        return {"active": self.active, "warmed": 0, "universe": 0, "report": None}


class TestColdShapeDeferral:
    def test_defer_then_serve_accounting(self):
        worker = _FakeWorker()
        worker.cold_groups = {(7, 6, CFG)}
        multi, tier = _tier(prewarmer=worker)
        assert tier.prewarmer is worker
        reg = multi.metrics
        out = tier.submit("alpha", "first comment while cold")
        assert (out["status"], out["reason"]) == ("deferred", "cold_shape")
        assert tier.frontend.depth("alpha") == 1
        assert reg.family_total("serving_admitted") == 1 and reg.family_total("serving_shed") == 0
        assert reg.counter("serving_deferred", labels={"claim": "alpha", "reason": "cold_shape"}).count == 1
        events = multi._resolve_journal().recent(type="serving.deferred")
        assert events and events[-1].data["reason"] == "cold_shape"
        assert tier.step()["requests"] == 0 and tier.frontend.depth("alpha") == 1
        worker.cold_groups = set()
        report = tier.step()
        assert report["requests"] == 1 and "alpha" in report["served"]
        assert reg.family_total("serving_completed") == 1 and reg.family_total("serving_dropped") == 0

    def test_warm_claims_serve_while_sibling_defers(self):
        multi, tier = _tier()
        worker = _FakeWorker()
        worker.cold_groups = {(7, 6, CFG)}
        tier._prewarmer = worker
        multi.add_claim(ClaimSpec(claim_id="gamma", n_oracles=9, dimension=6))
        assert tier.submit("alpha", "cold-path text")["status"] == "deferred"
        assert tier.submit("gamma", "warm-path text")["status"] == "admitted"
        assert tier.step()["served"] == ["gamma"] and tier.frontend.depth("alpha") == 1

    def test_finished_worker_defers_nothing(self):
        _multi, tier = _tier()
        worker = _FakeWorker()
        worker.cold_groups = {(7, 6, CFG)}
        worker.active = False
        tier._prewarmer = worker
        assert tier.submit("alpha", "text after warmup finished")["status"] == "admitted"

    def test_cold_gate_errors_degrade_open(self):
        multi, tier = _tier()

        class Broken:
            active = True

            def claim_cold(self, spec):
                raise RuntimeError("warmth probe broke")

            def stats(self):
                return {}

        tier._prewarmer = Broken()
        assert tier.submit("alpha", "gate failure must still serve")["status"] == "admitted"
        assert multi.metrics.counter("serving_cold_gate_errors").count == 1

    def test_run_loop_activates_the_committed_prewarm_routing(self):
        from svoc_torch.fabric.session import MultiSession
        from svoc_torch.io.comment_store import CommentStore
        from svoc_torch.serving.tier import ServingTier
        from svoc_torch.utils.events import EventJournal

        def vec(texts):
            return np.full((len(texts), 6), 1 / 6)

        multi = MultiSession(base_seed=0, vectorizer=vec, store_factory=lambda cid: CommentStore(),
                             journal=EventJournal(), metrics=MetricsRegistry(), lineage_scope="rl",
                             warmup_mode="prewarm", device="cpu")
        multi.add_claim(ClaimSpec(claim_id="alpha", n_oracles=7))
        tier = ServingTier(multi, vectorizer=vec)
        assert tier.prewarmer is None
        stop = tier.run_loop(period_s=10.0)
        try:
            assert tier.prewarmer is not None and multi.router.prewarmer is tier.prewarmer
            assert tier.prewarmer.wait(120)
            # buckets 1-8, both gate fusions, both donate flips
            assert tier.snapshot()["prewarm"]["warmed"] == 16
        finally:
            stop.set()
            tier.stop_loop()

    def test_queue_full_still_sheds_even_when_cold(self):
        from svoc_torch.serving.frontend import AdmissionConfig

        _multi, tier = _tier(admission=AdmissionConfig(queue_capacity=1))
        worker = _FakeWorker()
        worker.cold_groups = {(7, 6, CFG)}
        tier._prewarmer = worker
        assert tier.submit("alpha", "one")["status"] == "deferred"
        out = tier.submit("alpha", "two")
        assert (out["status"], out["reason"]) == ("shed", "queue_full")


# ---------------------------------------------------------------------------
# Recovery: the cache is durable state, restarts are warm
# ---------------------------------------------------------------------------


class TestRecoveryIntegration:
    def _multi(self, warmup_mode="prewarm", n_oracles=7):
        from svoc_torch.fabric.session import MultiSession
        from svoc_torch.io.comment_store import CommentStore
        from svoc_torch.utils.events import EventJournal

        multi = MultiSession(base_seed=0, vectorizer=lambda texts: np.full((len(texts), 6), 1 / 6),
                             store_factory=lambda cid: CommentStore(), journal=EventJournal(),
                             metrics=MetricsRegistry(), lineage_scope="rw", warmup_mode=warmup_mode,
                             device="cpu")
        multi.add_claim(ClaimSpec(claim_id="alpha", n_oracles=n_oracles))
        return multi

    def test_manager_enables_salted_cache_under_out_dir(self, tmp_path, build_dir):
        from svoc_torch.durability.recovery import RecoveryManager

        manager = RecoveryManager(self._multi(), out_dir=str(tmp_path), compilation_cache="persistent")
        assert manager.compile_cache_dir.startswith(os.path.join(str(tmp_path), "kernel_cache"))
        assert str(_build.build_dir()) == manager.compile_cache_dir
        status = manager.status()
        assert status["compilation_cache"] == "persistent"
        assert status["compile_cache_dir"] == manager.compile_cache_dir
        assert status["compile_cache"] == {"entries": 0.0, "bytes": 0.0}

    def test_manager_off_mode_leaves_cache_disabled(self, tmp_path):
        from svoc_torch.durability.recovery import RecoveryManager

        manager = RecoveryManager(self._multi(), out_dir=str(tmp_path), compilation_cache="off")
        assert manager.compile_cache_dir is None
        assert not os.path.exists(os.path.join(str(tmp_path), "kernel_cache"))
        assert _build.build_dir() == _build.BUILD_DIR

    def test_recover_prewarm_restarts_warm(self, tmp_path, build_dir):
        from svoc_torch.durability.recovery import RecoveryManager

        multi = self._multi(n_oracles=11)
        manager = RecoveryManager(multi, out_dir=str(tmp_path), compilation_cache="persistent")
        report = manager.recover(prewarm=True)
        assert report["prewarm"]["warmed"] > 0 and multi.router.prewarmer is not None
        # The blocking walk is primary-only: the router's own variant.
        assert all(k.kind == "gated" and not k.donate for k in multi.router.prewarmer.universe())
        assert os.path.isdir(manager.compile_cache_dir)  # nothing is built on the CPU

    def test_recover_honors_warmup_mode_none(self, tmp_path):
        from svoc_torch.durability.recovery import RecoveryManager

        multi = self._multi(warmup_mode="none")
        report = RecoveryManager(multi, out_dir=str(tmp_path), compilation_cache="off").recover(prewarm=True)
        assert report["prewarm"] is None and multi.router.prewarmer is None

    def test_a_prewarm_defect_is_counted_not_fatal(self, tmp_path, monkeypatch):
        from svoc_torch.durability.recovery import RecoveryManager

        multi = self._multi()

        def broken(**kwargs):
            raise RuntimeError("enumeration broke")

        monkeypatch.setattr(multi, "start_prewarm", broken)
        report = RecoveryManager(multi, out_dir=str(tmp_path), compilation_cache="off").recover(prewarm=True)
        assert report["prewarm"] == {"error": True}
        assert multi.metrics.counter("compile_cache_errors", labels={"op": "prewarm"}).count == 1

    def test_a_restart_loads_from_the_cache_of_a_killed_run(self, tmp_path, fake_nvcc, monkeypatch):
        from svoc_torch.durability.recovery import RecoveryManager

        events = _events(monkeypatch)
        manager = RecoveryManager(self._multi(), out_dir=str(tmp_path), compilation_cache="persistent")
        assert str(_build.build_dir()) == manager.compile_cache_dir
        _build.load_all(prewarm.SERVING_KERNELS)
        manager.snapshot()  # leaves the libraries where they are
        _build._loaded.clear()  # the restarted process
        _build._built.clear()
        RecoveryManager(self._multi(), out_dir=str(tmp_path), compilation_cache="persistent")
        _build.load_all(prewarm.SERVING_KERNELS)
        kernels = sorted(prewarm.SERVING_KERNELS)
        assert sorted(n for e, n in events if e == "miss") == sorted(n for e, n in events if e == "hit") == kernels


# ---------------------------------------------------------------------------
# Monitoring: the build listener, the runtime gauges, the MFU gauge
# ---------------------------------------------------------------------------


class TestCompileMonitoring:
    def _series(self):
        reg = metrics_mod.registry
        return (reg.counter("kernel_builds_total").count, reg.histogram("kernel_build_seconds").count,
                reg.counter("kernel_cache_events", labels={"event": "miss"}).count,
                reg.counter("kernel_cache_events", labels={"event": "hit"}).count)

    def test_a_build_is_a_miss_and_a_later_process_load_a_hit(self, fake_nvcc):
        assert metrics_mod.install_compile_listener() and metrics_mod.install_compile_listener()
        b0, h0, m0, hit0 = self._series()
        lib = _build.load("probe")
        assert lib.svoc_probe() == 7
        assert _build.load("probe") is lib  # loaded: no event
        b1, h1, m1, hit1 = self._series()
        assert (b1 - b0, h1 - h0, m1 - m0, hit1 - hit0) == (1, 1, 1, 0)
        _build._loaded.clear()  # as a restarted process finds the directory
        _build._built.clear()
        assert _build.load("probe").svoc_probe() == 7
        assert self._series()[2:] == (m1, hit1 + 1)
        snap = metrics_mod.compile_snapshot()
        assert snap["cache_misses"] >= 1 and snap["cache_hits"] >= 1 and snap["kernel_build_seconds_sum"] > 0
        assert set(snap["prewarm_outcomes"]) == {"compiled", "primed", "skipped", "error", "budget_exhausted"}

    def test_a_failed_build_raises_and_still_counts_its_run(self, fake_nvcc):
        metrics_mod.install_compile_listener()
        (fake_nvcc.parent / "nvcc.fail").write_text("")
        misses = self._series()[2]
        with pytest.raises(RuntimeError, match="nvcc failed for probe.cu"):
            _build.load("probe")
        assert self._series()[2] == misses + 1 and not _build.library_path("probe").exists()

    def test_runtime_gauges_wait_for_cuda(self):
        reg = MetricsRegistry()
        assert not torch.cuda.is_initialized()
        assert metrics_mod.sample_runtime_gauges(reg) == {}

    def test_mfu_gauge_and_the_flop_model(self):
        from svoc_tpu.models import configs as ref_configs

        from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS

        bench = pytest.importorskip("bench")
        assert metrics_mod.encoder_matmul_flops_per_token(ROBERTA_GO_EMOTIONS, 128) == (
            bench.encoder_matmul_flops_per_token(ref_configs.ROBERTA_GO_EMOTIONS, 128))
        reg = MetricsRegistry()
        mfu = metrics_mod.set_mfu_gauge(0.5, 989e12 * 0.25, reg=reg)
        assert mfu == pytest.approx(0.5) and reg.gauge("mfu_estimate").get() == pytest.approx(0.5)
        assert reg.gauge("step_seconds").get() == 0.5
        assert metrics_mod.set_mfu_gauge(0.5, 1.0, None, reg=reg) is None
        assert metrics_mod.set_mfu_gauge(0.0, 1.0, reg=reg) is None

    def test_profile_trace_writes_a_chrome_trace(self, tmp_path):
        with metrics_mod.profile_trace(str(tmp_path / "t")) as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
        assert any("mm" in e.key for e in prof.key_averages())
        assert json.load(open(tmp_path / "t" / "trace.json"))["traceEvents"]


class TestProfiler:
    def _capture(self, tmp_path, **kwargs):
        from svoc_torch.obsplane import ProfileCapture
        from svoc_torch.utils.events import EventJournal

        journal = EventJournal()
        return ProfileCapture(str(tmp_path), journal=journal, metrics=MetricsRegistry(), **kwargs), journal

    def test_capture_lifecycle_writes_a_trace_and_journals_it(self, tmp_path):
        capture, journal = self._capture(tmp_path)
        assert capture.stop() == {"status": "idle"}
        started = capture.start()
        assert started["status"] == "started" and started["path"].endswith("profile-0001")
        assert capture.start()["status"] == "already_running"
        torch.ones(32, 32) @ torch.ones(32, 32)
        done = capture.stop()
        assert done["status"] == "captured"
        assert os.path.exists(os.path.join(done["path"], "trace.json"))
        assert capture.last is not None and capture.status()["captures"] == 1
        (event,) = journal.recent(type="profile.captured")
        assert event.data == {"trigger": "manual", "path": done["path"]}

    def test_auto_capture_is_rate_limited_and_bounded(self, tmp_path):
        import time

        t = {"now": 0.0}
        capture, _journal = self._capture(tmp_path, max_duration_s=0.2, auto_min_interval_s=100.0,
                                          clock=lambda: t["now"])
        first = capture.maybe_capture("breaker_open")
        assert first["status"] == "started" and first["duration_s"] == 0.2
        assert capture.poll() is None  # before the deadline
        time.sleep(0.3)
        assert capture.status()["active"] is None  # the owner's next call ends it
        assert capture.status()["captures"] == 1 and capture.last is not None
        t["now"] = 50.0
        assert capture.maybe_capture("slo_burn") is None
        assert capture._metrics.counter("profile_suppressed", labels={"reason": "rate_limit"}).count == 1

    def test_a_stop_from_another_thread_waits_for_the_owner(self, tmp_path):
        import threading

        capture, journal = self._capture(tmp_path)
        assert capture.start()["status"] == "started"
        got = {}
        worker = threading.Thread(target=lambda: got.update(capture.stop()))
        worker.start()
        worker.join()
        assert got["status"] == "stop_pending" and capture.status()["active"] is None
        assert len(journal.recent(type="profile.captured")) == 1

    def test_postmortem_monitor_starts_a_capture_on_breaker_open(self, tmp_path):
        from svoc_torch.utils.postmortem import PostmortemMonitor

        capture, journal = self._capture(tmp_path)
        monitor = PostmortemMonitor(str(tmp_path / "bundles"), journal=journal, profiler=capture)
        monitor.install()
        try:
            journal.emit("breaker.transition", to="open", **{"from": "closed"})
            assert capture.status()["active"]["trigger"] == "breaker_open"
        finally:
            capture.stop()
            monitor.uninstall()
