"""Cold-start gate: prewarm, kill, restart warm, fingerprint-held; on the card by default.

The twin of ``tools/coldstart_smoke.py``.  Three child processes run the
same seeded 4-claim fabric scenario (:func:`svoc_torch.fabric.scenario.run_fabric_scenario`)
on ``--device``:

1. ``control``: no kernel cache, no warmup;
2. ``warm_first``: the persistent kernel cache under a fresh durable
   directory (:func:`svoc_torch.compile.cache.enable_persistent_cache`)
   and a synchronous prewarm before the first cycle.  It fills the cache,
   reports, parks, and is SIGKILLed;
3. ``warm_restart``: a fresh process on the same directory, prewarm
   again, the scenario again.

``control`` runs beside ``warm_first`` (it never opens the cache);
``warm_restart`` starts once ``warm_first`` is dead.

The checks are the reference's five:

- ``warmed_equals_control`` and ``restart_equals_control``: the
  per-claim and whole-journal fingerprints of the three legs are equal
  (warmup never journals and never changes numerics);
- ``first_run_populated_cache``: ``warm_first`` built kernels
  (``kernel_cache_events{event="miss"}`` > 0, where the reference reads
  ``xla_cache_events``);
- ``zero_fresh_compiles_after_restart``: ``warm_restart`` built nothing
  (0 misses);
- ``restart_really_hit_cache``: and loaded what it ran from the cache
  (hits > 0).

On the CPU no kernel is built, so the last three run only on CUDA and
the report lists them under ``not_run``.  At seed 0 with the default 8
cycles the fingerprints must also equal the JAX package's, kept below as
literals (:data:`REFERENCE_FINGERPRINTS`; ``tests/test_torch_coldstart.py``
rechecks them against the live reference).

Usage::

    python -m svoc_torch.tools.coldstart_smoke [--seed 0] [--cycles 8] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import select
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Optional

#: The JAX package's ``tools/coldstart_smoke.py --seed 0`` (8 cycles):
#: the legs' per-claim and whole-journal fingerprints, equal in all three.
REFERENCE_FINGERPRINTS: Dict[str, Any] = {
    "journal_fingerprint": "af292d66825d61fad653162d008682d86604dc633c999048dd6b4e84e5f049e4",
    "claims": {
        "alpha": "85ddb9ccea8b7d036af78e1739c44dec9b9a456af9046ed8dc322bf928e43079",
        "beta": "a9d84043b964d7eef1f386d3e937c8c13a29d36964410165d5f650d0d4857b19",
        "delta": "400c975f99d31ca43a1118a904ee48d0c8f18ec3fa5e8c96166c94ef18e58cb1",
        "gamma": "689be9739f0dd3cb1471fbab28a46ad13f80a84f5210a9a475d4c9ad2cf7d0f4",
    },
}
REFERENCE_CYCLES = 8
LEGS = ("control", "warm_first", "warm_restart")
CACHE_CHECKS = ("first_run_populated_cache", "zero_fresh_compiles_after_restart",
                "restart_really_hit_cache")

#: The directory that holds the ``svoc_torch`` package: children import
#: it from there whatever their working directory.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reference_mismatches(legs: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The legs whose fingerprints differ from :data:`REFERENCE_FINGERPRINTS`
    (empty when every leg matches)."""
    out = {}
    for leg, result in legs.items():
        got = {"journal_fingerprint": result.get("journal_fingerprint"), "claims": result.get("claims")}
        if got != REFERENCE_FINGERPRINTS:
            out[leg] = got
    return out


def child(leg: str, seed: int, cycles: int, cache_dir: str, device: Optional[str]) -> None:
    """One leg; prints one JSON line, then (``warm_first``) parks for the
    parent's SIGKILL: the built libraries must survive an unclean death."""
    from svoc_torch.fabric.scenario import run_fabric_scenario
    from svoc_torch.utils.metrics import MetricsRegistry, compile_snapshot, install_compile_listener, registry

    install_compile_listener()
    if leg != "control":
        from svoc_torch.compile.cache import enable_persistent_cache

        if not enable_persistent_cache(cache_dir):
            raise RuntimeError(f"the persistent kernel cache did not enable under {cache_dir}")
    metrics = MetricsRegistry()
    t0 = time.perf_counter()
    result = run_fabric_scenario(seed, cycles=cycles, warmup=(leg != "control"), metrics=metrics,
                                 device=device)
    snap = compile_snapshot(registry)
    print(json.dumps({
        "leg": leg,
        "journal_fingerprint": result["journal_fingerprint"],
        "claims": {c: result["claims"][c]["fingerprint"] for c in sorted(result["claims"])},
        "cache_misses": snap["cache_misses"],
        "cache_hits": snap["cache_hits"],
        "build_seconds": snap["kernel_build_seconds_sum"],
        "prewarm_outcomes": compile_snapshot(metrics)["prewarm_outcomes"],
        "scenario_s": time.perf_counter() - t0,
    }), flush=True)
    if leg == "warm_first":
        signal.pause()


def run_leg(leg: str, seed: int, cycles: int, cache_dir: str, device: Optional[str],
            kill: bool = False, timeout_s: float = 600) -> dict:
    """Start one leg's child, read its line, SIGKILL it when ``kill``."""
    cmd = [sys.executable, "-m", "svoc_torch.tools.coldstart_smoke", "--child", leg, "--seed", str(seed),
           "--cycles", str(cycles), "--cache-dir", cache_dir]
    if device is not None:
        cmd += ["--device", device]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=_ROOT + (os.pathsep + path if path else ""))
    # stderr goes to a file: a chatty child filling a pipe would block
    # against the parent's read of its one stdout line.
    with tempfile.TemporaryFile(mode="w+") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=_ROOT)
        try:
            ready, _w, _x = select.select([proc.stdout], [], [], timeout_s)
            line = proc.stdout.readline() if ready else ""
            if not line:
                proc.kill()
                proc.wait(timeout=10)
                err.seek(0)
                raise RuntimeError(f"leg {leg} died before reporting: {err.read()[-2000:]}")
            if kill:
                proc.kill()
            proc.wait(timeout=timeout_s)
            out = json.loads(line)
            out["returncode"] = proc.returncode
            out["process_s"] = time.perf_counter() - t0
            return out
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


def run(seed: int = 0, cycles: int = REFERENCE_CYCLES, device: Optional[str] = None,
        base: Optional[str] = None) -> dict:
    """The three legs and their checks; returns the artifact (``ok``,
    ``checks``, ``not_run``, ``reference_mismatches``, ``legs``)."""
    from svoc_torch.device import resolve_device

    on_cuda = resolve_device(device).type == "cuda"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="coldstart-smoke-", dir=base) as tmp:
        cache_dir = os.path.join(tmp, "durable")
        # The control leg never opens the cache, so it runs beside the
        # first warm leg; the restart needs that leg's cache, so it follows.
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            control = pool.submit(run_leg, "control", seed, cycles, cache_dir, device)
            first = run_leg("warm_first", seed, cycles, cache_dir, device, kill=True)
            legs = {"control": control.result(), "warm_first": first,
                    "warm_restart": run_leg("warm_restart", seed, cycles, cache_dir, device)}
    control, first, restart = (legs[leg] for leg in LEGS)

    def same(a, b):
        return a["claims"] == b["claims"] and a["journal_fingerprint"] == b["journal_fingerprint"]

    checks = {
        "warmed_equals_control": same(first, control),
        "restart_equals_control": same(restart, control),
        "first_run_killed_by_sigkill": first["returncode"] == -signal.SIGKILL,
    }
    not_run = []
    if on_cuda:
        checks["first_run_populated_cache"] = first["cache_misses"] > 0
        checks["zero_fresh_compiles_after_restart"] = restart["cache_misses"] == 0
        checks["restart_really_hit_cache"] = restart["cache_hits"] > 0
    else:
        not_run = list(CACHE_CHECKS)  # no kernel is built on the CPU
    mismatches = None
    if seed == 0 and cycles == REFERENCE_CYCLES:
        mismatches = reference_mismatches(legs)
        checks["matches_reference_fingerprints"] = not mismatches
    return {
        "seed": seed,
        "cycles": cycles,
        "device": device or "cuda",
        "elapsed_s": time.perf_counter() - t0,
        "checks": checks,
        "not_run": not_run,
        "reference_mismatches": mismatches,
        "ok": all(checks.values()),
        "legs": legs,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cycles", type=int, default=REFERENCE_CYCLES)
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    p.add_argument("--child", default=None, choices=LEGS, help="(internal) one leg")
    p.add_argument("--cache-dir", default=None, help="(internal) the durable directory")
    args = p.parse_args(argv)
    if args.child:
        child(args.child, args.seed, args.cycles, args.cache_dir, args.device)
        return 0

    artifact = run(args.seed, args.cycles, args.device)
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, artifact)
    for name, passed in artifact["checks"].items():
        print(f"  {'PASS' if passed else 'FAIL'}  {name}")
    for name in artifact["not_run"]:
        print(f"  --    {name} (not run on the CPU: no kernel is built there)")
    if artifact["reference_mismatches"]:
        print("reference mismatches: " + json.dumps(artifact["reference_mismatches"]))
    restart = artifact["legs"]["warm_restart"]
    print(f"coldstart-smoke {'OK' if artifact['ok'] else 'FAILED'}: 4 claims x {artifact['cycles']} cycles "
          f"on {artifact['device']}, prewarmed, SIGKILLed and restarted warm "
          f"({restart['cache_hits']:g} cache hits, {restart['cache_misses']:g} misses)")
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
