"""Deterministic fault-space fuzzer gate, on the card by default.

The twin of ``tools/chaos_fuzz.py`` (``chaos_fuzz.py:1-288``): the CLI
and parent harness over :mod:`svoc_torch.durability.fuzz`.  It explores
the declared fault surface (:mod:`svoc_torch.durability.faultspace`) with
seed-drawn kill/restart schedules: per seed, a crash+recover subprocess
chain in one work directory — SIGKILL at the Nth firing of a named point,
torn writes, injected chain faults, ``per_tx`` vs ``batched`` commit
mode, restart storms (a second kill mid-recovery) — then the invariant
oracles over the recovered artifacts and a full same-seed rerun
asserting byte-identical recovered fingerprints.

The gate FAILS when:

- any invariant oracle trips (duplicate txs, lost commits, unclosed
  cycles, unknown slots with a reachable backend, codec divergences,
  replay divergence, harness errors) — the failing plan is
  **auto-shrunk** and written as a regression entry into ``--corpus-dir``
  (by default ``corpus/`` in the work area: the committed corpus under
  ``tests/fixtures/chaos_corpus/`` is the JAX package's, read in place
  by the tests and never written here);
- any ``"fuzz"``-smoke fault point never fired across the whole seed
  budget (100 % declared-point coverage is the acceptance bar);
- the **felt-wire segment** (a fault-free ``commit_mode="batched"`` soak
  through the batched adapter's ``encoding="felt"`` plane) reports any
  codec divergence;
- a recovered fingerprint differs from the JAX package's
  (:data:`REFERENCE_FINGERPRINTS`: the directed pass's seeds and the felt
  soak);
- fewer than 32 seeds ran (``--seeds 18`` is the directed pass alone:
  one seed per ``fuzz`` point, and it fails this check honestly).

Every child is ``python -m svoc_torch.tools.chaos_fuzz --child ...`` on
``--device`` (default CUDA, raising without a card), its own process,
SIGKILLed at its fault point, forked from the fork server that imported
torch and the child's modules once and never initialised CUDA
(:func:`svoc_torch.durability.fuzz.fork_child`,
:mod:`svoc_torch.durability.forked`), so a child initialises CUDA itself
after the fork.  Each child records its seconds
(``child_seconds`` in each run's summary): the interpreter's start, torch's
import, the port's imports (all three 0 in a forked child, whose
``start_s`` is the fork's; a child spawned by ``fuzz.spawn_child``, as the
corpus replays' are, pays them), CUDA's initialisation and the workload.
The artifact records the pass's own ``wall_seconds``.

Usage::

    python -m svoc_torch.tools.chaos_fuzz [--seeds 32] [--jobs 3] [--device cpu] [--out FILE]
    python -m svoc_torch.tools.chaos_fuzz --seeds 512 --base-dir DIR   # deep
    python -m svoc_torch.tools.chaos_fuzz --child DIR --plan PLAN.json --phase N [--device cpu]  # internal
"""

import time

#: When this module started running: the interpreter is up (the package's
#: ``__init__`` imports nothing heavy).
_T_ENTER = time.time()

import argparse  # noqa: E402
import concurrent.futures  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import tempfile  # noqa: E402
from typing import Any, Dict  # noqa: E402

import torch  # noqa: E402, F401  (timed apart from the port's imports)

_T_TORCH = time.time()

from svoc_torch.durability import faultspace, forked, fuzz  # noqa: E402
from svoc_torch.utils.artifacts import atomic_write_json  # noqa: E402

#: The modules a child's workload imports beyond this one's: a spawned
#: child imports them before its clock for CUDA starts, the fork server
#: before it serves (``forked.PRELOAD`` holds them).
CHILD_MODULES = (
    "numpy.random",
    "sqlite3",
    "svoc_torch.apps.session",
    "svoc_torch.cluster.scenario",
    "svoc_torch.consensus.batch",
    "svoc_torch.durability.scenario",
    "svoc_torch.io.chain",
    "svoc_torch.ops.fused_consensus",
    "svoc_torch.resilience.retry",
    "svoc_torch.utils.checkpoint",
)


def _import_child_modules() -> float:
    t = time.time()
    for name in CHILD_MODULES:
        importlib.import_module(name)
    return time.time() - t

DEFAULT_SEEDS = 32

#: The JAX package's recovered fingerprints (``run_and_check``'s
#: ``result["fingerprint"]``, identical on its rerun): the tool's default
#: seed budget (``tools/chaos_fuzz.py --seeds 32 --jobs 3``, seeds 0-31),
#: the felt-wire soak, and every tier-1 entry of the committed corpus.  The card's machine has no
#: JAX, so they are kept as literals (``tests/test_torch_fuzz.py``
#: rechecks the corpus, the soak and a few seeds against a live run).
REFERENCE_FINGERPRINTS: Dict[str, Any] = {
    "seeds": {
        0: "8e2cc572f0d437e39986767219ae51982f4d55eb991fecb42c24059434f959c5",
        1: "600f03eff1c618b427b22fdc6b117dbca078d78fceb4017bccfe876d817cad51",
        2: "9a7f6906887f1f792265d0441fb17f823b24fa6bcf897ab2216a0df07182edd1",
        3: "2b5a790ac794f73fe3eb38e0e1be18fc744a850971468eb89efd5c274b2819cb",
        4: "e7542b56017367077b4a1a2b562ca65292aa749eccfed616387bfd20aab6232b",
        5: "8d11b30bd9bf7eded2e6dc8a30cadd0cbb6e942a14da26ec01d7fc40cbf19e7a",
        6: "2f55fe6a2e6458539beb632f81e9f3a2c74fa23d0fc4e98d66835c25bef2c92a",
        7: "1126524cae3a33b7ee20f4e75fc0c8ec39ac02d17d8d94e071502fcaabb270c2",
        8: "fc64fcc94294cd99afb93eace06dd0357f734ec54fc415a7b6bf2728d1e28732",
        9: "3fbea58c816c2faaf6b7de9a03352e036453a0f148b6d9621908f59ecb895cec",
        10: "f9cfc1e10663598acfaab5a5e5b6debfd57bd6b3f9533f2085c67dfd40797772",
        11: "f29422b867f6e97829eb3a9e28df5740b07f1e8c8a146f45035ca727aee3638a",
        12: "c0d09af3eb3719206b3f16beb3aabb5eb68b992ff1f6fb6c29da9ce6d8fb16d1",
        13: "187dd3c4cd9dce93bb6a269d2917e45ca87832979173133441a46658f670e9a7",
        14: "010e6e1a96897e2b1a5d0e31a3434eb75bb0443034e1ec5a4390c1a66a0ed27e",
        15: "0b73facd6d9a774c2f9d51638f859f5b01b70986d34f4c5e10f556bc619799ef",
        16: "e442b4c344181d23877608ea4ce704d43e22b7311a40c717850bd367914f3702",
        17: "7a78da2abdb51322b6bc79b29659d770bfb73a93f56b54ce252d2eb504251eba",
        18: "6cb2ed67e71b89f360172a77093a9a2d7c875cd3386f8bcba87382c9a0110fba",
        19: "d6c2b33d571f96eb2a2a7d27e87c2a8eff062b166d8e160a9c584cfce989bf35",
        20: "5b300d2579043e9898967b2e70b39eae9574da7054c95775bd3125309db05dd0",
        21: "feae4bd1695e1f43546dacbcb1ba50f60ef13931cbb0600bcddebb0cd6ce9ad3",
        22: "5913566a2faced241a12ab67ecac24bca074909b232004208043649e6e234582",
        23: "48cbe4b9b7b8abf93ec5f8e41c364d155c3e4dfb0f64086d8f4d9ca00c04a6d2",
        24: "8bd436e7de38f3ae3d5cb44144c089aa827362c0b5bf7651542eb569e69a8691",
        25: "01b1d4c5d672217b059ed8e36441578c77b53ef357d69093f7ddf346783a8c38",
        26: "bc34c63884cbc2b041cc1d94c92548502761453ea9af7ec076837c716d6b51fa",
        27: "3e39bb0f67108bf3ff5f74d647d9170fc5a647c2a83767a3ac440af6c3c0bd0d",
        28: "66f6802fa10a0e80e37a3f9d4950a8c3d3b7eddc12d4a607fab9b69d7c241103",
        29: "8d2c8ec5637c3b307ec825fb6679eb31bfefb649183a7ffda819b9ae6341c143",
        30: "a630910c21d22294e40ce4e11267a222844b848b7abdbc20e879830b344676b1",
        31: "eaa956bfc4bcdcb55970b9b65e39bf202efcfadd878a4cf8a54cdfa0fc970193",
    },
    "felt_soak": "ddaa2f1456855f2ed4628fee2e10ec2df0c5fe58c2922e0a13855bdd873e6cfd",
    "corpus": {
        "batched-felt-mid-fleet.json": "c62ef18fe177eee81dae14efeaae909dcc3902d52490ef55e56cbd37765cad59",
        "duplicate-txs-reconcile-error.json": "caa4ac54ae4810402323e7c0c0592a10daa1fe2e10a83059cb6dda1901958e35",
        "open-cycles-s2.json": "11beefb8bdfcc36fc687e60542fd9551d52b6577cb886d71ec30ca5e20cc2dd7",
        "torn-intent-restart-storm.json": "e82392a7c2bfb5fe9e2985b2465e0f063dcdf9f5f1873cec002fc685ca79f9f5",
    },
}


def reference_mismatches(runs, felt: Dict[str, Any]) -> Dict[str, Any]:
    """What differs from :data:`REFERENCE_FINGERPRINTS`: each seed summary
    of ``runs`` that has a reference figure, and the felt soak ``felt``;
    ``{}`` when everything matches."""
    out: Dict[str, Any] = {}
    for run in runs:
        ref = REFERENCE_FINGERPRINTS["seeds"].get(run["seed"])
        if ref is not None and run["fingerprint"] != ref:
            out[f"seed {run['seed']}"] = run["fingerprint"]
    if felt["fingerprint"] != REFERENCE_FINGERPRINTS["felt_soak"]:
        out["felt_soak"] = felt["fingerprint"]
    return out


def child_main(args) -> int:
    """One phase of a plan.  The result also records the child's seconds:
    ``start_s`` from its spawn (or fork) stamp to its CUDA initialisation
    (None when the parent stamped nothing), split into the interpreter's
    start (``interpreter_s``), torch's import (``torch_import_s``) and the
    port's (``port_import_s``), all 0 in a forked child; then CUDA's
    initialisation (``cuda_init_s``, 0 on the CPU) and the workload
    (``workload_s``)."""
    from svoc_torch.device import resolve_device

    is_forked = forked.IN_CHILD
    port_s = 0.0 if is_forked else _import_child_modules() + (time.time() - _T_TORCH)
    spawned = os.environ.get(fuzz.SPAWNED_ENV)
    start_s = time.time() - float(spawned) if spawned else None
    split = ({"interpreter_s": 0.0, "torch_import_s": 0.0, "port_import_s": 0.0} if is_forked else {
        "interpreter_s": _T_ENTER - float(spawned) if spawned else None,
        "torch_import_s": _T_TORCH - _T_ENTER, "port_import_s": port_s})
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    with open(args.plan) as f:
        plan = fuzz.FuzzPlan.from_dict(json.load(f))
    result = fuzz.run_fuzz_child(args.child, plan, args.phase, device=device)
    result["device"] = str(device)
    result["child_seconds"] = {"start_s": start_s, **split, "cuda_init_s": t1 - t0,
                               "workload_s": time.perf_counter() - t1, "forked": is_forked}
    atomic_write_json(os.path.join(args.child, fuzz.RESULT_NAME), result)
    return 0


def _seed_summary(seed: int, checked: dict) -> dict:
    run = checked["run"]
    result = run.get("result") or {}
    return {
        "seed": seed,
        "plan": checked["plan"],
        "phases": [
            {"phase": p["phase"], "killed": p["killed"]}
            for p in run["phases"]
        ],
        "violations": checked["violations"],
        "replay_identical": checked["replay_identical"],
        "fingerprint": result.get("fingerprint"),
        "duplicate_txs": result.get("duplicate_txs"),
        "codec_divergences": result.get("codec_divergences"),
        "fired": checked["fired"]["fired"],
        "actions": checked["fired"]["actions"],
        # Reconstructed from the durable action log (a killed phase's
        # remaining events die with its controller, so the surviving
        # child's in-memory view alone would under-report).
        "unfired_events": run.get("unexecuted_events", []),
        "device": result.get("device"),
        "child_seconds": result.get("child_seconds"),
        "children": len(run["phases"]),
    }


def felt_segment(base_dir: str, device=None, launcher=None) -> dict:
    """A fault-free batched soak — every commit rides the one-RPC batched
    adapter, whose backend applies with ``encoding="felt"`` — asserting
    zero codec divergences on the felt wire (plus the standard oracles
    and replay identity)."""
    plan = fuzz.FuzzPlan(
        seed=9_000_000, commit_mode="batched", cycles=8,
        label="felt_soak",
    )
    checked = fuzz.run_and_check(plan, os.path.join(base_dir, "felt-soak"), device=device, launcher=launcher)
    result = checked["run"].get("result") or {}
    return {
        "plan": checked["plan"],
        "violations": checked["violations"],
        "replay_identical": checked["replay_identical"],
        "codec_divergences": result.get("codec_divergences"),
        "fingerprint": result.get("fingerprint"),
        "predictions_committed": sum(
            c.get("predictions", 0)
            for c in (result.get("chain") or {}).values()
        ),
        "ok": not checked["violations"]
        and result.get("codec_divergences") == 0,
    }


def shrink_and_record(
    seed: int, checked: dict, base_dir: str, corpus_dir: str, budget: int, device=None, launcher=None
) -> dict:
    """Auto-shrink a failing plan to a minimal repro and write it into
    ``corpus_dir`` as a regression entry (``expect="pass"`` — the entry
    goes green once the bug is fixed)."""
    plan = fuzz.FuzzPlan.from_dict(checked["plan"])
    need_replay = any(
        v.startswith("replay_divergence") for v in checked["violations"]
    )
    trial_no = [0]

    def fails(candidate: fuzz.FuzzPlan) -> bool:
        trial_no[0] += 1
        trial_dir = os.path.join(
            base_dir, f"shrink-s{seed}-t{trial_no[0]:03d}"
        )
        return bool(
            fuzz.run_and_check(
                candidate, trial_dir, replay=need_replay, device=device, launcher=launcher
            )["violations"]
        )

    shrunk = fuzz.shrink_plan(plan, fails, budget=budget)
    # Record the SHRUNK plan's OWN violations: shrinking accepts any
    # failing neighbor, so the minimal repro can reproduce a different
    # failure class than the original seed did — the corpus entry must
    # pin what the stored plan actually does.
    final = fuzz.run_and_check(
        shrunk["plan"],
        os.path.join(base_dir, f"shrink-s{seed}-final"),
        replay=need_replay,
        device=device,
        launcher=launcher,
    )
    captured = final["violations"] or checked["violations"]
    path = fuzz.write_corpus_entry(
        corpus_dir,
        shrunk["plan"],
        captured,
        shrunk_from=plan,
        notes=f"auto-shrunk from seed {seed} in {shrunk['trials']} trials "
        f"by svoc_torch.tools.chaos_fuzz (original seed's violations: "
        f"{checked['violations']}); commit this entry WITH the fix so "
        f"the tests replay it green",
    )
    return {
        "seed": seed,
        "corpus_entry": path,
        "trials": shrunk["trials"],
        "shrunk_plan": shrunk["plan"].as_dict(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=DEFAULT_SEEDS)
    p.add_argument("--jobs", type=int, default=3)
    p.add_argument("--out", default="CHAOS_FUZZ.json")
    p.add_argument("--base-dir", default=None,
                   help="work area (default: fresh temp dir)")
    p.add_argument("--corpus-dir", default=None,
                   help="where shrunk repros go (default: corpus/ in the work area; the "
                        "committed corpus under tests/fixtures/ is read, never written)")
    p.add_argument("--shrink-budget", type=int, default=12)
    p.add_argument("--child", default=None, help="(internal) phase workdir")
    p.add_argument("--plan", default=None, help="(internal) plan JSON path")
    p.add_argument("--phase", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="the children's device (default: cuda, raising without a card)")
    args = p.parse_args(argv)
    if args.child is not None:
        return child_main(args)

    t0 = time.perf_counter()
    surface = faultspace.load_surface()
    fuzz_surface = fuzz.fuzz_points(surface)
    base = args.base_dir or tempfile.mkdtemp(prefix="chaos-fuzz-")
    os.makedirs(base, exist_ok=True)
    corpus_dir = args.corpus_dir or os.path.join(base, "corpus")

    plans = {seed: fuzz.draw_plan(seed, surface) for seed in
             range(args.seeds)}
    summaries = {}
    try:
        with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
            futures = {
                seed: pool.submit(
                    fuzz.run_and_check, plan, os.path.join(base, f"seed-{seed}"),
                    device=args.device, launcher=fuzz.fork_child,
                )
                for seed, plan in plans.items()
            }
            for seed, future in futures.items():
                summaries[seed] = _seed_summary(seed, future.result())
        felt = felt_segment(base, args.device, fuzz.fork_child)
        return _finish(args, surface, fuzz_surface, base, corpus_dir, summaries, felt, t0)
    finally:
        forked.stop()


def _finish(args, surface, fuzz_surface, base, corpus_dir, summaries, felt, t0) -> int:

    # Coverage: every "fuzz"-smoke point must have fired somewhere.
    coverage = {
        name: sorted(
            s["seed"] for s in summaries.values() if name in s["fired"]
        )
        for name in fuzz_surface
    }
    never_fired = sorted(n for n, seeds in coverage.items() if not seeds)

    failing = {
        seed: s for seed, s in summaries.items() if s["violations"]
    }
    shrunk_entries = []
    for seed, s in sorted(failing.items()):
        shrunk_entries.append(
            shrink_and_record(
                seed, s, base, corpus_dir, args.shrink_budget,
                args.device, fuzz.fork_child,
            )
        )

    mismatches = reference_mismatches(summaries.values(), felt)
    checks = {
        # The acceptance bar is absolute: a --seeds 4 dev run honestly
        # FAILS this check rather than passing vacuously.
        "seeds_explored_at_least_32": len(summaries) >= 32,
        "declared_fuzz_points_all_fired": not never_fired,
        "zero_invariant_violations": not failing,
        "zero_duplicate_txs": all(
            (s["duplicate_txs"] or 0) == 0 for s in summaries.values()
        ),
        "same_seed_rerun_fingerprints_identical": all(
            s["replay_identical"] is True for s in summaries.values()
        ),
        "felt_segment_zero_codec_divergences": felt["ok"],
        "recovered_fingerprints_equal_the_jax_package": not mismatches,
    }
    ok = all(checks.values())
    artifact = {
        "seeds": args.seeds,
        "device": str(args.device or "cuda"),
        "jobs": args.jobs,
        "wall_seconds": time.perf_counter() - t0,
        "surface": {
            name: {
                "owner": spec.owner,
                "invariant": spec.invariant,
                "actions": list(spec.actions),
                "smokes": list(spec.smokes),
                "modes": list(spec.modes),
                "stage": spec.stage,
                "fired_in_seeds": coverage.get(name),
            }
            for name, spec in sorted(surface.items())
        },
        "coverage_never_fired": never_fired,
        "felt_segment": felt,
        "reference_mismatches": mismatches,
        "checks": checks,
        "ok": ok,
        "violations": {
            seed: s["violations"] for seed, s in sorted(failing.items())
        },
        "shrunk": shrunk_entries,
        "runs": [summaries[seed] for seed in sorted(summaries)],
    }
    atomic_write_json(args.out, artifact)
    for name, passed in sorted(checks.items()):
        print(f"  {'PASS' if passed else 'FAIL'}  {name}")
    if never_fired:
        print(f"  never fired: {never_fired}")
    for entry in shrunk_entries:
        print(
            f"  seed {entry['seed']} FAILED -> shrunk repro written to "
            f"{entry['corpus_entry']} ({entry['trials']} trials); commit "
            f"it with the fix so the tests replay it green"
        )
    n_actions = sum(len(s["actions"]) for s in summaries.values())
    print(
        f"chaos-fuzz {'OK' if ok else 'FAILED'}: {len(summaries)} seeds, "
        f"{len(fuzz_surface)} fuzz-surface points "
        f"({len(surface)} declared), {n_actions} fault actions executed, "
        f"felt segment {'clean' if felt['ok'] else 'DIVERGED'}, "
        f"{artifact['wall_seconds']:.1f} s -> {args.out}"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
