"""A CPU rehearsal of ``chip_smoke.py`` phase 14c at a tiny size.

The phase's own ``reconfig_width_run`` drives 13c's fleet (3 replicas of
``TINY_TEST`` weights, here over 8 claims of 4 arrivals a step) for the
phase's 10 steps on the CPU, with no kill: after step 3 the smoke's plan
(batched commits, the first claim re-specced to 9 oracles) is aborted by
an ``error`` at ``reconfig.pre_resume``, after every replica built its new
stack, with no traffic; after step 4 the same abort with one arrival a
claim at every stage boundary; after step 6 the same plan commits,
rolling, with the arrivals.  Then the never-attempted baseline runs
through step 5: nothing at step 3, the abort under traffic's holds,
arrivals, flushes and release with no apply at step 4.  The phase's
checks hold, but for the kernels' launch counts and the dispatch warmth
(nothing is built or primed on the CPU): the abort with no traffic
leaves the fleet fingerprint, the journals and the accounting as they
were and no epoch file; the abort under traffic leaves the epoch at 0,
no epoch file and nothing dropped, and releases its deferred requests
into the old stacks in arrival order; every per-claim fingerprint and
the router's snapshot after steps 3, 4 and 5 equal the baseline's; the
commit re-pins every replica under epoch 1 with lineage continuity and
releases every deferred request, in arrival order; zero shed, zero
duplicate txs, zero unaccounted requests, classified hop chains.

The latency target is scaled to the CPU (``STEP_PERIOD_S``), as in the
13c rehearsal.
"""

import runpy
from pathlib import Path

import torch

from svoc_torch.models.configs import TINY_TEST

REPO = Path(__file__).resolve().parent.parent
CLAIMS, ARRIVALS = 8, 4
STEP_PERIOD_S = 600.0  # a latency target of 1500 s


def test_phase_14c_on_the_cpu(tmp_path):
    g = runpy.run_path(str(REPO / "chip_smoke.py"))
    pipe = g["width_pipeline"](torch, cfg=TINY_TEST, device="cpu")
    g["calibrate_head"](torch, pipe)
    run = g["reconfig_width_run"](torch, pipe, device="cpu", claims=CLAIMS, arrivals=ARRIVALS,
                                  base_dir=str(tmp_path), step_period_s=STEP_PERIOD_S)
    g["fleet_invariants"](run, "14c on the CPU")
    g["reconfig_checks"](run, "14c on the CPU", cuda=False)
    assert g["failures"] == []

    rows, ev = run["rows"], run["events"]["reconfig"]
    assert [r["step"] for r in rows] == list(range(g["RECONFIG_STEPS"]))
    abort, quiet, commit = (ev[g[k]] for k in ("RECONFIG_ABORT_STEP", "RECONFIG_QUIET_ABORT_STEP",
                                                 "RECONFIG_COMMIT_STEP"))
    # Every phase was timed, per replica, and the transition sits inside its step's window.
    labels = [label for label, _ in commit["phases"]]
    assert labels == ["prepare"] + [f"{p} r{i}" for i in range(3) for p in ("drain", "ship", "repin")] + ["resume"]
    assert [label for label, _ in abort["phases"]] == [label for label, _ in quiet["phases"]] == labels
    assert abort["rollback_s"] > 0 and abort["commit_s"] is None and commit["commit_s"] > 0
    assert quiet["rollback_s"] > 0 and quiet["commit_s"] is None and quiet["submits"] == 0
    assert abort["release_s"] > 0 and run["baseline"]["reconfig"]["script"] == abort["script"]
    assert rows[g["RECONFIG_COMMIT_STEP"]]["events_ms"] >= commit["seconds"] * 1e3
    assert len(commit["hold_s"]) == commit["deferred"] and all(h >= 0 for h in commit["hold_s"])
    # Nothing built or primed on the CPU; no kernel launched.
    assert run["primed"] == 0 and commit["prepare"]["compiled"] == 0 and commit["prepare"]["keys"] > 0
    assert not any(run["counts"].values())
    # The re-pinned claim serves at 9 oracles on its new stack.
    owner = run["placement"].owner(run["names"][0])
    assert run["router"].replica(owner).multi.get(run["names"][0]).spec.n_oracles == 9
