"""A CPU rehearsal of ``chip_smoke.py`` phase 13c at a tiny size.

The phase's own ``fleet_width_run`` drives 3 replicas of ``TINY_TEST``
weights over 8 claims of 4 arrivals a step for the phase's 10 steps on
the CPU: r1's queues are filled at step 3, r1 is killed after step 4's
submits and failed over at step 6, and one claim migrates at step 8.
The phase's checks hold, but for the kernels' launch counts (no kernel
launches on the CPU): zero duplicate txs, zero unaccounted requests,
typed sheds, classified hop chains, and a failover whose recovered
backlog the drains answer or defer, with every moved claim adopted with
continuity.

A CPU step takes seconds where the card's takes about one, and under a
loaded host the tiers' latency SLO would burn and shed the traffic
(``slo_burn``), which the card's run never reaches; so the latency
target here is scaled to the CPU (``STEP_PERIOD_S``).
"""

import runpy
from pathlib import Path

import torch

from svoc_torch.models.configs import TINY_TEST

REPO = Path(__file__).resolve().parent.parent
CLAIMS, ARRIVALS = 8, 4
STEP_PERIOD_S = 600.0  # a latency target of 1500 s


def test_phase_13c_on_the_cpu(tmp_path):
    g = runpy.run_path(str(REPO / "chip_smoke.py"))
    pipe = g["width_pipeline"](torch, cfg=TINY_TEST, device="cpu")
    g["calibrate_head"](torch, pipe)
    run = g["fleet_width_run"](torch, pipe, g["FLEET_REPLICAS"], g["FLEET_STEPS"], kill_step=g["FLEET_KILL_STEP"],
                               failover_step=g["FLEET_FAILOVER_STEP"], migrate_step=g["FLEET_MIGRATE_STEP"],
                               device="cpu", claims=CLAIMS, arrivals=ARRIVALS, base_dir=str(tmp_path),
                               step_period_s=STEP_PERIOD_S)
    g["fleet_invariants"](run, "13c on the CPU")
    g["failover_checks"](run, "13c on the CPU")
    assert g["failures"] == []
    assert all(not router_shed for router_shed in (run["router"].replica(r).metrics.family_total("serving_shed")
                                                    for r in run["router"].replica_ids()))

    rows, ev = run["rows"], run["events"]
    assert [r["step"] for r in rows] == list(range(g["FLEET_STEPS"]))
    assert all(r["wall_ms"] >= r["submit_ms"] + r["step_ms"] for r in rows)
    # The failover's drains served the recovered backlog inside step 6's window.
    failover_row = rows[g["FLEET_FAILOVER_STEP"]]
    drained = sum(c["drain_completed"] for c in ev["failover_claims"].values())
    assert drained > 0 and failover_row["replicas"]["r1"]["completed"] == drained
    assert failover_row["events_ms"] >= ev["failover_s"] * 1e3
    # r1 died before serving step 4: that step's admissions were lost with it.
    assert "r1" not in rows[g["FLEET_KILL_STEP"]]["replicas"]
    assert ev["failover"]["recovery"]["lost_requests"] > 0
