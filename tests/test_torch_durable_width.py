"""A CPU rehearsal of ``chip_smoke.py`` phase 11c at a tiny size.

The phase's two child processes run its own ``durable_width_run`` with
``TINY_TEST`` weights, 4 claims of 4 arrivals a step and 6 steps on the
CPU: the first child is SIGKILLed by the armed fault controller at the
18th ``chain.batch.mid_fleet`` firing of step 4 (mid-way through the
third claim's batch), the second recovers from the directory and runs
to the end.  The durability contract holds as the card's run checks it:
the kill where it was scheduled, zero duplicate txs over every chain
log, zero open cycles and unknown slots, every request accounted for,
and one open cycle at the kill whose durable prefix is landed and whose
suffix alone is resent.
"""

import json
import signal
import subprocess
import sys
from pathlib import Path

from svoc_torch.durability.faultspace import read_fired_log
from svoc_torch.tools.crash_smoke import reconcile_counts

REPO = Path(__file__).resolve().parent.parent
KILL_STEP, KILL_NTH, STEPS = 4, 7 * 2 + 4, 6

CHILD = """
import runpy, sys, torch
from svoc_torch.models.configs import TINY_TEST
g = runpy.run_path({script!r})
g["durable_width_run"](torch, sys.argv[1], sys.argv[2], device="cpu", cfg=TINY_TEST, claims=4,
                       arrivals=4, steps={steps}, kill_step={kill_step}, kill_nth={kill_nth}, comments=64)
"""


def test_phase_11c_children_on_the_cpu(tmp_path):
    code = CHILD.format(script=str(REPO / "chip_smoke.py"), steps=STEPS, kill_step=KILL_STEP,
                        kill_nth=KILL_NTH)
    procs = {}
    for role in ("crash", "recover"):
        procs[role] = subprocess.run([sys.executable, "-c", code, str(tmp_path), role], cwd=REPO,
                                     capture_output=True, text=True, timeout=300)
    assert procs["crash"].returncode == -signal.SIGKILL, procs["crash"].stderr[-2000:]
    assert procs["recover"].returncode == 0, procs["recover"].stderr[-2000:]

    crash_rows = [json.loads(line) for line in open(tmp_path / "rows-crash.jsonl")]
    assert [r["step"] for r in crash_rows] == list(range(1, KILL_STEP))
    fired = read_fired_log(str(tmp_path / "fired.jsonl"))
    assert fired["actions"] == [{"kind": "action", "point": "chain.batch.mid_fleet", "action": "kill",
                                 "n": KILL_NTH}]

    result = json.loads((tmp_path / "result.json").read_text())
    rec = result["recovery"]["reconcile"]
    assert result["steps"] == STEPS and result["duplicate_txs"] == 0 and not result["wal_open_cycles"]
    assert rec["unknown"] == rec["unaccounted"] == 0 and result["requests"]["unaccounted"] == 0
    counts = reconcile_counts(rec)
    assert rec["open_cycles"] == 1 and counts["landed_chain"] == 4
    assert rec["resent"] == counts["stranded"] == 3
    rec_rows = [json.loads(line) for line in open(tmp_path / "rows-recover.jsonl")]
    assert [r["step"] for r in rec_rows] == list(range(KILL_STEP - 1, STEPS + 1))
    assert all(r["served"] == 4 and r["forwards"] == 1 and r["fsyncs"] > 0 for r in crash_rows + rec_rows)
    assert result["snapshots"] and all(b > 0 for _ms, b, _step in result["snapshots"])
    assert set(result["timer"]) == {"chain_log_replay", "load_snapshot", "restore_multi_session",
                                    "roll_forward_journal", "reconcile_wal"}

