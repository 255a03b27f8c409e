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

A second case forces the first claim onto the per-tx commit route (the
route a claim with a quarantined slot takes, which never passes
``chain.batch.mid_fleet``): the child then dies at the 4th
``chainlog.tx.post_fsync`` firing of step 4, the per-tx route's armed
point.  Every tx that landed before the kill is the uninterrupted run's
(each claim's chain log at the kill is a prefix of that run's), the
recovery keeps them (a prefix of the recovered log too) and runs to the
uninterrupted run's step count with as many txs and none twice.  The
journal fingerprints themselves are not compared with the uninterrupted
run's: a recovered journal holds the recovery's own events, and the
requests it requeues change what the later steps serve.
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
KILL_NTH_PER_TX = 4  # mid-way through the first claim's 7 txs

CHILD = """
import runpy, sys, torch
from svoc_torch.models.configs import TINY_TEST
g = runpy.run_path({script!r})
g["durable_width_run"](torch, sys.argv[1], sys.argv[2], device="cpu", cfg=TINY_TEST, claims=4,
                       arrivals=4, steps={steps}, kill_step={kill_step}, kill_nth={kill_nth},
                       kill_nth_per_tx={kill_nth_per_tx}, per_tx_claims={per_tx_claims}, comments=64)
"""


def run_children(workdir, roles, per_tx_claims=0):
    workdir.mkdir(exist_ok=True)
    code = CHILD.format(script=str(REPO / "chip_smoke.py"), steps=STEPS, kill_step=KILL_STEP,
                        kill_nth=KILL_NTH, kill_nth_per_tx=KILL_NTH_PER_TX, per_tx_claims=per_tx_claims)
    return {role: subprocess.run([sys.executable, "-c", code, str(workdir), role], cwd=REPO,
                                 capture_output=True, text=True, timeout=300) for role in roles}


def test_phase_11c_children_on_the_cpu(tmp_path):
    procs = run_children(tmp_path, ("crash", "recover"))
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



def chain_logs(workdir):
    return {p.name: p.read_text().splitlines() for p in sorted(workdir.glob("chain-*.jsonl"))}


def test_phase_11c_kill_lands_on_the_per_tx_route(tmp_path):
    procs = run_children(tmp_path / "killed", ("crash",), per_tx_claims=1)
    at_kill = chain_logs(tmp_path / "killed")
    procs.update(run_children(tmp_path / "killed", ("recover",), per_tx_claims=1))
    procs.update(run_children(tmp_path / "whole", ("whole",), per_tx_claims=1))
    assert procs["crash"].returncode == -signal.SIGKILL, procs["crash"].stderr[-2000:]
    assert procs["recover"].returncode == 0, procs["recover"].stderr[-2000:]
    assert procs["whole"].returncode == 0, procs["whole"].stderr[-2000:]

    crash_rows = [json.loads(line) for line in open(tmp_path / "killed" / "rows-crash.jsonl")]
    assert [r["step"] for r in crash_rows] == list(range(1, KILL_STEP))
    fired = read_fired_log(str(tmp_path / "killed" / "fired.jsonl"))
    assert fired["actions"] == [{"kind": "action", "point": "chainlog.tx.post_fsync", "action": "kill",
                                 "n": KILL_NTH_PER_TX}]
    assert "chain.batch.mid_fleet" not in fired["fired"]

    result = json.loads((tmp_path / "killed" / "result.json").read_text())
    whole = json.loads((tmp_path / "whole" / "result.json").read_text())
    rec = result["recovery"]["reconcile"]
    assert result["steps"] == whole["steps"] == STEPS
    assert result["duplicate_txs"] == 0 and not result["wal_open_cycles"]
    assert rec["unknown"] == rec["unaccounted"] == 0 and result["requests"]["unaccounted"] == 0
    assert rec["open_cycles"] == 1 and rec["resent"] >= 1
    assert result["txs"] == whole["txs"] and whole["duplicate_txs"] == 0
    recovered, uninterrupted = chain_logs(tmp_path / "killed"), chain_logs(tmp_path / "whole")
    assert set(at_kill) == set(recovered) == set(uninterrupted) and len(at_kill) == 4
    assert sum(map(len, at_kill.values())) < sum(map(len, uninterrupted.values()))
    for name, lines in at_kill.items():
        assert uninterrupted[name][: len(lines)] == lines == recovered[name][: len(lines)], name
