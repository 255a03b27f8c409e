"""A CPU rehearsal of ``chip_smoke.py`` phase 12b at a tiny size.

The phase's two child processes run its own ``coldstart_width_run`` with
``TINY_TEST`` weights and 4 claims of 4 arrivals a step on the CPU: the
``cold`` child (the persistent kernel cache under the durable directory,
no prewarm) serves 3 steps, snapshots and SIGKILLs itself; the ``warm``
child recovers from the directory with ``recover(prewarm=True)`` and
serves steps 4-6.  As the card's run checks it: the restart's prewarm
walk primes the router's primary keys with no error, its first dispatch
counts ``prewarmed``, and every claim's consensus after the restart
equals an uninterrupted 6-step run's in this process.  Nothing is built
on the CPU, so the cache stays empty and no build is counted.
"""

import json
import runpy
import signal
import subprocess
import sys
from pathlib import Path

import torch

from svoc_torch.models.configs import TINY_TEST

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(device="cpu", cfg=TINY_TEST, claims=4, arrivals=4, comments=64)

CHILD = """
import runpy, sys, torch
from svoc_torch.models.configs import TINY_TEST
g = runpy.run_path({script!r})
g["coldstart_width_run"](torch, sys.argv[1], sys.argv[2], None, device="cpu", cfg=TINY_TEST, claims=4,
                         arrivals=4, comments=64)
"""


def test_phase_12b_children_on_the_cpu(tmp_path):
    code = CHILD.format(script=str(REPO / "chip_smoke.py"))
    procs = {}
    for role in ("cold", "warm"):
        procs[role] = subprocess.run([sys.executable, "-c", code, str(tmp_path), role], cwd=REPO,
                                     capture_output=True, text=True, timeout=300)
    assert procs["cold"].returncode == -signal.SIGKILL, procs["cold"].stderr[-2000:]
    assert procs["warm"].returncode == 0, procs["warm"].stderr[-2000:]
    cold, warm = (json.loads((tmp_path / f"result-{role}.json").read_text()) for role in ("cold", "warm"))
    assert [r["step"] for r in cold["rows"] + warm["rows"]] == [1, 2, 3, 4, 5, 6]
    assert all(r["served"] == 4 and r["forwards"] == 1 for r in cold["rows"] + warm["rows"])
    assert cold["rows"][0]["warmth"] == {"cold": 1.0, "prewarmed": 0.0, "warm": 0.0}
    assert warm["rows"][0]["warmth"] == {"cold": 0.0, "prewarmed": 1.0, "warm": 0.0}
    assert warm["prewarm"]["report"]["outcomes"] == {"primed": 3}  # buckets 1, 2, 4 of the sanitized variant
    assert cold["cache_errors"] == warm["cache_errors"] == 0
    assert cold["cache_dir"] == warm["cache_dir"] and "kernel_cache" in warm["cache_dir"]
    assert warm["compile"]["cache_misses"] == warm["compile"]["cache_hits"] == 0

    g = runpy.run_path(str(REPO / "chip_smoke.py"))
    ref = g["coldstart_width_run"](torch, str(tmp_path / "uninterrupted"), "uninterrupted", **SMALL)
    assert [r["step"] for r in ref["rows"]] == [1, 2, 3, 4, 5, 6] and ref["cache_dir"] is None
    assert warm["consensus"] == json.loads(json.dumps(ref["consensus"]))
