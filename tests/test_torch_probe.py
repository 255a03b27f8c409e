"""The port's probe tools and its gridded block copy, on the CPU.

- ``grid_copy`` on CPU tensors (its plain version) against the probe's
  ``pallas_call`` of ``tools/tpu_probe.py:99-112``, restated here in
  interpret mode; an assertion on the reference's source keeps the
  restated copy from drifting.  Bit for bit.
- The wrapper's refusals, before anything is built or launched.
- ``svoc_torch.tools.probe`` with a fake ``run_probe`` and ``REPO`` on
  ``tmp_path``, as ``tests/test_hw_campaign.py`` drives the reference's:
  the bisect, persistence after every probe, ``encoder512`` twice, the
  abort on a dead backend, the return code; and ``run_probe`` itself on
  real subprocesses.
- ``svoc_torch.tools.flash_probe`` on the CPU with the shapes shrunk.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from svoc_torch.ops.grid_copy import grid_copy, grid_copy_cuda, grid_copy_plain
from svoc_torch.tools import flash_probe, probe
from svoc_torch.utils.artifacts import atomic_write_json

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import tpu_probe  # noqa: E402


def _pallas_grid_copy(x: np.ndarray, block) -> np.ndarray:
    """The reference probe's kernel and call, in interpret mode (no
    memory space: that is the TPU's).  Where the block spans the columns,
    as the probe's does, this is its call word for word: a 2-D grid with
    the index map ``(i, j) -> (i, j, 0)``; a narrower block adds the
    third grid axis."""
    def copy_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    g, r, c = x.shape
    _, br, bc = block
    if bc == c:
        grid, spec = (g, r // br), pl.BlockSpec(tuple(block), lambda i, j: (i, j, 0))
    else:
        grid, spec = (g, r // br, c // bc), pl.BlockSpec(tuple(block), lambda i, j, k: (i, j, k))
    return np.asarray(pl.pallas_call(
        copy_kernel,
        grid=grid,
        in_specs=[spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True,
    )(jnp.asarray(x)))


def test_the_reference_probe_still_has_the_restated_shape():
    src = tpu_probe.PROBES["grid_copy"]
    assert "grid=(4, 2)" in src and src.count("pl.BlockSpec((1, 128, 128), lambda i, j: (i, j, 0)") == 2
    assert "jnp.arange(4 * 256 * 128, dtype=jnp.float32).reshape(4, 256, 128)" in src
    ours = probe.PROBES["grid_copy"]
    assert "torch.arange(4 * 256 * 128, dtype=torch.float32, device=DEV).reshape(4, 256, 128)" in ours
    assert "block = (1, 128, 128)" in ours


@pytest.mark.parametrize(
    "shape,block,dtype",
    [
        ((4, 256, 128), (1, 128, 128), np.float32),  # the probe's
        ((4, 256, 128), (1, 64, 128), np.float32),
        ((3, 24, 40), (1, 8, 20), np.float32),  # a grid over the columns too
        ((2, 16, 16), (1, 16, 16), np.int16),  # one tile per leading index, 2-byte elements
    ],
)
def test_grid_copy_matches_the_pallas_call(shape, block, dtype):
    x = np.arange(np.prod(shape)).astype(dtype).reshape(shape)
    want = _pallas_grid_copy(x, block)
    before = grid_copy_cuda.launches
    got = grid_copy(torch.from_numpy(x), block)
    assert grid_copy_cuda.launches == before  # a CPU tensor: the plain version
    assert got.dtype == torch.from_numpy(x).dtype and got.data_ptr() != torch.from_numpy(x).data_ptr()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, x)


def test_plain_version_copies_tile_by_tile():
    """NaNs and infinities survive, and each tile is written once from
    its own place."""
    x = torch.randn(2, 8, 12, generator=torch.Generator().manual_seed(0))
    x[0, 0, 0], x[1, 7, 11] = float("nan"), float("inf")
    out = grid_copy_plain(x, (1, 4, 6))
    assert torch.equal(out.view(torch.int32), x.view(torch.int32))


@pytest.mark.parametrize(
    "make,block,match",
    [
        (lambda: torch.zeros(4, 256, 128), (1, 100, 128), "does not divide"),
        (lambda: torch.zeros(4, 256, 128), (1, 128, 48), "does not divide"),
        (lambda: torch.zeros(4, 256, 128), (2, 128, 128), r"\(1, br, bc\)"),
        (lambda: torch.zeros(4, 256, 128), (128, 128), r"\(1, br, bc\)"),
        (lambda: torch.zeros(4, 256, 128), (1, 0, 128), r"\(1, br, bc\)"),
        (lambda: torch.zeros(256, 128), (1, 128, 128), r"\[G, R, C\]"),
        (lambda: torch.zeros(0, 256, 128), (1, 128, 128), r"\[G, R, C\]"),
        (lambda: torch.zeros(4, 256, 128, dtype=torch.float64), (1, 128, 128), "2- and 4-byte"),
        (lambda: torch.zeros(4, 128, 256).transpose(1, 2), (1, 128, 128), "contiguous"),
        (lambda: torch.zeros(1, 65536, 1, device="meta"), (1, 1, 1), "CUDA's limits"),
        (lambda: torch.zeros(4, 256, 128), (1, 128, 128), "CUDA device"),
        (lambda: torch.zeros(4, 256, 128, device="meta"), (1, 128, 128), "CUDA device"),
    ],
)
def test_grid_copy_wrapper_refuses(make, block, match):
    before = grid_copy_cuda.launches
    with pytest.raises(ValueError, match=match):
        grid_copy_cuda(make(), block)
    assert grid_copy_cuda.launches == before


def test_only_a_cpu_tensor_takes_the_plain_copy():
    with pytest.raises(ValueError, match="CUDA device"):
        grid_copy(torch.zeros(4, 256, 128, device="meta"), (1, 128, 128))
    with pytest.raises(ValueError, match="does not divide"):
        grid_copy(torch.zeros(4, 256, 128), (1, 100, 128))


def test_atomic_write_json_leaves_no_tmp(tmp_path):
    path = tmp_path / "out.json"
    atomic_write_json(str(path), [{"a": 1}])
    atomic_write_json(str(path), [{"a": 1}, {"b": 2.5}])
    assert json.loads(path.read_text()) == [{"a": 1}, {"b": 2.5}]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out.json"]


def test_every_probe_source_compiles_and_names_no_jax():
    assert list(probe.PROBES) == ["backend", "grid_copy", "consensus1024", "flash512", "encoder512"]
    assert list(probe.PROBES) == list(tpu_probe.PROBES)
    for name, src in probe.PROBES.items():
        compile(probe.PRELUDE + src, name, "exec")
        for word in ("jax", "svoc_tpu", "flax", "SVOC_PROBE_PLATFORM"):
            assert word not in probe.PRELUDE + src, (name, word)
    assert "resolve_device(None)" in probe.PRELUDE and "allow_tf32 = False" in probe.PRELUDE


def _fake_probe(ran, fail=lambda name, env: None):
    def run(name, timeout, extra_env=None):
        env = extra_env or {}
        ran.append((name, env.get("SVOC_PROBE_N_ORACLES"), env.get("SVOC_PROBE_ATTENTION")))
        return {"probe": name, "ok": True, **(fail(name, env) or {})}

    return run


def test_probe_bisect_stops_at_first_hang(monkeypatch, tmp_path):
    ran = []
    hang = lambda name, env: (  # noqa: E731
        {"ok": False, "timeout": True} if env.get("SVOC_PROBE_N_ORACLES") == "512" else None)
    monkeypatch.setattr(probe, "run_probe", _fake_probe(ran, hang))
    monkeypatch.setattr(probe, "REPO", str(tmp_path))
    rc = probe.main(["--only", "consensus1024"])
    assert [n for _, n, _ in ran] == ["128", "256", "512"]  # stopped before 1024
    assert rc == 1  # the hang keeps the run marked not ok
    recorded = json.loads((tmp_path / "GPU_PROBE.json").read_text())
    assert [r["probe"] for r in recorded] == ["consensus128", "consensus256", "consensus512"]
    assert recorded[-1]["timeout"] is True
    assert not (tmp_path / "GPU_PROBE.json.tmp").exists()


def test_probe_full_run_records_nine_and_persists_after_each(monkeypatch, tmp_path):
    ran, seen = [], []
    out = tmp_path / "GPU_PROBE.json"

    def fake(name, timeout, extra_env=None):
        seen.append(len(json.loads(out.read_text())) if out.exists() else 0)
        return _fake_probe(ran)(name, timeout, extra_env)

    monkeypatch.setattr(probe, "run_probe", fake)
    monkeypatch.setattr(probe, "REPO", str(tmp_path))
    assert probe.main([]) == 0
    assert seen == list(range(9))  # every earlier record was on disk before the next probe ran
    assert [r["probe"] for r in json.loads(out.read_text())] == [
        "backend", "grid_copy", "consensus128", "consensus256", "consensus512", "consensus1024",
        "flash512", "encoder512_dense", "encoder512_flash",
    ]
    assert [a for name, _, a in ran if name == "encoder512"] == ["dense", "flash"]
    assert [n for name, n, _ in ran if name == "consensus1024"] == ["128", "256", "512", "1024"]


def test_probe_consensus_sizes_cut_the_bisect(monkeypatch, tmp_path):
    ran = []
    monkeypatch.setattr(probe, "run_probe", _fake_probe(ran))
    monkeypatch.setattr(probe, "REPO", str(tmp_path))
    assert probe.main(["--consensus-sizes", "1024"]) == 0
    assert [r["probe"] for r in json.loads((tmp_path / "GPU_PROBE.json").read_text())] == [
        "backend", "grid_copy", "consensus1024", "flash512", "encoder512_dense", "encoder512_flash",
    ]
    assert [n for name, n, _ in ran if name == "consensus1024"] == ["1024"]
    ran.clear()
    assert probe.main(["--only", "consensus1024", "--consensus-sizes", "64,256"]) == 0
    assert [n for _, n, _ in ran] == ["64", "256"]
    assert [r["probe"] for r in json.loads((tmp_path / "GPU_PROBE.json").read_text())] == [
        "consensus64", "consensus256"]


def test_probe_jobs_keep_the_record_order(monkeypatch, tmp_path):
    ran, persisted = [], []

    def slow_first(name, env):  # the earliest probe lands last
        if name == "grid_copy":
            time.sleep(0.5)
            # every other probe has landed and been written meanwhile
            persisted.append([r["probe"] for r in json.loads((tmp_path / "GPU_PROBE.json").read_text())])

    monkeypatch.setattr(probe, "run_probe", _fake_probe(ran, slow_first))
    monkeypatch.setattr(probe, "REPO", str(tmp_path))
    assert probe.main(["--consensus-sizes", "1024", "--jobs", "5"]) == 0
    records = json.loads((tmp_path / "GPU_PROBE.json").read_text())
    assert [r["probe"] for r in records] == [
        "backend", "grid_copy", "consensus1024", "flash512", "encoder512_dense", "encoder512_flash",
    ]
    assert persisted == [["backend", "consensus1024", "flash512", "encoder512_dense", "encoder512_flash"]]
    assert [r.get("jobs") for r in records] == [None, 5, 5, 5, 5, 5]  # the canary runs alone
    assert ran[0][0] == "backend" and len(ran) == 6


def test_probe_aborts_on_a_dead_backend_and_fails_on_any_failure(monkeypatch, tmp_path, capsys):
    ran = []
    dead = lambda name, env: {"ok": False} if name == "backend" else None  # noqa: E731
    monkeypatch.setattr(probe, "run_probe", _fake_probe(ran, dead))
    monkeypatch.setattr(probe, "REPO", str(tmp_path))
    assert probe.main([]) == 1
    assert [name for name, _, _ in ran] == ["backend"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"abort": "backend unreachable"}

    ran.clear()
    bad = lambda name, env: {"ok": False} if name == "flash512" else None  # noqa: E731
    monkeypatch.setattr(probe, "run_probe", _fake_probe(ran, bad))
    assert probe.main([]) == 1 and len(ran) == 9  # a failed probe does not stop the others


def _gone(pid: int) -> bool:
    """No such process, or a zombie nobody has reaped yet."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_run_probe_on_real_subprocesses(monkeypatch, tmp_path):
    """A sleeping probe times out and takes the child it started with it
    (a hung probe's compiler must not outlive it), a raising one keeps
    its stderr tail, a silent one its stdout tail, a good one its record.
    The prelude is replaced: the real one needs a CUDA device."""
    monkeypatch.setattr(probe, "PRELUDE", "import json, os, subprocess, sys, time\n")
    pid_file = tmp_path / "child.pid"
    monkeypatch.setitem(
        probe.PROBES, "sleeper",
        "child = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)'])\n"
        f"open({str(pid_file)!r}, 'w').write(str(child.pid))\n"
        "time.sleep(60)")
    monkeypatch.setitem(probe.PROBES, "raiser", "raise RuntimeError('no kernel today')")
    monkeypatch.setitem(probe.PROBES, "mute", "print('not json')")
    monkeypatch.setitem(probe.PROBES, "good",
                        "print('noise')\nprint(json.dumps({'x': os.environ['SVOC_X'], 'cwd': os.getcwd()}))")
    t0 = time.time()
    r = probe.run_probe("sleeper", 3.0)
    assert r["probe"] == "sleeper" and r["ok"] is False and r["timeout"] is True
    assert 3.0 <= r["elapsed_s"] < 30 and time.time() - t0 < 30
    child = int(pid_file.read_text())
    deadline = time.time() + 10
    while not _gone(child) and time.time() < deadline:
        time.sleep(0.05)
    assert _gone(child)
    r = probe.run_probe("raiser", 60)
    assert r["ok"] is False and "timeout" not in r and "no kernel today" in r["stderr_tail"][-1]
    r = probe.run_probe("mute", 60)
    assert r["ok"] is False and r["stdout_tail"].strip() == "not json"
    r = probe.run_probe("good", 60, {"SVOC_X": "7"})
    assert r["ok"] is True and r["x"] == "7" and r["cwd"] == probe.REPO == str(REPO)


def test_a_real_probe_fails_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = probe.run_probe("backend", 120)
    assert r["ok"] is False and "timeout" not in r
    assert "CUDA" in " ".join(r["stderr_tail"])


def test_flash_parity_only_writes_a_verdict_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(flash_probe, "PARITY_SHAPES", ((16, 64),))
    verdict = flash_probe.parity_only(device="cpu")
    data = json.loads((tmp_path / "FLASH_PARITY_GPU.json").read_text())
    assert data == verdict and data["platform"] == "cpu"
    assert data["verdict"] == "rounding-equivalent"
    assert all(e["flash_within_bound"] for e in data["entries"])
    entry = data["entries"][0]
    assert (entry["b"], entry["t"], entry["h"], entry["d"]) == (16, 64, 12, 64)
    assert entry["err_flash_vs_f32_truth"] <= entry["bound"]
    assert (flash_probe.EPS_BF16, flash_probe.BOUND_ULPS) == (2.0 ** -8, 4.0)
    assert flash_probe.PARITY_SHAPES != ((256, 128), (8, 512))  # the patch held


def test_flash_probe_constants_are_the_reference_s():
    assert flash_probe.SHAPES == ((256, 128), (8, 512), (8, 2048), (2, 8192))
    assert flash_probe.PARITY_SHAPES == ((256, 128), (8, 512))
    assert (flash_probe.HEADS, flash_probe.HEAD_DIM) == (12, 64)


def test_flash_probe_main_at_a_tiny_shape(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(flash_probe, "SHAPES", ((2, 16), (1, 24)))
    results = flash_probe.main(device="cpu")
    assert json.loads((tmp_path / "FLASH_PROBE_GPU.json").read_text()) == results
    assert [(e["b"], e["t"]) for e in results] == [(2, 16), (1, 24)]
    for e in results:
        # bf16 outputs at a scale of a few units: a few bf16 ulps
        assert e["max_abs_diff"] <= 6e-2 and e["bwd_max_abs_diff"] <= 1.5e-1
        for key in ("dense_ms", "flash_ms", "dense_bwd_ms", "flash_bwd_ms", "speedup", "bwd_speedup"):
            assert e[key] > 0
        assert e["platform"] == "cpu" and e["flash_peak_gib"] is None
    assert not os.path.exists(tmp_path / "FLASH_PROBE_GPU.json.tmp")


def test_flash_probe_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (flash_probe.main, flash_probe.parity_only):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert list(tmp_path.iterdir()) == []
