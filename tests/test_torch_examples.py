"""The port's example scripts (``svoc_torch.examples``) against the reference's
``examples/*.py``, on the CPU.

The reference scripts are loaded from their file paths (``examples/`` is
not a package).  Their stage functions are called where they have them;
the three whose stages live inside ``main`` (``multimodal_demo``,
``fleet_demo``, ``serving_demo``) run their ``main`` with
``--platform default`` or, for ``serving_demo``, as the reference's tests
would (its ``jax.config.update`` only repeats the CPU platform the
harness already set).  The port runs with ``device="cpu"``, the plain
versions.  Small sizes: K <= 50 trials, ``--steps 2``.

Bars, on the numbers each demo prints (:func:`svoc_torch.examples.compare_printed`,
the comparator phase 21c of ``chip_smoke.py`` uses too): every number
that does not come from a clock is parsed from both outputs and held to
one unit in its last printed place (the generators agree with JAX's to 3
ulp for normals and 1e-6 for Beta fleets, so a printed digit can round
the other way).  A number that counts trials may also move by one
trial's share, as the demo's ``printed_bars`` says: an identification
success or a dominant-pole share over K trials by 100/K percentage
points, a misflag rate over K trials of N oracles by 100/(K*N).
Reliabilities, errors and other means are held to their printed unit.
Integers (oracle and transaction counts, fixture felts) are exact, and
``to_cairo_fixture`` gives identical text on identical arrays.  The
fleet demo runs on the reference's flax weights (``params_from_flax``),
so its preview and commit are the reference's, its route the batched
certified one.
"""

from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from svoc_tpu.models import configs as ref_configs  # noqa: E402
from svoc_tpu.models.encoder import SentimentEncoder as RefEncoder  # noqa: E402
from svoc_tpu.models.encoder import init_params as ref_init_params  # noqa: E402
from svoc_tpu.ops.fixedpoint import to_cairo_fixture as ref_to_cairo_fixture  # noqa: E402
from svoc_tpu.sim import montecarlo as ref_montecarlo  # noqa: E402

from svoc_torch.examples import beta_kumaraswamy_demo, fleet_demo, gaussian_demo, multimodal_demo, serving_demo  # noqa: E402,E501
from svoc_torch.examples import compare_printed, without_clocks  # noqa: E402
from svoc_torch.models.from_jax import params_from_flax  # noqa: E402
from svoc_torch.ops.fixedpoint import to_cairo_fixture  # noqa: E402
from svoc_torch.parallel.serving import serving_mesh  # noqa: E402
from svoc_torch.sim import montecarlo, prng  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRIALS = 40
DEMOS = {"beta_kumaraswamy_demo": beta_kumaraswamy_demo, "gaussian_demo": gaussian_demo,
         "multimodal_demo": multimodal_demo, "fleet_demo": fleet_demo, "serving_demo": serving_demo}
#: The JAX package's one-device outcome at serving_demo's tiny default (4 rows, subsets of 10).
ONE_SLOT_ERROR = r"Cannot take a larger sample \(size 10\) than population \(size 4\)"


def reference(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def keys(seed: int = 0, n: int = 3):
    """``split(PRNGKey(seed), n)`` in both packages."""
    return list(jax.random.split(jax.random.PRNGKey(seed), n)), list(prng.split(prng.PRNGKey(seed, "cpu"), n))


def assert_same_numbers(got: str, want: str, bars=()):
    """:func:`compare_printed` holds: the same lines and words, each number
    within its printed unit and the bar ``bars`` gives it."""
    ok, gaps = compare_printed(got, want, bars)
    assert ok, gaps


def commit_routes() -> dict:
    """The commit plane's counts: chain RPCs by mode, batched-commit fallbacks by reason."""
    from svoc_torch.utils.metrics import registry

    return {f"{name}{{{k}={v}}}": value for name in ("chain_commit_rpcs", "commit_batch_fallback")
            for labels, value in registry.family_series(name) for k, v in labels.items()}


def run_port(capsys, fn, *args, **kwargs):
    capsys.readouterr()
    result = fn(*args, **kwargs)
    return result, capsys.readouterr().out


# -- beta_kumaraswamy_demo ----------------------------------------------------


def test_beta_single_fleet_walkthrough_matches(capsys):
    ref = reference("beta_kumaraswamy_demo")
    (jk, _, _), (tk, _, _) = keys()
    want_values, want = run_port(capsys, ref.single_fleet_walkthrough, jk)
    values, got = run_port(capsys, beta_kumaraswamy_demo.single_fleet_walkthrough, tk)
    np.testing.assert_allclose(values.numpy(), np.asarray(want_values), rtol=0, atol=1e-6)
    assert_same_numbers(got, want)
    assert "FAILING" in got and "on-chain two-pass kernel" in got


def test_beta_compare_models_matches(capsys):
    ref = reference("beta_kumaraswamy_demo")
    (_, jk, _), (_, tk, _) = keys()
    _, want = run_port(capsys, ref.compare_models, jk, n=4000)
    _, got = run_port(capsys, beta_kumaraswamy_demo.compare_models, tk, n=4000)
    assert_same_numbers(got, want)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_beta_grid_matches(capsys, use_kernel):
    """Stage 3 and 3b: the published grid through the notebook rule and
    the on-chain rule (one ``consensus_blocks`` cube a cell)."""
    (_, _, jk), (_, _, tk) = keys()
    want_lines, got_lines = [], []
    want = ref_montecarlo.launch_benchmark(jk, 7, 2, k_trials=TRIALS, print_fn=want_lines.append,
                                           use_kernel=use_kernel)
    got = montecarlo.launch_benchmark(tk, 7, 2, k_trials=TRIALS, print_fn=got_lines.append, use_kernel=use_kernel)
    assert set(got) == set(want) and len(got) == 8
    for cell in want:
        assert abs(got[cell]["identification_success_pct"] - want[cell]["identification_success_pct"]) <= 100 / TRIALS
        assert abs(got[cell]["reliability_pct"] - want[cell]["reliability_pct"]) <= 1e-2
    assert_same_numbers("\n".join(got_lines), "\n".join(want_lines), beta_kumaraswamy_demo.printed_bars(TRIALS))


def test_beta_main_prints_the_reference_s_stages(capsys, monkeypatch):
    compare = beta_kumaraswamy_demo.compare_models
    monkeypatch.setattr(beta_kumaraswamy_demo, "compare_models", lambda key: compare(key, n=4000))
    assert beta_kumaraswamy_demo.main(["--trials", "20", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    heads = [line for line in out.splitlines() if line.startswith("== ")]
    assert heads == ["== 1. single-fleet walkthrough ==", "== 2. Beta vs Kumaraswamy honest model ==",
                     "== 3. benchmark grid (notebook rule, K=20, N=7/2 failing) ==",
                     "== 3b. same grid through the on-chain two-pass kernel ==",
                     "== 4. Cairo test-fixture source for the stage-1 fleet =="]
    assert out.count(".span(),") == 7 and out.count("identification success") == 16


# -- the comparator of printed numbers ----------------------------------------

FLEET_RATES = "uniform adversaries (256/1024): per-oracle misflag rate 0.45 %, restricted-median reliability 99.87 %"
GRID_CELL = "a=10 | b=15.0     | identification success: 42.60 % | reliability : 96.47 %"


@pytest.mark.parametrize("got, want, bars, ok", [
    # One oracle-trial of 50 x 1024 is 0.002 points: a misflag rate may move by a printed unit and that.
    (FLEET_RATES.replace("0.45 %", "0.46 %"), FLEET_RATES, fleet_demo.printed_bars(50, 1024), True),
    (FLEET_RATES.replace("0.45 %", "0.47 %"), FLEET_RATES, fleet_demo.printed_bars(50, 1024), False),
    # A reliability is a mean, not a count of trials: its printed unit and no more.
    (FLEET_RATES.replace("99.87", "99.88"), FLEET_RATES, fleet_demo.printed_bars(50, 1024), True),
    (FLEET_RATES.replace("99.87", "99.89"), FLEET_RATES, fleet_demo.printed_bars(50, 1024), False),
    # One trial of 3000 is 0.033 points of identification success, and no more on the reliability.
    (GRID_CELL.replace("42.60", "42.64"), GRID_CELL, beta_kumaraswamy_demo.printed_bars(3000), True),
    (GRID_CELL.replace("42.60", "42.65"), GRID_CELL, beta_kumaraswamy_demo.printed_bars(3000), False),
    (GRID_CELL.replace("96.47", "96.49"), GRID_CELL, beta_kumaraswamy_demo.printed_bars(3000), False),
    # Integers exactly; the words must be the reference's.
    ("preview flags 206 oracles as suspect", "preview flags 205 oracles as suspect", (), False),
    ("preview flags 206 oracles as suspect", "preview flags 205 oracles as suspect", fleet_demo.printed_bars(50, 1024),
     True),
    ("preview flags 205 oracles as suspects", "preview flags 205 oracles as suspect", (), False),
])
def test_compare_printed_holds_each_number_to_its_own_bar(got, want, bars, ok):
    assert compare_printed(got, want, bars)[0] is ok


# -- the Cairo fixtures -------------------------------------------------------


@pytest.mark.parametrize("case", ["beta", "gaussian", "negative"])
def test_to_cairo_fixture_gives_identical_text(case):
    rng = np.random.default_rng(3)
    arrays = {"beta": rng.uniform(0, 1, (7, 2)).astype(np.float32),
              "gaussian": (rng.normal(size=(7, 2)) * 3 + 20).astype(np.float32),
              "negative": rng.normal(size=(5, 6)).astype(np.float32)}
    values = arrays[case]
    assert to_cairo_fixture(values) == ref_to_cairo_fixture(values)
    assert to_cairo_fixture(torch.from_numpy(values).numpy()) == ref_to_cairo_fixture(np.asarray(values))


# -- gaussian_demo ------------------------------------------------------------


def test_gaussian_single_fleet_walkthrough_matches(capsys):
    ref = reference("gaussian_demo")
    (jk, _), (tk, _) = keys(n=2)
    want_values, want = run_port(capsys, ref.single_fleet_walkthrough, jk)
    values, got = run_port(capsys, gaussian_demo.single_fleet_walkthrough, tk)
    np.testing.assert_allclose(values.numpy(), np.asarray(want_values), rtol=3e-6, atol=0)
    assert_same_numbers(got, want)
    assert to_cairo_fixture(values.numpy()) == ref_to_cairo_fixture(np.asarray(want_values))


def test_gaussian_estimator_quality_matches(capsys):
    """Stage 2 against the reference's own cells (its ``main`` computes
    them inline: ``benchmark_unconstrained`` keyed ``fold_in(k2, int(10 *
    scale))``, the on-chain rule)."""
    ref = reference("gaussian_demo")
    (_, jk), (_, tk) = keys(n=2)
    cells = gaussian_demo.estimator_quality(tk, TRIALS)
    for scale, got in cells.items():
        sigma = tuple(s * scale for s in ref.SIGMA)
        want = ref_montecarlo.benchmark_unconstrained(jax.random.fold_in(jk, int(10 * scale)), ref.MU, sigma, 7, 2,
                                                      k_trials=TRIALS, max_spread=ref.MAX_SPREAD, use_kernel=True)
        assert set(got) == set(want)
        assert abs(got["identification_success_pct"] - want["identification_success_pct"]) <= 100 / TRIALS
        for k in ("reliability_pct", "mean_onchain_reliability2_pct"):
            assert abs(got[k] - want[k]) <= 1e-3, k
        assert abs(got["mean_estimator_error"] - want["mean_estimator_error"]) <= 1e-5
    assert (gaussian_demo.MU, gaussian_demo.SIGMA, gaussian_demo.MAX_SPREAD) == (ref.MU, ref.SIGMA, ref.MAX_SPREAD)


# -- multimodal_demo ----------------------------------------------------------


def test_multimodal_main_matches_the_reference(capsys, monkeypatch):
    trials = 20
    monkeypatch.setattr(sys, "argv", ["multimodal_demo.py", "--trials", str(trials), "--platform", "default"])
    _, want = run_port(capsys, reference("multimodal_demo").main)
    rc, got = run_port(capsys, multimodal_demo.main, ["--trials", str(trials), "--device", "cpu"])
    assert rc == 0
    assert_same_numbers(got, want, multimodal_demo.printed_bars(trials))
    assert "adversaries caught in mask: 4/4" in got


# -- fleet_demo ---------------------------------------------------------------


@pytest.fixture(scope="module")
def flax_tiny():
    return ref_init_params(RefEncoder(ref_configs.TINY_TEST), seed=0)


def test_fleet_demo_matches_the_reference_on_its_weights(capsys, monkeypatch, flax_tiny):
    """The reference's ``main`` at 256 oracles (64 failing) and 10 trials
    against the port's :func:`fleet_demo.run` on the reference's weights:
    the preview, the batched certified commit, the chain's read-back and
    the fleet-scale rates, at :func:`fleet_demo.printed_bars` (a misflag
    rate within one oracle-trial's share, 100/(10*256) percentage points,
    the suspects within one oracle)."""
    trials, n, f = 10, 256, 64
    monkeypatch.setattr(sys, "argv", ["fleet_demo.py", "--trials", str(trials), "--platform", "default",
                                      "--oracles", str(n), "--failing", str(f)])
    _, want = run_port(capsys, reference("fleet_demo").main)
    before = commit_routes()
    result, got = run_port(capsys, fleet_demo.run, n, f, trials, device="cpu", params=params_from_flax(flax_tiny))
    routes = {k: v - before.get(k, 0) for k, v in commit_routes().items() if v != before.get(k, 0)}
    assert_same_numbers(without_clocks(got), without_clocks(want), fleet_demo.printed_bars(trials, n))
    assert result["n_tx"] == n and result["state"]["consensus_active"] is True
    assert f"{n} txs" in got and "active=True" in got
    assert routes == {"chain_commit_rpcs{mode=batch}": 1}, routes


# -- serving_demo -------------------------------------------------------------


def test_serving_demo_at_one_slot_raises_the_reference_s_error():
    with pytest.raises(ValueError, match=ONE_SLOT_ERROR):
        serving_demo.main(["--steps", "2", "--device", "cpu"])


def test_the_reference_serving_demo_raises_it_on_one_device():
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "serving_demo.py"), "--steps", "1"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and re.search(ONE_SLOT_ERROR, proc.stderr), proc.stderr[-500:]


def test_serving_demo_at_eight_slots_runs_the_four_rungs(capsys):
    rates, out = run_port(capsys, serving_demo.ladder, serving_mesh(["cpu"] * 8), 2)
    lines = out.strip().splitlines()
    assert lines[0] == "[serving demo] 8 device(s), tiny shapes, 128-oracle fleet, window 32"
    assert list(rates) == ["dense DP serving", "packed serving", "packed + pipelined", "packed + pipelined + int8"]
    assert all(r > 0 for r in rates.values()) and len(lines) == 6
    assert lines[-1] == "[serving demo] pipelined output verified equal to the plain step"
    assert serving_demo.main(["--steps", "1", "--slots", "8", "--device", "cpu"]) == 0


def test_serving_demo_header_is_the_reference_s(capsys):
    """The reference on its 8 devices and the port on 8 slots print the
    same header and rungs (the rates are clocks)."""
    assert reference("serving_demo").main(["--steps", "1"]) == 0
    want = capsys.readouterr().out
    serving_demo.main(["--steps", "1", "--slots", "8", "--device", "cpu"])
    got = capsys.readouterr().out
    assert without_clocks(got) == without_clocks(want)


# -- every demo ---------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_a_demo_without_device_raises_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"serving_demo": ["--steps", "1"], "fleet_demo": ["--trials", "1"]}.get(name, ["--trials", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        DEMOS[name].main(argv)


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_each_module_names_the_script_it_mirrors(name):
    module = DEMOS[name]
    assert f"examples/{name}.py" in module.__doc__ and callable(module.main)
    assert (ROOT / "examples" / f"{name}.py").exists()


def test_python_m_gaussian_demo_loads_no_jax():
    """``python -m svoc_torch.examples.gaussian_demo --device cpu
    --trials 20`` runs, and ``-X importtime`` shows no module of jax,
    flax or svoc_tpu imported."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "svoc_torch.examples.gaussian_demo", "--device", "cpu",
         "--trials", "20"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    imported = [line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines() if "import time:" in line]
    assert any(m == "svoc_torch.examples.gaussian_demo" for m in imported) or "torch" in imported
    leaked = [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "flax", "svoc_tpu")]
    assert not leaked, leaked
    assert "== 2. Monte-Carlo estimator quality (K=20) ==" in proc.stdout and ".span()," in proc.stdout
