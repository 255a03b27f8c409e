"""Guards of the port: it loads no JAX (nor ``starknet_py``: the chain
adapter imports it only when a Sepolia backend is built), it defaults to
CUDA without a CPU fallback, and its CUDA wrappers refuse what their kernels do not
take before anything is built or launched."""

import dataclasses
import functools
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytest.importorskip("jax")

import svoc_torch
from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.device import resolve_device
from svoc_torch.flagship import FlagshipStep
from svoc_torch.ops import _build
from svoc_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_cuda,
    flash_dkv_cuda,
    flash_dq_cuda,
)
from svoc_torch.ops.fused_consensus import (
    fused_consensus,
    fused_consensus_cuda,
    fused_consensus_gated_claims,
    fused_consensus_gated_claims_cuda,
)
from svoc_torch.ops.fleet_draws import fleet_draws_cuda
from svoc_torch.ops.threefry import threefry_cuda
from svoc_torch.sim.oracle import draw_fleet
from svoc_torch.sim.prng import PRNGKey

REPO = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(svoc_torch.__path__, "svoc_torch.")
    )


def test_every_module_imports_without_jax_or_svoc_tpu():
    names = _modules()
    for name in ("svoc_torch.flagship", "svoc_torch.ops.fused_consensus",
                 "svoc_torch.train.trainer", "svoc_torch.utils.checkpoint",
                 "svoc_torch.robustness.sanitize", "svoc_torch.consensus.batch",
                 "svoc_torch.sim.generators", "svoc_torch.fabric.registry",
                 "svoc_torch.fabric.router", "svoc_torch.apps.session",
                 "svoc_torch.serving.batcher", "svoc_torch.serving.tier",
                 "svoc_torch.ops.dense_attention", "svoc_torch.ops.grid_copy",
                 "svoc_torch.models.forward", "svoc_torch.utils.artifacts",
                 "svoc_torch.tools.probe", "svoc_torch.tools.flash_probe",
                 "svoc_torch.runtime.native", "svoc_torch.io.pipeline", "svoc_torch.sim.prng",
                 "svoc_torch.ops.threefry", "svoc_torch.utils.rounding", "svoc_torch.ops.fixedpoint",
                 "svoc_torch.consensus.wsad_engine", "svoc_torch.consensus.state",
                 "svoc_torch.utils.metrics", "svoc_torch.durability.faultspace",
                 "svoc_torch.io.deploy", "svoc_torch.io.chain",
                 "svoc_torch.io.comment_store", "svoc_torch.utils.events",
                 "svoc_torch.utils.slo", "svoc_torch.resilience.breaker",
                 "svoc_torch.resilience.retry", "svoc_torch.resilience.supervisor",
                 "svoc_torch.fabric.session", "svoc_torch.fabric.scenario",
                 "svoc_torch.tools.fabric_smoke", "svoc_torch.obsplane",
                 "svoc_torch.obsplane.timeline", "svoc_torch.obsplane.ledger",
                 "svoc_torch.obsplane.plane", "svoc_torch.compile",
                 "svoc_torch.compile.universe", "svoc_torch.serving",
                 "svoc_torch.serving.cache", "svoc_torch.serving.frontend",
                 "svoc_torch.serving.scenario", "svoc_torch.tools.serving_smoke",
                 "svoc_torch.compile.cache", "svoc_torch.compile.modes", "svoc_torch.compile.prewarm",
                 "svoc_torch.obsplane.profiler", "svoc_torch.models.convert",
                 "svoc_torch.tools.finetune_demo", "svoc_torch.tools.coldstart_smoke",
                 "svoc_torch.cluster", "svoc_torch.cluster.placement", "svoc_torch.cluster.replica",
                 "svoc_torch.cluster.router", "svoc_torch.cluster.scenario",
                 "svoc_torch.obsplane.fleet", "svoc_torch.obsplane.hopchain",
                 "svoc_torch.obsplane.anomaly", "svoc_torch.tools.cluster_smoke",
                 "svoc_torch.tools.fleet_obs_smoke", "svoc_torch.sim.montecarlo",
                 "svoc_torch.sim.multimodal", "svoc_torch.robustness.attacks",
                 "svoc_torch.robustness.certify", "svoc_torch.tools.robustness_cert",
                 "svoc_torch.tools.obs_smoke", "svoc_torch.tools.obs_cost_smoke",
                 "svoc_torch.tools.obs_query", "svoc_torch.tools.postmortem",
                 "svoc_torch.tools.hotpath_smoke", "svoc_torch.parallel",
                 "svoc_torch.parallel.encoder_math", "svoc_torch.models.quant",
                 "svoc_torch.io.scraper", "svoc_torch.apps.commands", "svoc_torch.apps.cli",
                 "svoc_torch.apps.web", "svoc_torch.parallel.mesh", "svoc_torch.parallel.sharded",
                 "svoc_torch.parallel.claim_shard", "svoc_torch.parallel.serving",
                 "svoc_torch.tools.shard_smoke", "svoc_torch.parallel.ring_attention",
                 "svoc_torch.parallel.sp_encoder", "svoc_torch.parallel.pipeline", "svoc_torch.train",
                 "svoc_torch.analysis", "svoc_torch.analysis.findings", "svoc_torch.analysis.concurrency",
                 "svoc_torch.analysis.jitmap", "svoc_torch.analysis.callgraph", "svoc_torch.analysis.cache",
                 "svoc_torch.analysis.rules", "svoc_torch.analysis.taint", "svoc_torch.analysis.statecov",
                 "svoc_torch.analysis.emissions", "svoc_torch.analysis.shardspec",
                 "svoc_torch.analysis.interrules", "svoc_torch.analysis.engine", "svoc_torch.analysis.sarif",
                 "svoc_torch.tools.svoclint", "svoc_torch.tools.baseline_configs",
                 "svoc_torch.ops.fleet_draws"):
        assert name in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}: importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'svoc_tpu', 'starknet_py'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_no_source_mentions_jax_imports():
    for path in (REPO / "svoc_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax", "import flax",
                                            "from flax", "from svoc_tpu", "import svoc_tpu")), (
                f"{path}: {line}"
            )


def test_default_device_raises_without_cuda(monkeypatch):
    from svoc_torch.serving.scenario import run_serving_scenario
    from svoc_torch.tools import serving_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        FlagshipStep()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_serving_scenario(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving_smoke.main([])
    from svoc_torch.tools import coldstart_smoke, finetune_demo

    with pytest.raises(RuntimeError, match="CUDA"):
        coldstart_smoke.run(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune_demo.run(steps=2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_the_baseline_configs_default_to_cuda(monkeypatch):
    """BASELINE configs 1-4 resolve ``device=None`` to CUDA and raise
    without a card, before building a pipeline or drawing a fleet."""
    from svoc_torch.tools import baseline_configs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: baseline_configs.config1_pipeline(), lambda: baseline_configs.config3_pipeline(),
                 lambda: baseline_configs.config4_window(),
                 *(lambda c=c: baseline_configs.run(c, small=True) for c in (1, 2, 3, 4)),
                 lambda: baseline_configs.main(["--config", "2"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_the_cluster_and_the_fleet_plane_wait_for_nothing():
    """No docstring of the port says the cluster tier or the fleet plane
    waits for ROADMAP A11b any longer."""
    for path in (REPO / "svoc_torch").rglob("*.py"):
        assert "A11b" not in path.read_text(), path


def test_the_cluster_defaults_to_cuda(monkeypatch, tmp_path):
    from svoc_torch.cluster import Replica
    from svoc_torch.cluster.scenario import run_cluster_scenario
    from svoc_torch.serving.scenario import VirtualClock
    from svoc_torch.tools import cluster_smoke, fleet_obs_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: run_cluster_scenario(str(tmp_path / "s")),
                 lambda: Replica("r0", str(tmp_path / "r0"), chain_dir=str(tmp_path / "c"), seed=0,
                                 clock=VirtualClock()),
                 lambda: cluster_smoke.main([]), lambda: fleet_obs_smoke.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_the_reconfiguration_plane_and_the_fuzzer_wait_for_nothing():
    """No docstring of the port says the reconfiguration plane or the
    fuzzer waits for ROADMAP A11c any longer."""
    for path in (REPO / "svoc_torch").rglob("*.py"):
        assert "A11c" not in path.read_text(), path


def test_the_reconfiguration_plane_and_the_fuzzer_default_to_cuda(monkeypatch, tmp_path):
    from svoc_torch.cluster.reconfig_scenario import run_reconfig_scenario
    from svoc_torch.durability import fuzz
    from svoc_torch.tools import chaos_fuzz, reconfig_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(fuzz.FuzzPlan(seed=0, cycles=1).as_dict()))
    for call in (lambda: run_reconfig_scenario(str(tmp_path / "s")),
                 lambda: reconfig_smoke.main([]),
                 lambda: fuzz.run_fuzz_child(str(tmp_path / "f"), fuzz.FuzzPlan(seed=0, cycles=1), 0),
                 lambda: chaos_fuzz.main(["--child", str(tmp_path / "c"), "--plan", str(plan)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert "--device" not in fuzz.default_child_argv("p", "w", 0)


def test_the_estimators_and_the_obs_gates_default_to_cuda(monkeypatch, tmp_path):
    """The A4 and A12a entry points resolve ``device=None`` to CUDA and
    raise without a card, before drawing anything; ``import svoc_torch``
    alone does not import torch (a fuzz child times the two apart)."""
    from svoc_torch.sim import montecarlo, multimodal
    from svoc_torch.tools import obs_cost_smoke, obs_query, obs_smoke, postmortem, robustness_cert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace = tmp_path / "t.jsonl"
    trace.write_text("")
    for call in (lambda: robustness_cert.run(0, True),
                 lambda: robustness_cert.main(["--smoke"]),
                 lambda: obs_smoke.run(0),
                 lambda: obs_cost_smoke.run(0),
                 lambda: obs_query.main([str(trace)]),
                 lambda: postmortem.main(["--out-dir", str(tmp_path)]),
                 lambda: montecarlo.fleet_breakdown_curve(PRNGKey(0)),
                 lambda: multimodal.benchmark_multimodal(PRNGKey(0), [[0.2, 0.2], [0.8, 0.7]], 0.03)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not list(tmp_path.glob("*.json"))
    code = "import sys, svoc_torch; assert 'torch' not in sys.modules; print(svoc_torch.resolve_device('cpu'))"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, capture_output=True, text=True)
    assert out.stdout.strip() == "cpu"


def test_the_console_and_the_hot_path_gate_default_to_cuda(monkeypatch, capsys):
    """The A12b-A12d entry points: the hot-path twin, the CLI and the web
    server resolve ``--device cuda`` (their default) and raise without a
    card, before serving anything."""
    from svoc_torch.apps import cli, web
    from svoc_torch.apps.commands import CommandConsole
    from svoc_torch.tools import hotpath_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: hotpath_smoke.run(0, cycles=1),
                 lambda: hotpath_smoke.main(["--cycles", "1"]),
                 lambda: cli.main(["--disable_startup_fetch", "--seed-comments", "1"]),
                 lambda: web.main(["--disable_startup_fetch", "--seed-comments", "1", "--port", "0"]),
                 lambda: CommandConsole()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert "svoc web UI" not in capsys.readouterr().out


def test_the_compile_plane_waits_for_nothing():
    """No entry point of the port refuses for the compile plane (ROADMAP
    A10b) any longer."""
    for path in (REPO / "svoc_torch").rglob("*.py"):
        text = path.read_text()
        assert "A10b" not in text, path


def _qkv(d=16, dtype=torch.float32):
    x = torch.zeros(1, 8, 2, d, dtype=dtype)
    return x, x.clone(), x.clone()


def _tags():
    t = torch.ones(1, 8, dtype=torch.int32)
    return t, t.clone()


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: (*_qkv(d=24), *_tags()), "head dim"),
        (lambda: (*_qkv(dtype=torch.float16), *_tags()), "bfloat16 or float32"),
        (lambda: (*_qkv(), torch.ones(1, 8, dtype=torch.int64), _tags()[1]), "int32"),
        (lambda: (_qkv()[0].transpose(1, 2), *_qkv()[1:], *_tags()), "shapes differ"),
        (lambda: (_qkv(d=32)[0][..., ::2], *_qkv()[1:], *_tags()), "contiguous"),
        (lambda: (*_qkv(), *_tags()), "CUDA"),
    ],
)
def test_flash_kernel_wrapper_refuses(make, match):
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match=match):
        flash_attention_cuda(*make())
    assert flash_attention_cuda.launches == before


def _bwd_args(d=16, dtype=torch.float32, lse_dtype=torch.float32, dout=None):
    q, k, v = _qkv(d=d, dtype=dtype)
    stats = torch.zeros(1, 8, 2, dtype=lse_dtype)
    return (q, k, v, *_tags(), q.clone() if dout is None else dout, stats, stats.clone())


@pytest.mark.parametrize("wrapper", [flash_dq_cuda, flash_dkv_cuda], ids=["dq", "dkv"])
@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: _bwd_args(d=24), "head dim"),
        (lambda: _bwd_args(dtype=torch.float16), "bfloat16 or float32"),
        (lambda: _bwd_args(dout=torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)), "dout"),
        (lambda: _bwd_args(lse_dtype=torch.float64), "lse"),
        (lambda: _bwd_args(dout=torch.zeros(1, 8, 2, 32)[..., ::2]), "contiguous"),
        (lambda: _bwd_args(), "CUDA"),
    ],
)
def test_flash_backward_wrappers_refuse(wrapper, make, match):
    before = wrapper.launches
    with pytest.raises(ValueError, match=match):
        wrapper(*make())
    assert wrapper.launches == before


@pytest.mark.parametrize(
    "values,cfg,match",
    [
        (torch.zeros(8, 3), ConsensusConfig(smooth_mode="true"), "smooth_mode"),
        (torch.zeros(8, 3, dtype=torch.float64), ConsensusConfig(), "float32"),
        (torch.zeros(3, 8).T, ConsensusConfig(), "contiguous"),
        (torch.zeros(8), ConsensusConfig(), r"\[N, M\]"),
        (torch.zeros(0, 6), ConsensusConfig(), r"\[N, M\]"),
        (torch.zeros(8, 3), ConsensusConfig(), "CUDA"),
    ],
)
def test_consensus_kernel_wrapper_refuses(values, cfg, match):
    before = fused_consensus_cuda.launches
    with pytest.raises(ValueError, match=match):
        fused_consensus_cuda(values, cfg)
    assert fused_consensus_cuda.launches == before


def _cube(c=2, n=8, m=3, dtype=torch.float32, device="cpu"):
    return (torch.zeros(c, n, m, dtype=dtype, device=device),
            torch.ones(c, n, dtype=torch.bool, device=device),
            torch.ones(c, dtype=torch.bool, device=device))


@pytest.mark.parametrize(
    "make,cfg,match",
    [
        (lambda: _cube(), ConsensusConfig(smooth_mode="true"), "smooth_mode"),
        (lambda: _cube(dtype=torch.float64), ConsensusConfig(), "float32"),
        (lambda: (_cube()[0], _cube()[1].to(torch.uint8), _cube()[2]), ConsensusConfig(), "ok must be"),
        (lambda: (_cube()[0], _cube(n=7)[1], _cube()[2]), ConsensusConfig(), "ok must be"),
        (lambda: (*_cube()[:2], _cube(c=3)[2]), ConsensusConfig(), "claim_mask must be"),
        (lambda: (torch.zeros(2, 3, 8).transpose(1, 2), *_cube()[1:]), ConsensusConfig(), "contiguous"),
        (lambda: _cube(n=0), ConsensusConfig(), r"\[C, N, M\]"),
        (lambda: (torch.zeros(8, 3), *_cube()[1:]), ConsensusConfig(), r"\[C, N, M\]"),
        (lambda: _cube(), ConsensusConfig(), "CUDA"),
    ],
)
def test_gated_claims_kernel_wrapper_refuses(make, cfg, match):
    before = fused_consensus_gated_claims_cuda.launches
    with pytest.raises(ValueError, match=match):
        fused_consensus_gated_claims_cuda(*make(), cfg)
    assert fused_consensus_gated_claims_cuda.launches == before


def test_only_cpu_tensors_take_the_plain_versions():
    """A tensor on any other device goes to the kernel wrapper, which
    refuses it: there is no silent fallback."""
    from svoc_torch.consensus.batch import claims_consensus, claims_consensus_sanitized

    q = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fused_consensus(torch.zeros(8, 3, device="meta"), ConsensusConfig())
    values, ok, mask = _cube(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_consensus_gated_claims(values, ok, mask, ConsensusConfig())
    with pytest.raises(ValueError, match="CUDA"):
        claims_consensus(values, mask, ConsensusConfig())
    with pytest.raises(ValueError, match="CUDA"):
        claims_consensus_sanitized(values, mask, ConsensusConfig(), 0.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        draw_fleet(torch.zeros(2, 2, dtype=torch.int64, device="meta"), 50, 6, 1024, 128, 10)


def test_flash_encoder_on_cpu_never_counts_a_launch():
    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.models.packing import pack_tokens

    step = FlagshipStep(TINY_TEST, rows=2, seq=16, max_seg=2,
                        n_oracles=16, window_size=4, subset_size=2, params_dtype=None,
                        device="cpu")
    batch, _ = pack_tokens([[2, 5, 6, 3], [2, 7, 3], [2, 9, 9, 3]], 16, 2, 1, rows=2)
    counts = (flash_attention_cuda, fused_consensus_cuda, threefry_cuda, fleet_draws_cuda)
    before = [c.launches for c in counts]
    out, honest = step(batch, PRNGKey(0, "cpu"))
    assert out.essence.shape == (6,) and honest.shape == (16,)
    assert [c.launches for c in counts] == before


def test_dense_config_never_reaches_flash_attention(monkeypatch):
    """With ``cfg.attention == "dense"`` (the default) no encoder,
    pipeline or flagship variant calls the flash wrapper at all."""
    import svoc_torch.models.encoder as encoder_module
    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.models.packing import pack_tokens
    from svoc_torch.models.sentiment import SentimentPipeline

    def refuse(*args, **kwargs):
        raise AssertionError("flash_attention reached under attention='dense'")

    monkeypatch.setattr(encoder_module, "flash_attention", refuse)
    assert TINY_TEST.attention == "dense" and not TINY_TEST.remat
    counts = (flash_attention_cuda, flash_dq_cuda, flash_dkv_cuda, fused_consensus_cuda)
    before = [c.launches for c in counts]
    texts = ["a first comment", "another one", "and a third"]
    pipe = SentimentPipeline(TINY_TEST, seq_len=16, batch_size=2, device="cpu")
    assert pipe(texts).shape == pipe.call_packed(texts, 2).shape == (3, 6)
    state = pipe.model.train()
    ids, mask = (torch.from_numpy(a) for a in pipe.tokenizer(texts, 16))
    state(ids, mask).sum().backward()  # training through autograd of the dense chain
    batch, _ = pack_tokens([[2, 5, 6, 3], [2, 7, 3], [2, 9, 9, 3]], 16, 2, 1, rows=2)
    kw = dict(rows=2, seq=16, max_seg=2, n_oracles=16, window_size=2, subset_size=2,
              params_dtype=None, device="cpu")
    key = PRNGKey(0, "cpu")
    out, _ = FlagshipStep(TINY_TEST, variant="packed", **kw)(batch, key)
    assert out.essence.shape == (6,)
    dense = FlagshipStep(TINY_TEST, variant="dense", **kw)
    out, _ = dense(next(dense.comments(functools.partial(list, texts)))[0], key)  # a picklable source
    assert out.essence.shape == (6,)
    with pytest.raises(AssertionError, match="flash_attention reached"):
        FlagshipStep(TINY_TEST, variant="packed_flash", **kw)(batch, key)
    assert [c.launches for c in counts] == before


def test_cpu_train_step_never_counts_a_launch():
    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.models.encoder import init_params
    from svoc_torch.models.packing import PackedSentimentEncoder, pack_labels, pack_tokens
    from svoc_torch.train.trainer import PackedTrainBatch, init_state, make_packed_train_step, sgd

    with torch.device("meta"):
        model = PackedSentimentEncoder(dataclasses.replace(TINY_TEST, attention="flash"))
    state = init_state(model, init_params(TINY_TEST, seed=0, device="cpu"), sgd(0.1), device="cpu")
    batch, _ = pack_tokens([[2, 5, 6, 3], [2, 7, 3], [2, 9, 9, 3]], 16, 2, 1, rows=2)
    labels = pack_labels(batch, (torch.rand(3, TINY_TEST.n_labels) < 0.3).float().numpy())
    arrays = (batch.ids, batch.pos, batch.seg, batch.cls_pos, batch.seg_valid, labels)
    counts = (flash_attention_cuda, flash_dq_cuda, flash_dkv_cuda)
    before = [c.launches for c in counts]
    state, metrics = make_packed_train_step()(
        state, PackedTrainBatch(*(torch.from_numpy(a) for a in arrays))
    )
    assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
    assert [c.launches for c in counts] == before


def test_cpu_claim_step_never_counts_a_launch():
    from svoc_torch.fabric.registry import ClaimSpec
    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.serving.batcher import Request
    from svoc_torch.serving.tier import ClaimServingStep

    specs = [ClaimSpec(cid, n_oracles=16, n_failing=4) for cid in ("alpha", "beta", "gamma")]
    step = ClaimServingStep(specs, TINY_TEST, rows=8, seq=32, max_seg=4, params_dtype=None,
                            device="cpu")
    counts = (flash_attention_cuda, fused_consensus_cuda, fused_consensus_gated_claims_cuda,
              threefry_cuda, fleet_draws_cuda)
    before = [c.launches for c in counts]
    requests = [Request(cid, f"{cid} comment number {i}") for i in range(2) for cid in ("alpha", "gamma")]
    (result,) = step(requests)
    assert result.claims == ("alpha", "gamma") and result.out.essence.shape == (2, 6)
    assert result.ok.shape == (2, 16) and bool(result.ok.all())
    assert step.cycles == {"alpha": 1, "beta": 0, "gamma": 1}
    assert [c.launches for c in counts] == before


def test_build_paths_stay_in_the_package():
    assert _build.BUILD_DIR == REPO / "svoc_torch" / "_build"
    for name in ("flash_attention", "flash_attention_bwd", "fused_consensus",
                 "gated_claims_consensus", "grid_copy", "threefry", "fleet_draws"):
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build.library_path(name).parent == _build.BUILD_DIR


def test_library_path_covers_the_shared_headers(tmp_path, monkeypatch):
    """Editing a shared header (``csrc/*.cuh``) names a new library, so the
    next load builds anew; a file that is no source or header does not."""
    (tmp_path / "kernel.cu").write_text('#include "helpers.cuh"\n')
    (tmp_path / "helpers.cuh").write_text("// first\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("kernel")
    assert _build.library_path("kernel") == first
    (tmp_path / "notes.txt").write_text("not compiled")
    assert _build.library_path("kernel") == first
    (tmp_path / "helpers.cuh").write_text("// second\n")
    assert _build.library_path("kernel") != first
    assert first.parent == _build.BUILD_DIR


class _FakeCuda:
    """Stands in for what the launch helper asks of the CUDA runtime: the
    current device, ``set_device`` (recorded), and each device's current
    raw stream (7000 + its index)."""

    def __init__(self, monkeypatch, current):
        self.current, self.switches = current, []
        monkeypatch.setattr(torch.cuda, "current_device", lambda: self.current)
        monkeypatch.setattr(torch.cuda, "set_device", self.set_device)
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7000 + index,
                            raising=False)

    def set_device(self, index):
        self.switches.append(index)
        self.current = index


@pytest.mark.parametrize("index", [0, 1])
def test_launch_enters_the_tensors_device_and_passes_its_stream(monkeypatch, index):
    """The kernel runs with its tensors' device current, whatever device
    the caller has current, and gets that device's current stream last;
    the caller's device is current again after, also when the call
    raises."""
    cuda = _FakeCuda(monkeypatch, current=1 - index)
    calls = []

    def kernel(*args):
        calls.append((args, cuda.current))
        return 0

    _build.launch("probe", kernel, torch.device("cuda", index), 11, 22)
    assert calls == [((11, 22, 7000 + index), index)]
    assert cuda.switches == [index, 1 - index] and cuda.current == 1 - index  # restored

    def broken(*args):
        raise OSError("the call itself failed")

    with pytest.raises(OSError):
        _build.launch("probe", broken, torch.device("cuda", index))
    assert cuda.current == 1 - index


@pytest.mark.parametrize("device", [torch.device("cuda", 0), torch.device("cuda", 1),
                                    torch.device("cuda")], ids=["cuda0", "cuda1", "no_index"])
def test_launch_on_the_current_device_switches_nothing(monkeypatch, device):
    """Already current (or a device without an index, which means the
    current one): no device switch, and the current device's stream."""
    current = 1 if device.index == 1 else 0
    cuda = _FakeCuda(monkeypatch, current=current)
    calls = []
    _build.launch("probe", lambda *args: calls.append(args) or 0, device, 5)
    assert calls == [(5, 7000 + current)] and cuda.switches == []


def test_launch_raises_naming_the_kernel_on_a_cuda_error(monkeypatch):
    _FakeCuda(monkeypatch, current=0)
    with pytest.raises(RuntimeError, match="gated_claims_consensus kernel launch failed: CUDA error 1"):
        _build.launch("gated_claims_consensus", lambda *args: 1, torch.device("cuda", 0))


def test_only_the_launch_helper_asks_for_a_stream():
    """Every kernel wrapper launches through ``_build.launch``: no other
    module of ``svoc_torch/ops`` reads a current stream or a device."""
    for path in sorted((REPO / "svoc_torch" / "ops").glob("*.py")):
        text = path.read_text()
        if path.name == "_build.py":
            assert text.count("_cuda_getCurrentRawStream(") == 1
            assert text.count("torch.cuda.current_device(") == 1
        else:
            for word in ("current_stream", "cuda_stream", "RawStream", "set_device",
                         "current_device", "torch.cuda.device("):
                assert word not in text, (path.name, word)
            if "_build.load(" in text:
                assert "_build.launch(" in text, path.name


def test_the_mesh_paths_wait_for_nothing():
    """No source of the port says ring attention, the sequence-parallel
    encoder, the pipeline or the mesh train factories wait for ROADMAP
    A12e part 2 any longer, and the fine-tune twin has no ``--changed-mesh``
    flag (the reference has none: its restore always runs)."""
    for path in (REPO / "svoc_torch").rglob("*.py"):
        assert "A12e part 2" not in path.read_text(), path
    assert "--changed-mesh" not in (REPO / "svoc_torch" / "tools" / "finetune_demo.py").read_text()
