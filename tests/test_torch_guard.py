"""Guards of the port: it loads no JAX, it defaults to CUDA without a
CPU fallback, and its CUDA wrappers refuse what their kernels do not
take before anything is built or launched."""

import dataclasses
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
                 "svoc_torch.tools.probe", "svoc_torch.tools.flash_probe"):
        assert name in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}: importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'svoc_tpu'))\n"
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
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        FlagshipStep()
    assert resolve_device("cpu") == torch.device("cpu")


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


def test_flash_encoder_on_cpu_never_counts_a_launch():
    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.models.packing import pack_tokens

    step = FlagshipStep(TINY_TEST, rows=2, seq=16, max_seg=2,
                        n_oracles=16, window_size=4, subset_size=2, params_dtype=None,
                        device="cpu")
    batch, _ = pack_tokens([[2, 5, 6, 3], [2, 7, 3], [2, 9, 9, 3]], 16, 2, 1, rows=2)
    before = (flash_attention_cuda.launches, fused_consensus_cuda.launches)
    out, honest = step(batch, torch.Generator().manual_seed(0))
    assert out.essence.shape == (6,) and honest.shape == (16,)
    assert (flash_attention_cuda.launches, fused_consensus_cuda.launches) == before


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
    gen = torch.Generator().manual_seed(0)
    out, _ = FlagshipStep(TINY_TEST, variant="packed", **kw)(batch, gen)
    assert out.essence.shape == (6,)
    dense = FlagshipStep(TINY_TEST, variant="dense", **kw)
    out, _ = dense(next(dense.comments(lambda: texts))[0], gen)
    assert out.essence.shape == (6,)
    with pytest.raises(AssertionError, match="flash_attention reached"):
        FlagshipStep(TINY_TEST, variant="packed_flash", **kw)(batch, gen)
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
    counts = (flash_attention_cuda, fused_consensus_cuda, fused_consensus_gated_claims_cuda)
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
                 "gated_claims_consensus", "grid_copy"):
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


class _FakeDevice:
    """Stands in for ``torch.cuda.device``: records the device entered
    and what is current while the helper calls the kernel."""

    current = None
    entered = []

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self.previous, _FakeDevice.current = _FakeDevice.current, self.device
        _FakeDevice.entered.append(self.device)

    def __exit__(self, *exc):
        _FakeDevice.current = self.previous


@pytest.mark.parametrize("index", [0, 1])
def test_launch_enters_the_tensors_device_and_passes_its_stream(monkeypatch, index):
    """The kernel runs with its tensors' device current, whatever device
    the caller has current, and gets that device's current stream last."""
    monkeypatch.setattr(_FakeDevice, "entered", [])
    monkeypatch.setattr(_FakeDevice, "current", torch.device("cuda", 1 - index))
    monkeypatch.setattr(torch.cuda, "device", _FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 7000 + torch.device(device).index})())
    calls = []

    def kernel(*args):
        calls.append((args, _FakeDevice.current))
        return 0

    _build.launch("probe", kernel, torch.device("cuda", index), 11, 22)
    assert calls == [((11, 22, 7000 + index), torch.device("cuda", index))]
    assert _FakeDevice.entered == [torch.device("cuda", index)]
    assert _FakeDevice.current == torch.device("cuda", 1 - index)  # restored


def test_launch_raises_naming_the_kernel_on_a_cuda_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", _FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0})())
    with pytest.raises(RuntimeError, match="gated_claims_consensus kernel launch failed: CUDA error 1"):
        _build.launch("gated_claims_consensus", lambda *args: 1, torch.device("cuda", 0))


def test_only_the_launch_helper_asks_for_a_stream():
    """Every kernel wrapper launches through ``_build.launch``: no other
    module of ``svoc_torch/ops`` reads a current stream or a device."""
    for path in sorted((REPO / "svoc_torch" / "ops").glob("*.py")):
        text = path.read_text()
        if path.name == "_build.py":
            assert text.count("current_stream(") == 1 and text.count("torch.cuda.device(") == 1
        else:
            assert "current_stream" not in text and "cuda_stream" not in text, path.name
            if "_build.load(" in text:
                assert "_build.launch(" in text, path.name
