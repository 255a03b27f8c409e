"""Guards of the port: it loads no JAX, it defaults to CUDA without a
CPU fallback, and its CUDA wrappers refuse what their kernels do not
take before anything is built or launched."""

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
from svoc_torch.ops.flash_attention import flash_attention, flash_attention_cuda
from svoc_torch.ops.fused_consensus import fused_consensus, fused_consensus_cuda

REPO = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(svoc_torch.__path__, "svoc_torch.")
    )


def test_every_module_imports_without_jax_or_svoc_tpu():
    names = _modules()
    assert "svoc_torch.flagship" in names and "svoc_torch.ops.fused_consensus" in names
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


def test_only_cpu_tensors_take_the_plain_versions():
    """A tensor on any other device goes to the kernel wrapper, which
    refuses it: there is no silent fallback."""
    q = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fused_consensus(torch.zeros(8, 3, device="meta"), ConsensusConfig())


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


def test_build_paths_stay_in_the_package():
    assert _build.BUILD_DIR == REPO / "svoc_torch" / "_build"
    for name in ("flash_attention", "fused_consensus"):
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build.library_path(name).parent == _build.BUILD_DIR
