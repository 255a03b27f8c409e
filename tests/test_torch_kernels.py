"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.  The
repo's ``tests/conftest.py`` imports JAX, so on a machine without JAX
run this file alone::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import pytest
import torch

from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.ops.flash_attention import (
    attention_tags,
    flash_attention_cuda,
    flash_attention_plain,
)
from svoc_torch.ops.fused_consensus import fused_consensus_cuda, fused_consensus_plain

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    return torch.device("cuda")


def _segments(b, t, gen, device):
    ids = torch.arange(1, t + 1, device=device)
    seg = torch.stack([
        torch.repeat_interleave(ids, torch.randint(1, t // 3, (t,), generator=gen, device=device))[:t]
        for _ in range(b)
    ])
    seg[:, t - t // 5 :] = 0  # padding tail
    seg[0] = 0  # a row of padding only: every query dead
    return seg.to(torch.int32).contiguous()


@pytest.mark.parametrize(
    "dtype,d,tol",
    [
        (torch.float32, 16, 2e-5),
        (torch.float32, 32, 2e-5),
        (torch.float32, 64, 2e-5),
        (torch.float32, 128, 2e-5),
        (torch.bfloat16, 64, 3e-2),
    ],
)
@pytest.mark.parametrize("mode", ["segments", "kmask"])
def test_flash_kernel_matches_plain(cuda, dtype, d, tol, mode):
    gen = torch.Generator(device=cuda).manual_seed(d)
    b, t, h = 3, 77, 2  # T is no multiple of any tile
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=cuda).to(dtype) for _ in range(3))
    if mode == "segments":
        qtag, ktag = attention_tags(q, segment_ids=_segments(b, t, gen, cuda))
    else:
        kmask = torch.rand(b, t, generator=gen, device=cuda) > 0.3
        kmask[0] = False
        qtag, ktag = attention_tags(q, kmask=kmask)
    out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, qtag, ktag, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    live = torch.isfinite(ref_lse)
    assert torch.equal(live, torch.isfinite(lse))
    torch.testing.assert_close(lse[live], ref_lse[live], atol=2e-5 if dtype == torch.float32 else 1e-3, rtol=0)
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("n,f,constrained", [(7, 2, True), (100, 12, False), (1024, 128, True)])
def test_consensus_kernel_matches_plain(cuda, n, f, constrained):
    gen = torch.Generator(device=cuda).manual_seed(n)
    values = torch.rand(n, 6, generator=gen, device=cuda)
    if not constrained:
        values = 20.0 + 3.0 * values
    cfg = ConsensusConfig(n_failing=f, constrained=constrained)
    out = fused_consensus_cuda(values, cfg)
    ref = fused_consensus_plain(values, cfg)
    torch.cuda.synchronize()
    assert torch.equal(out.reliable, ref.reliable)
    for field in ("essence", "essence_first_pass", "quadratic_risk",
                  "reliability_first_pass", "reliability_second_pass"):
        torch.testing.assert_close(getattr(out, field), getattr(ref, field), atol=1e-5, rtol=0)
    torch.testing.assert_close(out.skewness, ref.skewness, atol=1e-4, rtol=0)
    torch.testing.assert_close(out.kurtosis, ref.kurtosis, atol=1e-3, rtol=0)


def test_consensus_kernel_refuses_a_fleet_beyond_shared_memory(cuda):
    """The largest fleet that fits one block runs; the next power of two
    (whose sort buffers double) is refused before any launch."""
    before = fused_consensus_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_consensus_cuda(torch.zeros(8192, 6, device=cuda), ConsensusConfig())
    assert fused_consensus_cuda.launches == before
    values = torch.rand(4096, 6, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    cfg = ConsensusConfig(n_failing=512)
    out = fused_consensus_cuda(values, cfg)
    assert fused_consensus_cuda.launches == before + 1
    assert torch.equal(out.reliable, fused_consensus_plain(values, cfg).reliable)
