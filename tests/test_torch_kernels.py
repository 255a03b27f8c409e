"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.  The
repo's ``tests/conftest.py`` imports JAX, so on a machine without JAX
run this file alone::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import dataclasses

import pytest
import torch

from svoc_torch.consensus.batch import pad_claim_cube
from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.ops.flash_attention import (
    attention_delta,
    attention_tags,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_cuda,
    flash_attention_plain,
    flash_dkv_cuda,
    flash_dq_cuda,
)
from svoc_torch.ops.fused_consensus import (
    fused_consensus_cuda,
    fused_consensus_gated_claims_cuda,
    fused_consensus_gated_claims_plain,
    fused_consensus_plain,
)

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    return torch.device("cuda")


def _segments(b, t, gen, device):
    ids = torch.arange(1, t + 1, device=device)
    lengths = torch.randint(1, max(2, t // 3), (t,), generator=gen, device=device)
    seg = torch.stack([torch.repeat_interleave(ids, lengths)[:t] for _ in range(b)])
    seg[:, t - t // 5 :] = 0  # padding tail
    seg[0] = 0  # a row of padding only: every query dead
    return seg.to(torch.int32).contiguous()


def _tags(q, mode, gen):
    b, t = q.shape[:2]
    if mode == "segments":
        return attention_tags(q, segment_ids=_segments(b, t, gen, q.device))
    kmask = torch.rand(b, t, generator=gen, device=q.device) > 0.3
    kmask[0] = False
    return attention_tags(q, kmask=kmask)


#: bf16 reaches the tensor-core bodies at every head width, T from one
#: token to many key tiles; float32 the CUDA-core bodies.
FWD_CASES = [(torch.float32, d, 77, 2e-5) for d in (16, 32, 64, 128)] + [
    (torch.bfloat16, d, t, 3e-2) for d in (16, 32, 64, 128) for t in (1, 77, 1000)
]


@pytest.mark.parametrize("dtype,d,t,tol", FWD_CASES)
@pytest.mark.parametrize("mode", ["segments", "kmask"])
def test_flash_kernel_matches_plain(cuda, dtype, d, t, tol, mode):
    gen = torch.Generator(device=cuda).manual_seed(d + t)
    b, h = 3, 2  # T is no multiple of any tile (but T = 1 fits one)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=cuda).to(dtype) for _ in range(3))
    qtag, ktag = _tags(q, mode, gen)
    out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, qtag, ktag, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    live = torch.isfinite(ref_lse)
    assert torch.equal(live, torch.isfinite(lse))
    torch.testing.assert_close(lse[live], ref_lse[live], atol=2e-5 if dtype == torch.float32 else 1e-3, rtol=0)
    assert torch.all(out[0] == 0) and torch.all(torch.isneginf(lse[0]))
    dead = ~live
    assert torch.all(out[dead] == 0) and torch.all(torch.isneginf(lse[dead]))


def _layout(kind, b, t, device):
    """Segment ids over [b, t]: one segment over every token (every pair
    live), or runs of 50 tokens (most tile pairs fully masked)."""
    if kind == "one_segment":
        return torch.ones(b, t, dtype=torch.int32, device=device)
    seg = (torch.arange(t, device=device) // 50 + 1).expand(b, t).clone()
    seg[:, -7:] = 0
    return seg.to(torch.int32).contiguous()


@pytest.mark.parametrize("kind", ["one_segment", "runs_of_50"])
@pytest.mark.parametrize("d,t", [(64, 1000), (128, 1000), (64, 4100)])
def test_flash_long_rows_are_exact_and_deterministic(cuda, kind, d, t):
    """bf16 over many tiles (65 key tiles at T = 4100), one segment and
    runs of 50 tokens: the forward, dq and dk/dv match their plain
    versions, and two launches give the same bits (one owner per row, no
    atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(d + t)
    b, h = 2, 3
    q, k, v, dout = (torch.randn(b, t, h, d, generator=gen, device=cuda).bfloat16() for _ in range(4))
    qtag, ktag = attention_tags(q, segment_ids=_layout(kind, b, t, cuda))
    out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    again, lse_again = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, qtag, ktag, return_lse=True)
    delta = attention_delta(out, dout)
    dq = flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta)
    dq2 = flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta)
    dk, dv = flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta)
    dk2, dv2 = flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta)
    rdq, rdk, rdv = flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), qtag, ktag, out.float(), lse, dout.float()
    )
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)
    live = torch.isfinite(ref_lse)
    assert torch.equal(live, torch.isfinite(lse))
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3, rtol=0)
    for name, got, r in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        torch.testing.assert_close(got.float(), r, atol=3e-2, rtol=2.0**-8, msg=name)
    dead = ktag == 0
    assert torch.all(out[dead] == 0) and torch.all(dk[dead] == 0) and torch.all(dv[dead] == 0)
    assert torch.all(dq[dead] == 0)  # a padding query: its lse is -inf


def test_flash_wrappers_refuse_misaligned_bf16(cuda):
    """A bf16 view that starts 2 bytes into its allocation: the 16-byte
    cp.async of the tensor-core bodies cannot read it, so every wrapper
    refuses it before any launch, in each of the places the body reads
    by cp.async (dq: q, k, v and dout)."""
    x = torch.zeros(1 + 8 * 2 * 16, device=cuda, dtype=torch.bfloat16)[1:].view(1, 8, 2, 16)
    ok = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.bfloat16)
    tags = torch.ones(1, 8, dtype=torch.int32, device=cuda)
    stats = torch.zeros(1, 8, 2, device=cuda)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    for wrapper, args in (
        (flash_attention_cuda, (x, ok, ok, tags, tags)),
        (flash_dq_cuda, (x, ok, ok, tags, tags, ok, stats, stats)),
        (flash_dq_cuda, (ok, x, ok, tags, tags, ok, stats, stats)),
        (flash_dq_cuda, (ok, ok, x, tags, tags, ok, stats, stats)),
        (flash_dq_cuda, (ok, ok, ok, tags, tags, x, stats, stats)),
        (flash_dkv_cuda, (ok, x, ok, tags, tags, ok, stats, stats)),
    ):
        before = wrapper.launches
        with pytest.raises(ValueError, match="16-byte"):
            wrapper(*args)
        assert wrapper.launches == before


def _bwd_case(cuda, b, t, h, d, dtype, mode, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, dout = (torch.randn(b, t, h, d, generator=gen, device=cuda).to(dtype) for _ in range(4))
    qtag, ktag = _tags(q, mode, gen)
    out, lse = flash_attention_cuda(q, k, v, qtag, ktag, return_lse=True)
    return q, k, v, qtag, ktag, out, lse, dout


BWD_CASES = [(torch.float32, d, 3, 77, 2) for d in (16, 32, 64, 128)] + [
    (torch.bfloat16, 64, 8, 128, 12)
] + [(torch.bfloat16, d, 3, t, 2) for d in (16, 32, 64, 128) for t in (1, 77, 1000)]


@pytest.mark.parametrize("dtype,d,b,t,h", BWD_CASES)
@pytest.mark.parametrize("mode", ["segments", "kmask"])
def test_flash_backward_kernels_match_plain(cuda, dtype, d, b, t, h, mode):
    """dq and dk/dv against the plain backward's fp32 result on the same
    inputs: float32 within 1e-4 (``tests/test_pallas_attention.py``);
    bf16 within 3e-2 plus one bf16 rounding (2^-8 relative) of the
    kernel's output.  Dead queries and keys no query sees: exactly 0.
    Two launches of each give the same bits (one owner per row)."""
    q, k, v, qtag, ktag, out, lse, dout = _bwd_case(cuda, b, t, h, d, dtype, mode, seed=d + t)
    delta = attention_delta(out, dout)
    dq = flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta)
    dk, dv = flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta)
    assert torch.equal(flash_dq_cuda(q, k, v, qtag, ktag, dout, lse, delta), dq)
    again = flash_dkv_cuda(q, k, v, qtag, ktag, dout, lse, delta)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    ref = flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), qtag, ktag, out.float(), lse, dout.float()
    )
    torch.cuda.synchronize()
    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (3e-2, 2.0**-8)
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), r, atol=atol, rtol=rtol, msg=name)
    dead_q = ~torch.isfinite(lse).all(dim=-1)
    dead_k = ktag == 0
    assert dead_q.any() and dead_k.any()
    assert torch.all(dq[dead_q] == 0)
    assert torch.all(dk[dead_k] == 0) and torch.all(dv[dead_k] == 0)


def test_gradients_reach_q_k_and_v_on_cuda(cuda):
    """The repaired fault: through the kernels, q, k and v all get
    gradients, equal to autograd through the plain forward."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, t, h, d = 4, 50, 3, 32
    seg = _segments(b, t, gen, cuda)
    leaves = [torch.randn(b, t, h, d, generator=gen, device=cuda).requires_grad_() for _ in range(3)]
    cot = torch.randn(b, t, h, d, generator=gen, device=cuda)
    before = (flash_dq_cuda.launches, flash_dkv_cuda.launches)
    got = torch.autograd.grad((flash_attention(*leaves, segment_ids=seg) * cot).sum(), leaves)
    assert (flash_dq_cuda.launches, flash_dkv_cuda.launches) == (before[0] + 1, before[1] + 1)
    qtag, ktag = attention_tags(leaves[0], segment_ids=seg)
    ref = torch.autograd.grad((flash_attention_plain(*leaves, qtag, ktag) * cot).sum(), leaves)
    for name, a, r in zip("qkv", got, ref):
        assert bool(a.abs().sum() > 0), name
        torch.testing.assert_close(a, r, atol=1e-4, rtol=0, msg=f"d{name}")


def test_encoder_projections_get_gradients_on_cuda(cuda):
    """``loss.backward()`` through the packed TINY_TEST encoder on CUDA
    gives every query, key and value projection the CPU's gradient."""
    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.models.encoder import init_params
    from svoc_torch.models.packing import PackedSentimentEncoder, pack_tokens
    from svoc_torch.train.trainer import init_state, sgd

    batch, _ = pack_tokens([[2, 5, 6, 3], [2, 7, 3], [2, 9, 9, 8, 3]], 16, 2, 1, rows=2)
    params = init_params(TINY_TEST, seed=0, device="cpu")
    grads = []
    for dev in ("cpu", "cuda"):
        with torch.device("meta"):
            model = PackedSentimentEncoder(dataclasses.replace(TINY_TEST, attention="flash"))
        state = init_state(model, params, sgd(0.1), device=dev)
        arrays = [torch.from_numpy(a).to(dev) for a in (batch.ids, batch.pos, batch.seg, batch.cls_pos)]
        state.model(*arrays).square().sum().backward()
        grads.append({n: p.grad.cpu() for n, p in state.model.named_parameters()})
    for i in range(TINY_TEST.n_layers):
        for w in ("query", "key", "value"):
            name = f"block_{i}.attention.{w}.weight"
            assert bool(grads[1][name].abs().sum() > 0), name
            torch.testing.assert_close(grads[1][name], grads[0][name], atol=1e-4, rtol=1e-4, msg=name)


@pytest.mark.parametrize("wrapper", [flash_dq_cuda, flash_dkv_cuda], ids=["dq", "dkv"])
@pytest.mark.parametrize("fault", ["dtype", "head_dim", "device", "contiguity"])
def test_flash_backward_wrappers_refuse_on_cuda(cuda, wrapper, fault):
    d = 24 if fault == "head_dim" else 16
    dtype = torch.float16 if fault == "dtype" else torch.float32
    q = torch.zeros(1, 8, 2, d, device=cuda, dtype=dtype)
    tags = torch.ones(1, 8, dtype=torch.int32, device=cuda)
    stats = torch.zeros(1, 8, 2, device=cuda)
    dout = q.clone()
    if fault == "device":
        stats = stats.cpu()
    if fault == "contiguity":
        dout = torch.zeros(1, 8, 2, 2 * d, device=cuda)[..., ::2]
    before = wrapper.launches
    with pytest.raises(ValueError):
        wrapper(q, q.clone(), q.clone(), tags, tags, dout, stats, stats.clone())
    assert wrapper.launches == before


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


def _tie_fleet(kind, n, gen, device):
    """Fleets whose ranks hinge on the tie order: values quantised to
    1e-2, every row equal (3/8, so that every sum is exact), or drawn
    from {-0.0, +0.0, 0.25, 0.5} (-0.0 ties with +0.0)."""
    if kind == "quantised":
        return torch.round(torch.rand(n, 6, generator=gen, device=device) * 100) / 100
    if kind == "all_equal":
        return torch.full((n, 6), 0.375, device=device)
    choice = torch.tensor([-0.0, 0.0, 0.25, 0.5], device=device)
    return choice[torch.randint(0, 4, (n, 6), generator=gen, device=device)].contiguous()


@pytest.mark.parametrize("n", [7, 1000, 1024, 2048, 5216])
@pytest.mark.parametrize("kind", ["quantised", "all_equal", "signed_zeros"])
def test_consensus_kernel_tie_order(cuda, kind, n):
    """Tie-heavy fleets, up to the largest the first port accepted at M =
    6 (5216): the reliable mask exact and the reference's bars."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    values = _tie_fleet(kind, n, gen, cuda)
    cfg = ConsensusConfig(n_failing=n // 8)
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
    """A 4096-oracle fleet runs; an 8192-oracle fleet, whose staged
    columns, risks and mask alone take 256 KB, is refused before any
    launch."""
    before = fused_consensus_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_consensus_cuda(torch.zeros(8192, 6, device=cuda), ConsensusConfig())
    assert fused_consensus_cuda.launches == before
    values = torch.rand(4096, 6, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    cfg = ConsensusConfig(n_failing=512)
    out = fused_consensus_cuda(values, cfg)
    assert fused_consensus_cuda.launches == before + 1
    assert torch.equal(out.reliable, fused_consensus_plain(values, cfg).reliable)


def _spectrum_cube(c, n, dim, constrained, gen, device):
    """Claim i is, by i % 4: clean; partly quarantined with a NaN row;
    all quarantined (n_ok = 0); a single survivor (n_ok = 1)
    (``tests/test_pallas_consensus.py:181-211``), padded to the claim
    bucket by ``pad_claim_cube``."""
    values = torch.rand(c, n, dim, generator=gen, device=device)
    if not constrained:
        values = 20.0 + 3.0 * values
    ok = torch.ones(c, n, dtype=torch.bool, device=device)
    for i in range(c):
        if i % 4 == 1:
            ok[i, : max(1, n // 4)] = False
            values[i, 0] = float("nan")
        elif i % 4 == 2:
            ok[i] = False
        elif i % 4 == 3:
            ok[i, : n - 1] = False
    return pad_claim_cube(values, ok)


def assert_gated_match(out, ref):
    """The reference's bars: reliable and interval_valid exact; floats
    within 1e-5 with infinite risks equal; skewness 1e-4; kurtosis 1e-3."""
    assert torch.equal(out.reliable, ref.reliable)
    assert torch.equal(out.interval_valid, ref.interval_valid)
    for field in ("essence", "essence_first_pass", "reliability_first_pass",
                  "reliability_second_pass"):
        torch.testing.assert_close(getattr(out, field), getattr(ref, field), atol=1e-5, rtol=0)
    inf = torch.isinf(ref.quadratic_risk)
    assert torch.equal(inf, torch.isinf(out.quadratic_risk))
    assert torch.equal(out.quadratic_risk[inf], ref.quadratic_risk[inf])
    torch.testing.assert_close(out.quadratic_risk[~inf], ref.quadratic_risk[~inf], atol=1e-5, rtol=0)
    torch.testing.assert_close(out.skewness, ref.skewness, atol=1e-4, rtol=0)
    torch.testing.assert_close(out.kurtosis, ref.kurtosis, atol=1e-3, rtol=0)


@pytest.mark.parametrize("constrained", [True, False])
@pytest.mark.parametrize("c", [1, 3, 64])
@pytest.mark.parametrize("n", [7, 16, 256, 1024])
def test_gated_claims_kernel_matches_plain(cuda, n, c, constrained):
    gen = torch.Generator(device=cuda).manual_seed(n * 100 + c)
    values, ok, claim_mask = _spectrum_cube(c, n, 6, constrained, gen, cuda)
    cfg = ConsensusConfig(n_failing=max(2, n // 8), constrained=constrained)
    before = fused_consensus_gated_claims_cuda.launches
    out = fused_consensus_gated_claims_cuda(values, ok, claim_mask, cfg)
    ref = fused_consensus_gated_claims_plain(values, ok, claim_mask, cfg)
    torch.cuda.synchronize()
    assert fused_consensus_gated_claims_cuda.launches == before + 1
    assert_gated_match(out, ref)
    assert not out.interval_valid[~claim_mask].any() and not out.reliable[~claim_mask].any()
    if c > 2:
        assert torch.isinf(out.quadratic_risk[2]).all() and not out.interval_valid[2]
        assert torch.all(out.essence[2] == 0) and torch.all(out.essence_first_pass[2] == 0)


def test_gated_claims_kernel_tie_order(cuda):
    """Values quantised to 1e-2: exact ties in the columns and the risks."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    values = torch.round(torch.rand(8, 1024, 6, generator=gen, device=cuda) * 100) / 100
    ok = torch.rand(8, 1024, generator=gen, device=cuda) > 0.05
    mask = torch.ones(8, dtype=torch.bool, device=cuda)
    cfg = ConsensusConfig(n_failing=128)
    out = fused_consensus_gated_claims_cuda(values.contiguous(), ok, mask, cfg)
    assert_gated_match(out, fused_consensus_gated_claims_plain(values, ok, mask, cfg))


def _largest_gated_fleet(dim):
    """The largest N whose [N, dim] claim the gated kernel's layout fits
    in one block's shared memory, asked of the built kernel."""
    from svoc_torch.ops.fused_consensus import MAX_SMEM_BYTES, _gated_smem_bytes

    lo, hi = 1, 65535
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if _gated_smem_bytes(mid, dim) <= MAX_SMEM_BYTES else (lo, mid - 1)
    return lo


def test_gated_claims_kernel_takes_every_fleet_the_bitonic_one_took(cuda):
    """N up to 4635 at M = 6 fitted the bitonic layout; the radix-select
    layout must take at least as many, and refuse the next N."""
    largest = _largest_gated_fleet(6)
    assert largest >= 4635
    with pytest.raises(ValueError, match="shared memory"):
        fused_consensus_gated_claims_cuda(
            torch.zeros(1, largest + 1, 6, device=cuda),
            torch.ones(1, largest + 1, dtype=torch.bool, device=cuda),
            torch.ones(1, dtype=torch.bool, device=cuda), ConsensusConfig())


@pytest.mark.parametrize("n", [7, 1024, 4635, "largest"])
@pytest.mark.parametrize("kind", ["quantised", "all_equal", "signed_zeros"])
def test_gated_claims_kernel_tie_kinds(cuda, kind, n):
    """Tie-heavy claims (two of four partly quarantined) up to the largest
    fleet the layout takes at M = 6: the reference's bars."""
    n = _largest_gated_fleet(6) if n == "largest" else n
    gen = torch.Generator(device=cuda).manual_seed(n + 7)
    values = torch.stack([_tie_fleet(kind, n, gen, cuda) for _ in range(4)])
    ok = torch.ones(4, n, dtype=torch.bool, device=cuda)
    ok[1:3] = torch.rand(2, n, generator=gen, device=cuda) > 0.1
    mask = torch.ones(4, dtype=torch.bool, device=cuda)
    cfg = ConsensusConfig(n_failing=max(2, n // 8))
    out = fused_consensus_gated_claims_cuda(values, ok, mask, cfg)
    assert_gated_match(out, fused_consensus_gated_claims_plain(values, ok, mask, cfg))


@pytest.mark.parametrize("failing", ["n/8", "zero"])
@pytest.mark.parametrize("n", [7, 1024])
def test_gated_claims_kernel_degenerate_cuts(cuda, n, failing):
    """All quarantined, a single survivor, fewer admitted rows than
    n_failing (a negative cut: no reliable row), and with n_failing = 0
    every row admitted (the cut at N: every row reliable)."""
    f = max(2, n // 8)
    gen = torch.Generator(device=cuda).manual_seed(n)
    values = torch.rand(5, n, 6, generator=gen, device=cuda)
    ok = torch.ones(5, n, dtype=torch.bool, device=cuda)
    ok[1] = False
    ok[2, : n - 1] = False
    ok[3, f - 1:] = False
    cfg = ConsensusConfig(n_failing=f if failing == "n/8" else 0)
    mask = torch.ones(5, dtype=torch.bool, device=cuda)
    out = fused_consensus_gated_claims_cuda(values, ok, mask, cfg)
    assert_gated_match(out, fused_consensus_gated_claims_plain(values, ok, mask, cfg))
    assert not out.interval_valid[1:3].any() and torch.isinf(out.quadratic_risk[1]).all()
    if failing == "zero":
        assert torch.equal(out.reliable, ok)
    else:
        assert not out.reliable[3].any() and not out.interval_valid[3]


def test_gated_claims_kernel_is_deterministic(cuda):
    """Two launches on the bench_claims cube are bit for bit equal."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    values = torch.rand(64, 1024, 6, generator=gen, device=cuda)
    ok = torch.rand(64, 1024, generator=gen, device=cuda) > 0.02
    mask = torch.ones(64, dtype=torch.bool, device=cuda)
    cfg = ConsensusConfig(n_failing=256)
    a = fused_consensus_gated_claims_cuda(values, ok, mask, cfg)
    b = fused_consensus_gated_claims_cuda(values, ok, mask, cfg)
    torch.cuda.synchronize()
    for x, y in zip(a, b):  # as raw bytes: NaN payloads and -0.0 count
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.parametrize("kernel", ["grid_copy", "gated_claims"])
def test_launch_runs_on_the_callers_stream(cuda, kernel):
    """Under ``torch.cuda.stream(s)`` the kernel runs on s: its input is
    written on s behind a spin of some milliseconds, so a launch on any
    other stream would read it before the write."""
    from svoc_torch.ops.grid_copy import grid_copy_cuda

    s = torch.cuda.Stream()
    if kernel == "grid_copy":
        x = torch.zeros(4, 256, 128, device=cuda)
    else:
        x = torch.zeros(2, 64, 6, device=cuda)
        ok = torch.ones(2, 64, dtype=torch.bool, device=cuda)
        mask = torch.ones(2, dtype=torch.bool, device=cuda)
        cfg = ConsensusConfig(n_failing=8)
    torch.cuda.synchronize()
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)  # about 50 ms on an H100
        x.copy_(torch.linspace(0.01, 0.99, x.numel(), device=cuda).view_as(x))
        if kernel == "grid_copy":
            out = grid_copy_cuda(x, (1, 128, 128))
        else:
            out = fused_consensus_gated_claims_cuda(x, ok, mask, cfg).essence
    s.synchronize()
    if kernel == "grid_copy":
        assert torch.equal(out, x)
    else:
        assert torch.equal(out, fused_consensus_gated_claims_plain(x, ok, mask, cfg).essence)


@pytest.mark.parametrize("fault", ["smooth_mode", "dtype", "ok_dtype", "ok_shape", "contiguity",
                                   "device", "shared_memory"])
def test_gated_claims_kernel_refuses_on_cuda(cuda, fault):
    n = 8192 if fault == "shared_memory" else 16
    values = torch.rand(2, n, 6, device=cuda)
    ok = torch.ones(2, n, dtype=torch.bool, device=cuda)
    mask = torch.ones(2, dtype=torch.bool, device=cuda)
    cfg = ConsensusConfig(smooth_mode="true" if fault == "smooth_mode" else "cairo")
    if fault == "dtype":
        values = values.double()
    if fault == "ok_dtype":
        ok = ok.to(torch.uint8)
    if fault == "ok_shape":
        ok = ok[:, :-1]
    if fault == "contiguity":
        values = torch.rand(2, 6, n, device=cuda).transpose(1, 2)
    if fault == "device":
        mask = mask.cpu()
    before = fused_consensus_gated_claims_cuda.launches
    with pytest.raises(ValueError):
        fused_consensus_gated_claims_cuda(values, ok, mask, cfg)
    assert fused_consensus_gated_claims_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,block",
    [
        ((4, 256, 128), (1, 128, 128)),  # the probe's: grid (4, 2, 1)
        ((4, 256, 128), (1, 64, 128)),
        ((3, 24, 40), (1, 8, 20)),  # column tiles; f32 rows of 80 bytes take the 16-byte path
        ((2, 10, 6), (1, 5, 3)),  # nothing 16-byte aligned: the scalar path
        ((5, 7, 9), (1, 1, 1)),  # one element per block
        ((2, 512, 1024), (1, 512, 1024)),  # one large tile per block
        ((2, 96, 160), (1, 48, 160)),  # 1920 words a tile: the unrolled loop's last round part full
        ((2, 8, 4096), (1, 2, 4096)),  # a tile row wider than the block's threads
    ],
)
def test_grid_copy_kernel_is_bit_exact(cuda, dtype, shape, block):
    from svoc_torch.ops.grid_copy import grid_copy, grid_copy_cuda, grid_copy_plain

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    x.view(-1)[0] = float("nan")
    before = grid_copy_cuda.launches
    out = grid_copy(x, block)
    torch.cuda.synchronize()
    assert grid_copy_cuda.launches == before + 1
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert out.dtype == dtype and out.data_ptr() != x.data_ptr()
    assert torch.equal(out.view(bits), x.view(bits))
    assert torch.equal(out.view(bits), grid_copy_plain(x, block).view(bits))


def test_grid_copy_kernel_on_an_unaligned_view(cuda):
    """A contiguous view that starts 4 bytes into an allocation: the
    wrapper sees the pointer and the kernel takes the scalar path."""
    from svoc_torch.ops.grid_copy import grid_copy_cuda

    base = torch.arange(1 + 4 * 256 * 128, dtype=torch.float32, device=cuda)
    x = base[1:].view(4, 256, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    out = grid_copy_cuda(x, (1, 128, 128))
    torch.cuda.synchronize()
    assert torch.equal(out, x)


@pytest.mark.parametrize("fault", ["divide", "contiguity", "dtype", "grid"])
def test_grid_copy_kernel_refuses_on_cuda(cuda, fault):
    from svoc_torch.ops.grid_copy import grid_copy_cuda

    x, block = torch.zeros(4, 256, 128, device=cuda), (1, 128, 128)
    if fault == "divide":
        block = (1, 100, 128)
    if fault == "contiguity":
        x = torch.zeros(4, 128, 256, device=cuda).transpose(1, 2)
    if fault == "dtype":
        x = x.double()
    if fault == "grid":
        x, block = torch.zeros(1, 65536, 4, device=cuda), (1, 1, 4)
    before = grid_copy_cuda.launches
    with pytest.raises(ValueError):
        grid_copy_cuda(x, block)
    assert grid_copy_cuda.launches == before


# ---------------------------------------------------------------------------
# threefry2x32 (svoc_torch/csrc/threefry.cu), bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,xor", [(1, 1 << 20, True), (1, 1 << 20, False), (1024, 50, True),
                                     (57344, 64, True), (3, 7, False), (5, 1, False)])
def test_threefry_kernel_equals_plain(cuda, b, n, xor):
    from svoc_torch.ops.threefry import threefry_cuda, threefry_plain

    gen = torch.Generator().manual_seed(b + n)
    keys = torch.randint(0, 2**32, (b, 2), generator=gen, dtype=torch.int64)
    want = threefry_plain(keys, n, xor=xor)
    before = threefry_cuda.launches
    got = threefry_cuda(keys.to(cuda), n, xor=xor)
    assert threefry_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_threefry_kernel_takes_a_base_per_key(cuda):
    from svoc_torch.ops.threefry import MASK, threefry_cuda, threefry_plain

    gen = torch.Generator().manual_seed(3)
    keys = torch.randint(0, 2**32, (64, 2), generator=gen, dtype=torch.int64)
    base = torch.randint(0, 2**32, (64,), generator=gen, dtype=torch.int64)
    base[0] = MASK  # base + i crosses 2**32: the high word counts
    for n in (1, 9):
        want = threefry_plain(keys, n, base)
        assert torch.equal(threefry_cuda(keys.to(cuda), n, base.to(cuda)).cpu(), want)
        assert torch.equal(threefry_cuda(keys.to(cuda), n, MASK).cpu(), threefry_plain(keys, n, MASK))


def test_threefry_draws_on_the_card_equal_the_cpu(cuda):
    from svoc_torch.sim import prng
    from svoc_torch.sim.oracle import assemble_fleet, draw_fleet

    keys = prng.split(prng.PRNGKey(0, "cpu"), 64)
    window = torch.rand(64, 64, 6, generator=torch.Generator().manual_seed(0))
    want = assemble_fleet(window, *draw_fleet(keys, 64, 6, 1024, 128, 10))
    got = assemble_fleet(window.to(cuda), *draw_fleet(keys.to(cuda), 64, 6, 1024, 128, 10))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    for n in (50, 2048):
        assert torch.equal(prng.permutation(keys.to(cuda), n).cpu(), prng.permutation(keys, n))
    assert torch.equal(prng.fold_in(keys.to(cuda), 7).cpu(), prng.fold_in(keys, 7))


@pytest.mark.parametrize("b,n,xor,base", [(3, 4097, True, 0), (7, 5, True, 2**32 - 3), (2, 6, False, 2**32 - 5)])
def test_threefry_kernel_ragged_groups_and_carries(cuda, b, n, xor, base):
    """Counter groups that end part full (odd rows take the scalar
    stores), and carries into the high word inside a thread's group."""
    from svoc_torch.ops.threefry import threefry_cuda, threefry_plain

    keys = torch.randint(0, 2**32, (b, 2), generator=torch.Generator().manual_seed(n), dtype=torch.int64)
    assert torch.equal(threefry_cuda(keys.to(cuda), n, base, xor).cpu(), threefry_plain(keys, n, base, xor))


# ---------------------------------------------------------------------------
# a fleet's draws (svoc_torch/csrc/fleet_draws.cu), bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,w,m,n,f,s", [
    (1, 50, 6, 1024, 128, 10),  # the flagship
    (64, 64, 6, 1024, 128, 10),  # the multi-claim step's batch
    (3, 64, 6, 2048, 128, 64),  # two shuffle rounds, S = W
    (5, 10, 6, 7, 0, 10),  # the fabric's fleets, no failing oracle
    (2, 1, 3, 64, 0, 1),  # W = 1: no round for the subsets
    (1, 1625, 6, 16384, 1000, 3),  # the kernel's limits
])
def test_fleet_draws_kernel_equals_plain(cuda, c, w, m, n, f, s):
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda, fleet_draws_plain
    from svoc_torch.ops.threefry import threefry_cuda

    keys = torch.randint(0, 2**32, (c, 2), generator=torch.Generator().manual_seed(c + n), dtype=torch.int64)
    want = fleet_draws_plain(keys, w, m, n, f, s)
    before = (fleet_draws_cuda.launches, threefry_cuda.launches)
    got = fleet_draws_cuda(keys.to(cuda), w, m, n, f, s)
    assert (fleet_draws_cuda.launches, threefry_cuda.launches) == (before[0] + 1, before[1])
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and g.shape == x.shape and torch.equal(g.cpu(), x)


def test_draw_fleet_on_the_card_is_one_fleet_draws_launch(cuda):
    from svoc_torch.ops.fleet_draws import fleet_draws_cuda
    from svoc_torch.ops.threefry import threefry_cuda
    from svoc_torch.sim import prng
    from svoc_torch.sim.oracle import draw_fleet

    keys = prng.split(prng.PRNGKey(3, "cpu"), 6).reshape(2, 3, 2)  # two leading axes
    want = draw_fleet(keys, 50, 6, 1024, 128, 10)
    before = (fleet_draws_cuda.launches, threefry_cuda.launches)
    got = draw_fleet(keys.to(cuda), 50, 6, 1024, 128, 10)
    assert (fleet_draws_cuda.launches, threefry_cuda.launches) == (before[0] + 1, before[1])
    assert all(torch.equal(g.cpu(), x) for g, x in zip(got, want))
    with pytest.raises(ValueError, match="two shuffle rounds"):
        draw_fleet(keys.to(cuda), 1626, 6, 1024, 128, 10)
    assert fleet_draws_cuda.launches == before[0] + 1


@pytest.mark.parametrize("n", [64, 1024])
def test_prefix_sweep_on_the_card_equals_the_cpu(cuda, n):
    """The batched commit's certification sweep (plain PyTorch, no kernel
    of its own) at K = N on the card against the CPU: rel₁, rel₂ and the
    sqrt arguments within 1e-5, the min variance and the boundary gap
    within 1e-6, and ``certify``'s booleans identical."""
    import numpy as np

    from svoc_torch.consensus import batch

    gen = torch.Generator().manual_seed(n)
    old = torch.rand(n, 6, generator=gen) * 0.9 + 0.05
    new = torch.rand(n, 6, generator=gen) * 0.9 + 0.05
    pos = torch.randperm(n, generator=gen).to(torch.int32)
    ks = torch.arange(1, n + 1, dtype=torch.int32).clamp(max=n - 1)
    for cfg in (ConsensusConfig(n_failing=n // 8), ConsensusConfig(n_failing=n // 4, constrained=False,
                                                                   max_spread=2.0)):
        want = batch.prefix_margins_sweep(old, new, pos, cfg, ks)
        got = batch.prefix_margins_sweep(old.to(cuda), new.to(cuda), pos.to(cuda), cfg, ks.to(cuda))
        for name, bar in [("rel1", 1e-5), ("rel2", 1e-5), ("sqrt_arg1", 1e-5), ("sqrt_arg2", 1e-5),
                          ("min_variance", 1e-6), ("boundary_gap", 1e-6)]:
            g, w = getattr(got, name), getattr(want, name)
            assert g.device.type == "cuda" and g.shape == (n,)
            assert (g.cpu() - w).abs().max().item() <= bar, name
        assert np.array_equal(batch.certify(got, cfg, True), batch.certify(want, cfg, True))


def test_batched_commit_sweeps_on_the_card(cuda):
    """Twin contracts, the sweep on the card and on the CPU: the same
    route and the same exact state, with the certified fast path taken."""
    import numpy as np

    from svoc_torch.consensus.state import OracleConsensusContract

    n = 64
    callers = [f"o{i}" for i in range(n)]
    twins = [OracleConsensusContract(["a0", "a1", "a2"], callers, n_failing_oracles=16, dimension=6,
                                     device=device) for device in ("cuda", "cpu")]
    rng = np.random.default_rng(5)
    for _ in range(2):
        preds = rng.uniform(0.05, 0.95, (n, 6))
        for c in twins:
            assert c.update_predictions_batch(callers, preds, on_uncertified="raise") == n
    assert [c.get_oracle_value_list("a0") for c in twins[:1]] == [twins[1].get_oracle_value_list("a0")]
    assert twins[0].get_consensus_value() == twins[1].get_consensus_value()
    assert twins[0].get_kurtosis() == twins[1].get_kurtosis()
