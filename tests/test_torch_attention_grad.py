"""The port's flash-attention backward against the JAX package's, on the
CPU.

``flash_attention_bwd_plain`` (what ``FlashAttentionFunction`` runs for
CPU tensors) is held against ``jax.grad`` of
``svoc_tpu.ops.pallas_attention.flash_attention(interpret=True)``, whose
custom VJP runs the two Pallas backward kernels, on the same numpy
inputs and cotangent: packed segment ids and per-key masks with dead
rows, float32, within 1e-4 (the bar of
``tests/test_pallas_attention.py::test_flash_backward_matches_dense``).
Masked keys and padding queries get exactly zero gradient, as there.

The bf16 dq and dk/dv of the card come from tensor-core bodies whose
roundings differ from the plain version's: :func:`_dq_model` and
:func:`_dkv_model` repeat them (bf16 operands, fp32 accumulation, dS (and
P^T for dv) rounded to bf16 before the products that accumulate dq, dk
and dv, and dq's final rounding to bf16), and they are held against the
JAX VJP on bf16 inputs at the bar the card holds the kernels to (3e-2
plus one bf16 rounding, 2^-8 relative).
"""

import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.ops.pallas_attention import flash_attention as jax_flash

from svoc_torch.ops.flash_attention import (
    FlashAttentionFunction,
    attention_delta,
    attention_tags,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    tag_mask,
)

TOL = 1e-4


def _inputs(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4)]


def _segments(b, t, seed):
    """Runs of segment ids 1, 2, …, a padding tail, and a row of padding
    only (row 1: every query dead)."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, t), np.int32)
    for r in range(b):
        if r == 1:
            continue
        pos, sid, end = 0, 1, t - int(rng.integers(1, t // 4))
        while pos < end:
            n = int(rng.integers(1, t // 3))
            seg[r, pos : min(end, pos + n)] = sid
            pos, sid = pos + n, sid + 1
    return seg


def _kmask(b, t, seed):
    kmask = (np.random.default_rng(seed).uniform(size=(b, t)) > 0.3).astype(np.int32)
    kmask[-1] = 0  # every key masked: the whole row is dead
    return kmask


def _masks(mode, b, t, seed):
    """``(jax kwargs, torch kwargs)`` for one masking mode."""
    if mode == "segments":
        seg = _segments(b, t, seed)
        return {"segment_ids": jnp.asarray(seg)}, {"segment_ids": torch.from_numpy(seg)}
    kmask = _kmask(b, t, seed)
    return {"kmask": jnp.asarray(kmask)}, {"kmask": torch.from_numpy(kmask)}


def _jax_grads(q, k, v, cot, jmask):
    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, interpret=True, **jmask) * cot)

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("mode", ["segments", "kmask"])
@pytest.mark.parametrize("b,t,h", [(3, 32, 2), (2, 16, 3)])
def test_plain_backward_matches_jax_grad(mode, b, t, h):
    q, k, v, cot = _inputs(b, t, h, 16, seed=t + h)
    jmask, tmask = _masks(mode, b, t, seed=b)
    ref = _jax_grads(q, k, v, jnp.asarray(cot), jmask)

    tq, tk, tv, tcot = map(torch.from_numpy, (q, k, v, cot))
    qtag, ktag = attention_tags(tq, **tmask)
    out, lse = flash_attention_plain(tq, tk, tv, qtag, ktag, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, qtag, ktag, out, lse, tcot)
    for name, a, r in zip("qkv", got, ref):
        assert a.dtype == torch.float32 and a.shape == (b, t, h, 16)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("mode", ["segments", "kmask"])
def test_function_matches_autograd_through_the_plain_forward(mode):
    """The Function's backward equals ordinary autograd through
    ``flash_attention_plain`` (fp32, 1e-5), and its forward is the plain
    forward exactly."""
    b, t, h, d = 3, 24, 2, 32
    arrays = _inputs(b, t, h, d, seed=11)
    _, tmask = _masks(mode, b, t, seed=4)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    cot = torch.from_numpy(arrays[3])
    qtag, ktag = attention_tags(q, **tmask)

    ref_out = flash_attention_plain(q, k, v, qtag, ktag)
    ref = torch.autograd.grad((ref_out * cot).sum(), (q, k, v))
    out = flash_attention(q, k, v, **tmask)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("FlashAttentionFunction")
    got = torch.autograd.grad((out * cot).sum(), (q, k, v))
    assert torch.equal(out, ref_out)
    for name, a, r in zip("qkv", got, ref):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=0, msg=f"d{name}")


def test_masked_keys_and_padding_queries_get_exactly_zero_gradient():
    b, t, h, d = 3, 32, 2, 16
    q, k, v, cot = map(torch.from_numpy, _inputs(b, t, h, d, seed=2))
    seg = torch.from_numpy(_segments(b, t, seed=3))
    qtag, ktag = attention_tags(q, segment_ids=seg)
    out, lse = flash_attention_plain(q, k, v, qtag, ktag, return_lse=True)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, qtag, ktag, out, lse, cot)
    pad = seg == 0
    assert pad.any() and bool(pad[1].all())
    assert torch.all(dq[pad] == 0) and torch.all(dk[pad] == 0) and torch.all(dv[pad] == 0)
    assert bool(dq[~pad].abs().sum() > 0)

    kmask = torch.from_numpy(_kmask(b, t, seed=5))
    qtag, ktag = attention_tags(q, kmask=kmask)
    out, lse = flash_attention_plain(q, k, v, qtag, ktag, return_lse=True)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, qtag, ktag, out, lse, cot)
    masked = kmask == 0
    assert torch.all(dk[masked] == 0) and torch.all(dv[masked] == 0)
    assert torch.all(dq[-1] == 0)  # the row whose every key is masked


def test_return_lse_is_inference_only():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(1, 8, 1, 16, seed=0)[:3])
    with pytest.raises(ValueError, match="inference-only"):
        flash_attention(q, k, v, return_lse=True)
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, return_lse=True)
    assert out.grad_fn is None and lse.shape == (1, 8, 1)


def test_without_grad_the_forward_runs_alone():
    """Serving (``torch.inference_mode``) and tensors that need no grad
    take the forward exactly as before: no autograd Function."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 16, 2, 16, seed=6)[:3])
    tags = torch.ones(2, 16, dtype=torch.int32)
    with torch.inference_mode():
        served = flash_attention(q, k, v)
    assert torch.equal(served, flash_attention_plain(q, k, v, tags, tags))
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert flash_attention(qg, k, v).grad_fn is None
    assert flash_attention(qg, k, v).grad_fn is not None


def test_bf16_backward_keeps_dtypes_and_is_finite():
    q, k, v, cot = (torch.from_numpy(a).bfloat16() for a in _inputs(2, 16, 2, 16, seed=7))
    seg = torch.from_numpy(_segments(2, 16, seed=8))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = FlashAttentionFunction.apply(q, k, v, *attention_tags(q, segment_ids=seg))
    grads = torch.autograd.grad((out.float() * cot.float()).sum(), (q, k, v))
    assert out.dtype == torch.bfloat16
    for g in grads:
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())


def _bf16_case(mode, b, t, h, d):
    """bf16 inputs and cotangent from a numpy seed with dead rows: the
    torch tensors, their tags, the plain forward's ``out`` and ``lse``,
    and ``jax.grad`` of the Pallas flash (interpret mode) as fp32 numpy,
    computed once per case."""
    return _bf16_case_cached(mode, b, t, h, d)


@functools.lru_cache(maxsize=None)
def _bf16_case_cached(mode, b, t, h, d):
    arrays = [x.astype(jnp.bfloat16) for x in map(jnp.asarray, _inputs(b, t, h, d, seed=d + t))]
    jmask, tmask = _masks(mode, b, t, seed=b + d)
    ref = [np.asarray(g.astype(jnp.float32)) for g in _jax_grads(*arrays[:3], arrays[3], jmask)]
    tq, tk, tv, tdo = (torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16() for x in arrays)
    qtag, ktag = attention_tags(tq, **tmask)
    out, lse = flash_attention_plain(tq, tk, tv, qtag, ktag, return_lse=True)
    return (tq, tk, tv, qtag, ktag, out, lse, tdo), ref


def _dq_model(q, k, v, qtag, ktag, out, lse, dout):
    """The roundings of the bf16 dq body of ``csrc/flash_attention_bwd.cu``
    on bf16 ``[B, T, H, D]`` inputs, from the forward's ``out`` and
    ``lse``: S and dP from bf16 operands with fp32 sums, P = exp2 of the
    log2-scaled score less the log2-scaled lse (0 where masked or dead),
    dS = P (dP - delta) in fp32 rounded to bf16, dQ = scale * sum dS K in
    fp32, then the kernel's final rounding to bf16 (returned as fp32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    row_lse = lse.permute(0, 2, 1)[..., None]  # [B, H, Tq, 1]
    live = tag_mask(qtag, ktag)[:, None] & torch.isfinite(row_lse)
    log2e = math.log2(math.e)
    p = torch.where(live, torch.exp2(s * (scale * log2e) - torch.where(live, row_lse, 0.0) * log2e), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - attention_delta(out, dout).permute(0, 2, 1)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().float(), k.float()) * scale
    return dq.bfloat16().float()


@pytest.mark.parametrize("mode", ["segments", "kmask"])
@pytest.mark.parametrize("b,t,h,d", [(2, 16, 2, 16), (2, 16, 2, 32), (2, 16, 2, 64), (2, 8, 2, 128)])
def test_tensor_core_dq_roundings_meet_the_bar_against_jax_grad(mode, b, t, h, d):
    """The dq model against ``jax.grad`` of the Pallas flash (interpret
    mode) within 3e-2 + 2^-8 |ref| at every head width, and against the
    port's plain backward (the card's comparison) at the same bar; dead
    rows exactly 0."""
    (tq, tk, tv, qtag, ktag, out, lse, tdo), (ref_dq, _, _) = _bf16_case(mode, b, t, h, d)
    dq = _dq_model(tq, tk, tv, qtag, ktag, out, lse, tdo)
    plain_dq, _, _ = flash_attention_bwd_plain(
        tq.float(), tk.float(), tv.float(), qtag, ktag, out.float(), lse, tdo.float()
    )
    np.testing.assert_allclose(dq.numpy(), ref_dq, atol=3e-2, rtol=2.0**-8, err_msg="dq")
    torch.testing.assert_close(dq, plain_dq, atol=3e-2, rtol=2.0**-8, msg="dq")
    dead = ~torch.isfinite(lse).all(dim=-1)
    assert dead.any() and torch.all(dq[dead] == 0) and np.all(ref_dq[dead.numpy()] == 0.0)


def _dkv_model(q, k, v, qtag, ktag, out, lse, dout):
    """The roundings of the bf16 dk/dv body of
    ``csrc/flash_attention_bwd.cu`` on bf16 ``[B, T, H, D]`` inputs, from
    the forward's ``out`` and ``lse``: ``(dk, dv)`` in fp32, before the
    kernel's final rounding to bf16."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())  # exact bf16 products, fp32 sums
    row_lse = lse.permute(0, 2, 1)[..., None]  # [B, H, Tq, 1]
    live = tag_mask(qtag, ktag)[:, None] & torch.isfinite(row_lse)
    log2e = math.log2(math.e)
    p = torch.where(live, torch.exp2(s * (scale * log2e) - torch.where(live, row_lse, 0.0) * log2e), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - attention_delta(out, dout).permute(0, 2, 1)[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dout.float())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds.bfloat16().float(), q.float())
    return dk, dv


@pytest.mark.parametrize("mode", ["segments", "kmask"])
@pytest.mark.parametrize("b,t,h,d", [(2, 16, 2, 64), (2, 8, 2, 128)])
def test_tensor_core_dkv_roundings_meet_the_bar_against_jax_grad(mode, b, t, h, d):
    """bf16 inputs and cotangent from a numpy seed, with dead rows: the
    model's dk and dv against ``jax.grad`` of the Pallas flash (interpret
    mode) within 3e-2 + 2^-8 |ref|, and against the port's plain backward
    (the card's comparison) at the same bar; dead keys exactly 0."""
    (tq, tk, tv, qtag, ktag, out, lse, tdo), (_, ref_dk, ref_dv) = _bf16_case(mode, b, t, h, d)
    dk, dv = _dkv_model(tq, tk, tv, qtag, ktag, out, lse, tdo)
    _, plain_dk, plain_dv = flash_attention_bwd_plain(
        tq.float(), tk.float(), tv.float(), qtag, ktag, out.float(), lse, tdo.float()
    )
    for name, got, ref, plain in (("dk", dk, ref_dk, plain_dk), ("dv", dv, ref_dv, plain_dv)):
        np.testing.assert_allclose(got.numpy(), ref, atol=3e-2, rtol=2.0**-8, err_msg=name)
        torch.testing.assert_close(got, plain, atol=3e-2, rtol=2.0**-8, msg=name)
        dead = (ktag == 0).numpy()
        assert dead.any() and np.all(got.numpy()[dead] == 0.0) and np.all(ref[dead] == 0.0)
