"""The port's flash attention against the JAX package's, on the CPU.

``svoc_torch.ops.flash_attention.flash_attention`` (its plain version on
CPU tensors) is held against
``svoc_tpu.ops.pallas_attention.flash_attention(interpret=True)`` on the
same numpy inputs: packed segment ids and per-key masks, fully dead
rows, and the lse.  float32 within 2e-5, the bar of
``tests/test_pallas_attention.py``.

The bf16 inputs of the card reach a tensor-core body whose roundings
differ from the plain version's: :func:`_tensor_core_model` repeats them
here (bf16 operands, fp32 accumulation, the scale applied to the fp32
product, P rounded to bf16 before P·V, l summed from the fp32 P), and it
is held against the Pallas kernel on bf16 inputs at the bars the card
holds the kernel to (3e-2, lse 1e-3).
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.ops.pallas_attention import flash_attention as jax_flash

from svoc_torch.ops.flash_attention import (
    NEG_INF,
    attention_tags,
    flash_attention,
    flash_attention_plain,
    tag_mask,
)

TOL = 2e-5


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3)]


def _segments(b, t, seed):
    """Packed-row segment ids: runs of 1..S, then 0 padding; row 1 is
    all padding (every query dead)."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, t), np.int32)
    for r in range(b):
        if r == 1:
            continue
        pos, sid = 0, 1
        end = t - int(rng.integers(0, t // 4))
        while pos < end:
            n = int(rng.integers(1, t // 3))
            seg[r, pos : min(end, pos + n)] = sid
            pos, sid = pos + n, sid + 1
    return seg


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,t,h,d", [(3, 32, 2, 16), (2, 16, 3, 64)])
def test_segment_ids_match_pallas(b, t, h, d):
    q, k, v = _qkv(b, t, h, d, seed=t + d)
    seg = _segments(b, t, seed=d)
    ref, ref_lse = jax_flash(
        *map(jnp.asarray, (q, k, v)), segment_ids=jnp.asarray(seg),
        interpret=True, return_lse=True,
    )
    out, lse = flash_attention(*_torch(q, k, v), segment_ids=torch.from_numpy(seg), return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
    live = seg > 0
    np.testing.assert_allclose(lse.numpy()[live], np.asarray(ref_lse)[live], atol=TOL)
    # Padding queries see nothing: exact 0 out and -inf lse, as the reference.
    assert np.all(out.numpy()[~live] == 0.0)
    assert np.all(np.isneginf(lse.numpy()[~live])) and np.all(np.isneginf(np.asarray(ref_lse)[~live]))


def test_kmask_matches_pallas_with_a_dead_row():
    b, t, h, d = 3, 24, 2, 32
    q, k, v = _qkv(b, t, h, d, seed=7)
    kmask = (np.random.default_rng(1).uniform(size=(b, t)) > 0.3).astype(np.int32)
    kmask[2] = 0  # every key masked: the whole row is dead
    ref, ref_lse = jax_flash(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(kmask), interpret=True, return_lse=True
    )
    out, lse = flash_attention(*_torch(q, k, v), kmask=torch.from_numpy(kmask), return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
    assert np.all(out.numpy()[2] == 0.0) and np.all(np.isneginf(lse.numpy()[2]))
    np.testing.assert_allclose(lse.numpy()[:2], np.asarray(ref_lse)[:2], atol=TOL)


def test_no_mask_matches_pallas_without_lse():
    q, k, v = _qkv(2, 16, 2, 16, seed=3)
    ref = jax_flash(*map(jnp.asarray, (q, k, v)), interpret=True)
    out = flash_attention(*_torch(q, k, v))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


def test_bf16_inputs_give_bf16_output_near_f32():
    """bf16 in, bf16 out, fp32 arithmetic inside: within the bf16 bar
    (3e-2) of the float32 result."""
    q, k, v = _qkv(2, 16, 2, 16, seed=5)
    seg = torch.from_numpy(_segments(2, 16, seed=2))
    out = flash_attention(*(x.bfloat16() for x in _torch(q, k, v)), segment_ids=seg)
    ref = flash_attention(*_torch(q, k, v), segment_ids=seg)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)


def test_both_masks_is_an_error():
    q, k, v = _torch(*_qkv(1, 8, 1, 16, seed=0))
    ones = torch.ones(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="not both"):
        flash_attention(q, k, v, kmask=ones, segment_ids=ones)


def test_dispatcher_takes_the_plain_version_on_cpu():
    q, k, v = _torch(*_qkv(1, 8, 2, 16, seed=4))
    tags = torch.ones(1, 8, dtype=torch.int32)
    assert torch.equal(flash_attention(q, k, v), flash_attention_plain(q, k, v, tags, tags))


def _tensor_core_model(q, k, v, qtag, ktag):
    """The roundings of the bf16 body of ``csrc/flash_attention.cu`` on
    bf16 ``[B, T, H, D]`` inputs, for T <= 64 (one key tile, so the
    online recurrence is one step): ``(out bf16, lse fp32 [B, T, H])``."""
    assert q.dtype == torch.bfloat16 and q.shape[1] <= 64
    scale_log2 = math.log2(math.e) / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())  # exact bf16 products, fp32 sums
    s = torch.where(tag_mask(qtag, ktag)[:, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    offset = torch.where(m > NEG_INF, m * scale_log2, 0.0)
    p = torch.exp2(s * scale_log2 - offset)  # exactly 0 on a masked pair
    l = p.sum(dim=-1, keepdim=True)  # from the fp32 P
    pv = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), v.float())
    dead = m <= NEG_INF / 2
    out = torch.where(dead, 0.0, pv / l.clamp(min=1e-30)).permute(0, 2, 1, 3).bfloat16()
    lse = torch.where(dead, -torch.inf, (m * scale_log2 + torch.log2(l)) * math.log(2.0))
    return out, lse[..., 0].permute(0, 2, 1)


@pytest.mark.parametrize("mode", ["segments", "kmask"])
@pytest.mark.parametrize("b,t,h,d", [(3, 32, 2, 16), (2, 24, 2, 32), (2, 16, 3, 64), (2, 8, 2, 128)])
def test_tensor_core_roundings_meet_the_bars_against_pallas(mode, b, t, h, d):
    """bf16 inputs from a numpy seed, segments or a key mask, with a
    dead row: the model of the tensor-core body against the Pallas
    kernel in interpret mode (out 3e-2, lse 1e-3 on live rows; dead
    rows exactly 0 with lse -inf) and against the port's plain version,
    which the card holds the kernel to, at the same bars."""
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, _qkv(b, t, h, d, seed=d + t)))
    if mode == "segments":
        seg = _segments(b, t, seed=d)  # row 1 is padding only
        jmask, tmask = {"segment_ids": jnp.asarray(seg)}, {"segment_ids": torch.from_numpy(seg)}
    else:
        kmask = (np.random.default_rng(d).uniform(size=(b, t)) > 0.3).astype(np.int32)
        kmask[1] = 0  # every key masked: the whole row is dead
        jmask, tmask = {"kmask": jnp.asarray(kmask)}, {"kmask": torch.from_numpy(kmask)}
    ref, ref_lse = jax_flash(q, k, v, interpret=True, return_lse=True, **jmask)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16() for x in (q, k, v))
    qtag, ktag = attention_tags(tq, **tmask)
    out, lse = _tensor_core_model(tq, tk, tv, qtag, ktag)
    ref = np.asarray(ref.astype(jnp.float32))
    ref_lse = np.asarray(ref_lse)
    live = np.isfinite(ref_lse)
    assert out.dtype == torch.bfloat16 and np.array_equal(live, torch.isfinite(lse).numpy())
    assert not live[1].any() and np.all(out.float().numpy()[1] == 0.0) and np.all(ref[1] == 0.0)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2, rtol=0)
    np.testing.assert_allclose(lse.numpy()[live], ref_lse[live], atol=1e-3, rtol=0)
    plain, plain_lse = flash_attention_plain(tq, tk, tv, qtag, ktag, return_lse=True)
    torch.testing.assert_close(out.float(), plain.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(lse[torch.from_numpy(live)], plain_lse[torch.from_numpy(live)],
                               atol=1e-3, rtol=0)
