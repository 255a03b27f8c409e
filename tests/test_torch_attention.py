"""The port's flash attention against the JAX package's, on the CPU.

``svoc_torch.ops.flash_attention.flash_attention`` (its plain version on
CPU tensors) is held against
``svoc_tpu.ops.pallas_attention.flash_attention(interpret=True)`` on the
same numpy inputs: packed segment ids and per-key masks, fully dead
rows, and the lse.  float32 within 2e-5, the bar of
``tests/test_pallas_attention.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.ops.pallas_attention import flash_attention as jax_flash

from svoc_torch.ops.flash_attention import flash_attention, flash_attention_plain

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
