"""The port's ring attention against the JAX package's, on the CPU.

Twin of ``tests/test_ring_attention.py``: the reference runs
:func:`svoc_tpu.parallel.ring_attention.ring_attention_fn` on its 8
simulated CPU devices, the port :mod:`svoc_torch.parallel.ring_attention`
on 8 CPU slots (4 where the reference's interpret-mode flash ring needs
8-token hops of a 32-token sequence), on the same seeded numpy inputs.

Bars are the reference test's: the dense inner 2e-5 (extreme logits
5e-5, bf16 3e-2); the flash inner 2e-4; gradients 1e-5, the port's by
autograd through the rotation against the reference's two-pass VJP;
all-padding rows exactly 0, forward and gradient.  ``ppermute`` is held
to what ``jax.lax.ppermute`` gives on the same mesh.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svoc_tpu.parallel import ring_attention as ref_ring  # noqa: E402
from svoc_tpu.parallel.mesh import MeshSpec as RefMeshSpec  # noqa: E402
from svoc_tpu.parallel.mesh import make_mesh as ref_make_mesh  # noqa: E402
from svoc_tpu.parallel.sharded import shard_map as ref_shard_map  # noqa: E402

from svoc_torch.parallel import sharded  # noqa: E402
from svoc_torch.parallel.mesh import MeshSpec, P, make_mesh  # noqa: E402
from svoc_torch.parallel.ring_attention import dense_attention_reference, ring_attention_fn  # noqa: E402


def seq_mesh(n=8):
    return make_mesh(MeshSpec(("seq",), (n,)), device="cpu")


def ref_seq_mesh(n=8):
    return ref_make_mesh(RefMeshSpec(("seq",), (n,)), jax.devices()[:n])


def qkv(seed, b=2, t=64, h=4, d=16, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, t, h, d)) * s).astype(np.float32) for s in (scale, 1.0, 1.0)]


def both(arrays, dtype=torch.float32, jdtype=jnp.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays], [jnp.asarray(a, jdtype) for a in arrays]


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def padding_mask(seed, b, t):
    mask = (np.random.default_rng(seed).random((b, t)) > 0.3).astype(np.int32)
    mask[:, 0] = 1  # at least one real key a row
    return mask


@pytest.mark.parametrize("case", ["full", "padding", "extreme", "long"])
def test_dense_ring_matches_the_reference(case):
    b, t, h, d, bar, scale = 2, 64, 4, 16, 2e-5, 1.0
    if case == "extreme":
        scale, bar = 100.0, 5e-5  # logits of order 1e3: the streaming softmax must not overflow
    if case == "long":
        b, t, h, d = 1, 1024, 2, 8  # blocks of [1, 128, 2, 8] a slot
    arrays = qkv(3, b, t, h, d, scale)
    mask = padding_mask(2, b, t) if case == "padding" else np.ones((b, t), np.int32)
    (q, k, v), (jq, jk, jv) = both(arrays)
    out = ring_attention_fn(seq_mesh())(q, k, v, torch.from_numpy(mask))
    ref = ref_ring.ring_attention_fn(ref_seq_mesh())(jq, jk, jv, jnp.asarray(mask))
    assert out.shape == (b, t, h, d) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=bar, rtol=bar)
    dense = dense_attention_reference(q, k, v, torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=bar, rtol=bar)


def test_bf16_dense_ring_matches_the_reference():
    arrays = qkv(4)
    mask = np.ones((2, 64), np.int32)
    (q, k, v), (jq, jk, jv) = both(arrays, torch.bfloat16, jnp.bfloat16)
    out = ring_attention_fn(seq_mesh())(q, k, v, torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    ref = ref_ring.ring_attention_fn(ref_seq_mesh())(jq, jk, jv, jnp.asarray(mask))
    np.testing.assert_allclose(f32(out), f32(ref), atol=3e-2)
    np.testing.assert_allclose(f32(out), f32(dense_attention_reference(q, k, v, torch.from_numpy(mask))), atol=3e-2)


@pytest.mark.parametrize("dead_row", [False, True])
def test_flash_ring_matches_the_references_interpret_mode_flash_ring(dead_row):
    """Four slots of 8-token hops, T = 32: the reference's Pallas flash
    runs in interpret mode.  Row 0 loses its last 14 keys, so the last
    hop is all padding for it; with ``dead_row`` row 1 is all padding
    and comes out exactly 0."""
    b, t, h, d = 2, 32, 2, 16
    arrays = qkv(4, b, t, h, d)
    mask = np.ones((b, t), np.int32)
    mask[0, 18:] = 0
    if dead_row:
        mask[1] = 0
    (q, k, v), (jq, jk, jv) = both(arrays)
    out = ring_attention_fn(seq_mesh(4), block_impl="flash")(q, k, v, torch.from_numpy(mask))
    ref = ref_ring.ring_attention_fn(ref_seq_mesh(4), block_impl="flash")(jq, jk, jv, jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
    dense = ring_attention_fn(seq_mesh(4))(q, k, v, torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=2e-4)
    if dead_row:
        assert float(out[1].abs().max()) == 0.0 and float(np.abs(np.asarray(ref[1])).max()) == 0.0
    else:
        np.testing.assert_allclose(out.numpy(), dense_attention_reference(q, k, v, torch.from_numpy(mask)).numpy(),
                                   atol=2e-4)


def test_flash_ring_on_eight_slots_matches_the_dense_ring():
    """The reference's own composition test: q = k = v, 8 hops of 8
    tokens, row 0 padded from 40 (the port's plain flash needs no
    interpreter)."""
    (q, _, _), _ = both(qkv(4, 2, 64, 2, 16))
    mask = torch.ones((2, 64), dtype=torch.int32)
    mask[0, 40:] = 0
    flash = ring_attention_fn(seq_mesh(), block_impl="flash")(q, q, q, mask)
    dense = ring_attention_fn(seq_mesh())(q, q, q, mask)
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), atol=2e-4)
    np.testing.assert_allclose(flash.numpy(), dense_attention_reference(q, q, q, mask).numpy(), atol=2e-4)


@pytest.mark.parametrize("dead_row", [False, True])
def test_dense_ring_gradients_match_the_references_vjp(dead_row):
    b, t, h, d = 2, 64, 2, 8
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(4)]
    if dead_row:
        mask = np.ones((b, t), np.int32)
        mask[1] = 0
    else:
        mask = (np.arange(t)[None, :] < np.array([[t], [t - 20]])).astype(np.int32)
    ring = ring_attention_fn(seq_mesh())
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    cot = torch.from_numpy(arrays[3])
    (ring(q, k, v, torch.from_numpy(mask)) * cot).sum().backward()
    ref_fn = ref_ring.ring_attention_fn(ref_seq_mesh())
    jmask, jcot = jnp.asarray(mask), jnp.asarray(arrays[3])
    ref_grads = jax.grad(lambda *a: jnp.sum(ref_fn(*a, jmask) * jcot), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays[:3]))
    for name, ours, theirs in zip("qkv", (q.grad, k.grad, v.grad), ref_grads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5, err_msg=f"d{name}")
        if dead_row:
            assert float(ours[1].abs().max()) == 0.0, f"d{name} of the all-padding row"


def test_long_flash_ring_hop_is_the_dense_hop():
    """A longer flash ring (T = 256, 32 keys a hop) with a batch row
    whose last four shards are all padding."""
    (q, k, v), _ = both(qkv(9, 2, 256, 2, 16))
    mask = torch.ones((2, 256), dtype=torch.int32)
    mask[1, 100:] = 0
    flash = ring_attention_fn(seq_mesh(), block_impl="flash")(q, k, v, mask)
    np.testing.assert_allclose(flash.numpy(), dense_attention_reference(q, k, v, mask).numpy(), atol=2e-4)


@pytest.mark.parametrize("shift", [1, -1, 3])
def test_ppermute_matches_jax_and_carries_the_gradient_home(shift):
    """A cyclic shift and its inverse give what ``jax.lax.ppermute``
    gives on the same 8-way mesh; a partial permutation leaves zeros
    where no source sends; the gradient of a slot's output lands on the
    source slot's input."""
    from jax.sharding import PartitionSpec as JP

    n = 8
    perm = [(s, (s + shift) % n) for s in range(n)]
    x = np.random.default_rng(shift % 5).normal(size=(n * 2, 3)).astype(np.float32)

    def ours_body(a):
        return sharded.ppermute(a, "seq", perm)

    ours = sharded.shard_map(ours_body, mesh=seq_mesh(), in_specs=(P("seq", None),), out_specs=P("seq", None))
    theirs = jax.jit(ref_shard_map(lambda a: jax.lax.ppermute(a, "seq", perm), mesh=ref_seq_mesh(),
                                   in_specs=(JP("seq", None),), out_specs=JP("seq", None), check_rep=False))
    xt = torch.from_numpy(x).requires_grad_()
    out = ours(xt)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(theirs(jnp.asarray(x))))
    back = [(d, s) for s, d in perm]
    inverse = sharded.shard_map(lambda a: sharded.ppermute(a, "seq", back), mesh=seq_mesh(),
                                in_specs=(P("seq", None),), out_specs=P("seq", None))
    np.testing.assert_array_equal(inverse(out).detach().numpy(), x)
    weight = torch.arange(n * 2 * 3, dtype=torch.float32).reshape(n * 2, 3)
    (out * weight).sum().backward()
    # Slot s's block went to slot s + shift: its gradient is the weight there.
    expected = np.roll(weight.numpy().reshape(n, 2, 3), -shift, axis=0).reshape(n * 2, 3)
    np.testing.assert_array_equal(xt.grad.numpy(), expected)
    partial = [(0, 1), (1, 2)]
    part = sharded.shard_map(lambda a: sharded.ppermute(a, "seq", partial), mesh=seq_mesh(),
                             in_specs=(P("seq", None),), out_specs=P("seq", None))(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(part[2:6], x[0:4])
    assert not part[:2].any() and not part[6:].any()


def test_ppermute_refuses_what_is_no_permutation():
    body = lambda a: sharded.ppermute(a, "seq", [(0, 1), (2, 1)])  # noqa: E731
    with pytest.raises(ValueError, match="permutation"):
        sharded.shard_map(body, mesh=seq_mesh(), in_specs=(P("seq"),), out_specs=P("seq"))(torch.zeros(8))
    with pytest.raises(RuntimeError, match="shard_map body"):
        sharded.ppermute(torch.zeros(1), "seq", [(0, 0)])
    with pytest.raises(ValueError, match="block_impl"):
        ring_attention_fn(seq_mesh(), block_impl="splash")
