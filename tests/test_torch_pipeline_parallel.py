"""The port's GPipe pipeline forward against the JAX package's, on the CPU.

Twin of ``tests/test_pipeline_parallel.py``: flax-initialised weights
carried across by ``params_from_flax``; the reference runs on its 8
simulated CPU devices, the port on 8 CPU slots, on the same seeded numpy
ids.  Bars are the reference's: 2e-4 (3e-4 on 8 stages), bf16 2e-2.  The
port skips the schedule's bubbles (its module docstring), so its B1
launches under flash are ``M × n_layers`` a data index, which the
plain-version call count shows on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svoc_tpu.models.configs import TINY_TEST as REF_TINY  # noqa: E402
from svoc_tpu.models.encoder import SentimentEncoder as RefEncoder  # noqa: E402
from svoc_tpu.models.encoder import init_params as ref_init_params  # noqa: E402
from svoc_tpu.parallel.mesh import MeshSpec as RefMeshSpec  # noqa: E402
from svoc_tpu.parallel.mesh import make_mesh as ref_make_mesh  # noqa: E402
from svoc_tpu.parallel.pipeline import pipeline_forward_fn as ref_pipeline  # noqa: E402
from svoc_tpu.parallel.pipeline import stack_block_params as ref_stack  # noqa: E402

from svoc_torch.models.configs import TINY_TEST  # noqa: E402
from svoc_torch.models.encoder import SentimentEncoder, load_encoder  # noqa: E402
from svoc_torch.models.from_jax import params_from_flax  # noqa: E402
from svoc_torch.ops import flash_attention as flash_ops  # noqa: E402
from svoc_torch.parallel import pipeline_forward_fn, stack_block_params  # noqa: E402
from svoc_torch.parallel.mesh import MeshSpec, make_mesh  # noqa: E402


def batch(seed, b, t=16, lengths=None):
    ids = np.random.default_rng(seed).integers(4, TINY_TEST.vocab_size, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    for i, n in enumerate(lengths or ()):
        mask[i, n:] = 0
        ids[i, n:] = TINY_TEST.pad_id
    return ids, mask


def meshes(names, sizes):
    return make_mesh(MeshSpec(names, sizes), device="cpu"), ref_make_mesh(RefMeshSpec(names, sizes))


CASES = {
    # name: (n_layers, seed, mesh axes, sizes, microbatches, data axis, batch, lengths, bar)
    "two_stages": (2, 0, ("stage",), (2,), 4, None, 8, [16, 9, 16, 3, 16, 16, 12, 16], 2e-4),
    "eight_stages": (8, 1, ("stage",), (8,), 2, None, 4, None, 3e-4),
    "stage_by_data": (2, 2, ("stage", "data"), (2, 4), 2, "data", 16, None, 2e-4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_the_reference_and_the_unsharded_encoder(case):
    n_layers, seed, names, sizes, m, data_axis, b, lengths, bar = CASES[case]
    cfg = dataclasses.replace(TINY_TEST, n_layers=n_layers)
    ref_cfg = dataclasses.replace(REF_TINY, n_layers=n_layers)
    flax_params = ref_init_params(RefEncoder(ref_cfg), seed=seed)
    params = params_from_flax(flax_params)
    mesh, ref_mesh = meshes(names, sizes)
    ids, mask = batch(seed, b, lengths=lengths)
    out = pipeline_forward_fn(mesh, cfg, n_microbatches=m, data_axis=data_axis)(
        params, torch.from_numpy(ids), torch.from_numpy(mask))
    ref = ref_pipeline(ref_mesh, ref_cfg, n_microbatches=m, data_axis=data_axis)(
        flax_params, jnp.asarray(ids), jnp.asarray(mask))
    assert out.shape == (b, cfg.n_labels)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=bar)
    with torch.no_grad():
        plain = load_encoder(SentimentEncoder, cfg, params)(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=bar)


def test_stacked_blocks_are_the_references():
    flax_params = ref_init_params(RefEncoder(REF_TINY), seed=0)
    stacked, rest = stack_block_params(params_from_flax(flax_params), TINY_TEST)
    ref_stacked, ref_rest = ref_stack(flax_params, REF_TINY)
    assert sorted(rest) == sorted(ref_rest)
    np.testing.assert_array_equal(stacked["attention"]["query"]["weight"].numpy(),
                                  np.swapaxes(np.asarray(ref_stacked["attention"]["query"]["kernel"]), 1, 2))
    np.testing.assert_array_equal(stacked["ln_ffn"]["weight"].numpy(), np.asarray(ref_stacked["ln_ffn"]["scale"]))
    assert stacked["ffn_in"]["weight"].shape == (2, TINY_TEST.intermediate, TINY_TEST.hidden)


def test_flash_pipeline_skips_the_bubbles(monkeypatch):
    """Flash stages on a stage(2) × data(4) mesh: logits within 2e-4 of
    the dense pipeline; B1's plain version runs ``M × n_layers`` times a
    data index (16 here), not the reference's ``(S + M − 1) ×
    n_layers``."""
    flax_params = ref_init_params(RefEncoder(REF_TINY), seed=2)
    params = params_from_flax(flax_params)
    mesh, _ = meshes(("stage", "data"), (2, 4))
    ids, mask = batch(5, 16, lengths=[16, 3] * 8)
    calls = []
    plain = flash_ops.flash_attention_plain
    monkeypatch.setattr(flash_ops, "flash_attention_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    flash = pipeline_forward_fn(mesh, dataclasses.replace(TINY_TEST, attention="flash"), n_microbatches=2,
                                data_axis="data")(params, torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(calls) == 2 * TINY_TEST.n_layers * 4
    dense = pipeline_forward_fn(mesh, TINY_TEST, n_microbatches=2, data_axis="data")(
        params, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), atol=2e-4)


def test_pipeline_rejects_indivisible_layers_and_batches():
    mesh, _ = meshes(("stage",), (8,))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_forward_fn(mesh, TINY_TEST, n_microbatches=2)
    mesh2, _ = meshes(("stage",), (2,))
    fwd = pipeline_forward_fn(mesh2, TINY_TEST, n_microbatches=3)
    params = params_from_flax(ref_init_params(RefEncoder(REF_TINY), seed=0))
    ids, mask = batch(0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        fwd(params, torch.from_numpy(ids), torch.from_numpy(mask))


def test_bf16_pipeline_matches_the_reference():
    """bf16 matmuls: within 2e-2 of the reference's jitted pipeline and of
    the port's own bf16 encoder."""
    ref_cfg = dataclasses.replace(REF_TINY, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(TINY_TEST, dtype=torch.bfloat16)
    flax_params = ref_init_params(RefEncoder(ref_cfg), seed=3)
    params = params_from_flax(flax_params)
    ids, mask = batch(3, 4, lengths=[16, 7, 16, 11])
    mesh, ref_mesh = meshes(("stage",), (2,))
    out = pipeline_forward_fn(mesh, cfg, n_microbatches=2)(params, torch.from_numpy(ids), torch.from_numpy(mask))
    ref = ref_pipeline(ref_mesh, ref_cfg, n_microbatches=2)(flax_params, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)
    with torch.no_grad():
        plain = load_encoder(SentimentEncoder, cfg, params)(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(), atol=2e-2)
