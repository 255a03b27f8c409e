"""The port's W8A8 forward and its functional encoder math against the JAX package's, on the CPU.

Twins of ``tests/test_quant.py`` and of the reference's
``parallel/encoder_math.py`` wiring, on TINY_TEST weights the reference
draws (``init_params(seed=3)``) and carries across with
``params_from_flax``:

- per dense layer, on identical float32 inputs: the weight fold
  (``w_int8``, ``w_scale``), the row quantization (``xq``, ``s``) and the
  int32 sums equal the reference's exactly; the float32 epilogue within
  one ulp (XLA may contract it into a fused multiply-add);
- ``quantize_params`` on the converted float weights equals the converted
  reference tree bit for bit, and the ``.npz`` round trip keeps int8;
- the functional forward with the default ``dense_fn`` equals the port's
  ``SentimentEncoder`` exactly at float32;
- both int8 forwards meet the reference's bars (logits within
  ``0.15·max(1, |ref|)`` of the float forward, vectors within 0.05,
  packed within 0.05 of unpacked) and stay within 1e-5 of the
  reference's int8 logits (measured: 4.2e-7);
- Q, K and V share one activation quantization;
- the reference's validation errors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax
import jax.numpy as jnp
import torch

from svoc_tpu.models import quant as ref_quant
from svoc_tpu.models.configs import TINY_TEST as REF_TINY
from svoc_tpu.models.encoder import SentimentEncoder as RefEncoder
from svoc_tpu.models.encoder import init_params as ref_init_params

from svoc_torch.models import quant
from svoc_torch.models.configs import TINY_TEST
from svoc_torch.models.convert import load_params, save_params
from svoc_torch.models.encoder import SentimentEncoder, load_encoder
from svoc_torch.models.from_jax import params_from_flax
from svoc_torch.models.packing import PackedSentimentEncoder
from svoc_torch.models.sentiment import SentimentPipeline
from svoc_torch.parallel import encoder_math

CFG = TINY_TEST
TEXTS = [
    "the rollout went great, everyone is thrilled",
    "this outage is infuriating and support is silent",
    "mildly annoyed by the new UI but it works",
    "nervous about the migration tomorrow",
    "deeply sorry about the data loss",
    "what an exciting launch day!",
]


@pytest.fixture(scope="module")
def weights():
    """The reference's seed-3 TINY tree and its conversion."""
    ref = jax.device_get(ref_init_params(RefEncoder(REF_TINY), seed=3))
    return ref, params_from_flax(ref)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, CFG.vocab_size, size=(4, 32)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 20:] = 0
    mask[3, 8:] = 0
    return np.where(mask > 0, ids, CFG.pad_id).astype(np.int32), mask


def _dense_paths():
    for i in range(CFG.n_layers):
        for name in quant._BLOCK_DENSES:
            yield i, name


def _ref_node(tree, i, name):
    block = tree["params"][f"block_{i}"]
    return block["attention"][name] if name in block["attention"] else block[name]


# ---------------------------------------------------------------------------
# Per dense: the quantization is the reference's exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i,name", list(_dense_paths()))
def test_each_dense_quantizes_exactly_as_the_reference(weights, i, name):
    ref_tree, params = weights
    prefix = quant._dense_prefix(i, name)
    ref_p = _ref_node(ref_tree, i, name)
    ref_q = ref_quant.quantize_dense(ref_p)
    q = quant.quantize_dense({"weight": params[prefix + "weight"], "bias": params[prefix + "bias"]})
    np.testing.assert_array_equal(q["w_int8"].numpy(), np.asarray(ref_q["w_int8"]).T)
    np.testing.assert_array_equal(q["w_scale"].numpy(), np.asarray(ref_q["w_scale"]))
    assert q["w_int8"].dtype == torch.int8 and q["w_int8"].is_contiguous()

    rng = np.random.default_rng(100 + 7 * i + len(name))
    width = q["w_int8"].shape[1]
    x = (rng.normal(size=(3, 16, width)) * rng.uniform(0.1, 4.0, size=(3, 16, 1))).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row keeps the 1e-8 floor honest
    ref_xq, ref_s = ref_quant._quantize_rows(jnp.asarray(x))
    xq, s = quant._quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(ref_xq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))

    ref_acc = jax.lax.dot_general(ref_xq, ref_q["w_int8"], (((2,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
    acc = quant.int8_matmul(xq, q["w_int8"])
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc))

    out = quant.qdense(torch.from_numpy(x), q, torch.float32).numpy()
    ref_out = np.asarray(ref_quant.qdense(jnp.asarray(x), ref_q, jnp.float32))
    ulp = np.spacing(np.maximum(np.abs(out), np.abs(ref_out)).astype(np.float32))
    assert np.all(np.abs(out - ref_out) <= ulp)


def test_quantize_params_equals_the_converted_reference_tree(weights):
    ref_tree, params = weights
    ours = quant.quantize_params(params, CFG)
    theirs = params_from_flax(jax.device_get(ref_quant.quantize_params(ref_tree, REF_TINY)))
    assert set(ours) == set(theirs)
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype, key
        assert torch.equal(ours[key], theirs[key]), key
    assert quant.is_quantized_tree(ours) and not quant.is_quantized_tree(params)
    float_bytes = sum(t.numel() * t.element_size() for t in params.values())
    assert quant.quantized_size_bytes(ours) < float_bytes
    assert torch.equal(ours["tok_emb.weight"], params["tok_emb.weight"])  # the rest verbatim
    assert "head_dense.weight" in ours


def test_qdense_preserves_exact_zero_rows():
    q = quant.quantize_dense({"weight": torch.ones(4, 8), "bias": torch.zeros(4)})
    assert torch.equal(quant.qdense(torch.zeros(2, 8), q, torch.float32), torch.zeros(2, 4))


# ---------------------------------------------------------------------------
# The functional encoder math
# ---------------------------------------------------------------------------


def test_functional_forward_equals_the_module_exactly(weights):
    _ref, params = weights
    ids, mask = (torch.from_numpy(a).long() for a in _inputs())
    tree = encoder_math.param_tree(params)
    x = encoder_math.embed_tokens(ids, encoder_math.local_position_ids(mask, CFG), tree, CFG)
    for i in range(CFG.n_layers):
        x = encoder_math.encoder_block(x, mask, tree[f"block_{i}"], CFG)
    functional = encoder_math.cls_head(x[:, 0, :], tree, CFG)
    with torch.no_grad():
        module = load_encoder(SentimentEncoder, CFG, params)(ids, mask)
    assert torch.equal(functional, module)


# ---------------------------------------------------------------------------
# The whole forward
# ---------------------------------------------------------------------------


def test_int8_logits_track_the_float_forward_and_the_reference(weights):
    ref_tree, params = weights
    ids, mask = _inputs()
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    with torch.no_grad():
        floats = load_encoder(SentimentEncoder, CFG, params)(t_ids, t_mask).numpy()
    out = quant.quantized_forward(quant.quantize_params(params, CFG), t_ids, t_mask, CFG).numpy()
    assert out.shape == floats.shape
    assert np.abs(out - floats).max() < 0.15 * max(1.0, np.abs(floats).max())
    assert np.mean(np.argmax(out, -1) == np.argmax(floats, -1)) >= 0.75
    ref = np.asarray(ref_quant.quantized_forward(ref_quant.quantize_params(ref_tree, REF_TINY),
                                                 jnp.asarray(ids), jnp.asarray(mask), REF_TINY))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_int8_packed_forward_equals_the_reference(weights):
    from svoc_tpu.models.packing import pack_tokens as ref_pack_tokens

    ref_tree, params = weights
    ids, mask = _inputs(2)
    lists = [row[m > 0].tolist() for row, m in zip(ids, mask)]
    batch, _n = ref_pack_tokens(lists, 32, 4, CFG.pad_id)
    ref = np.asarray(ref_quant.quantized_packed_forward(
        ref_quant.quantize_params(ref_tree, REF_TINY), jnp.asarray(batch.ids), jnp.asarray(batch.pos),
        jnp.asarray(batch.seg), jnp.asarray(batch.cls_pos), REF_TINY))
    t = [torch.from_numpy(np.asarray(a)).long() for a in (batch.ids, batch.pos, batch.seg, batch.cls_pos)]
    out = quant.quantized_packed_forward(quant.quantize_params(params, CFG), *t, CFG).numpy()
    valid = np.asarray(batch.seg_valid) > 0
    np.testing.assert_allclose(out[valid], ref[valid], rtol=0, atol=1e-5)
    with torch.no_grad():
        floats = load_encoder(PackedSentimentEncoder, CFG, params)(*t).numpy()
    assert np.abs(out[valid] - floats[valid]).max() < 0.15 * max(1.0, np.abs(floats[valid]).max())


def test_qkv_share_one_activation_quantization(weights, monkeypatch):
    """Four quantizations a layer (x for Q/K/V, the attention context,
    the post-LN x, the GELU output), not six."""
    _ref, params = weights
    calls = []
    real = quant._quantize_rows
    monkeypatch.setattr(quant, "_quantize_rows", lambda x: calls.append(x.shape) or real(x))
    ids, mask = (torch.ones(2, 16, dtype=torch.long) for _ in range(2))
    quant.quantized_forward(quant.quantize_params(params, CFG), ids, mask, CFG)
    assert len(calls) == 4 * CFG.n_layers


# ---------------------------------------------------------------------------
# The pipeline, persistence and validation
# ---------------------------------------------------------------------------


def _pipe(**kw):
    kw.setdefault("seed", 5)
    return SentimentPipeline(cfg=CFG, seq_len=32, batch_size=4, device="cpu", **kw)


def test_int8_vectors_close_to_float_and_packed_close_to_unpacked():
    fp, qp = _pipe(), _pipe(quant="int8")
    ref, out = fp(TEXTS), qp(TEXTS)
    assert out.shape == ref.shape == (len(TEXTS), 6)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
    assert np.abs(out - ref).max() < 0.05
    np.testing.assert_allclose(qp.call_packed(TEXTS, max_segments=4), out, atol=0.05)


def test_quantized_tree_roundtrips_npz_and_serves(tmp_path, weights):
    _ref, params = weights
    q = quant.quantize_params(params, CFG)
    loaded = params_from_flax(load_params(save_params(str(tmp_path / "int8_tree"), q)))
    assert quant.is_quantized_tree(loaded)
    for key in q:
        assert loaded[key].dtype == q[key].dtype and torch.equal(loaded[key], q[key]), key
    fresh = _pipe(params=params, quant="int8")
    from_disk = _pipe(params=loaded, quant="int8")
    np.testing.assert_array_equal(fresh(TEXTS), from_disk(TEXTS))


def test_reference_validation_errors(weights):
    _ref, params = weights
    with pytest.raises(ValueError, match="dense"):
        SentimentPipeline(cfg=dataclasses.replace(CFG, attention="flash"), seq_len=32, batch_size=4,
                          quant="int8", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        _pipe(quant="int4")
    with pytest.raises(ValueError, match="pre-quantized"):
        _pipe(params=quant.quantize_params(params, CFG))
    with pytest.raises(ValueError, match="params_dtype"):
        _pipe(quant="int8", params_dtype=torch.bfloat16)


def test_flagship_int8_is_the_packed_variant_folded_from_float32():
    from svoc_torch.flagship import FlagshipStep

    step = FlagshipStep(TINY_TEST, variant="packed", rows=4, seq=32, max_seg=4, n_oracles=16,
                        window_size=8, quant="int8", device="cpu")
    assert step.quant == "int8" and isinstance(step.pipe.packed_model, quant.QuantizedPackedSentimentEncoder)
    assert step.pipe.packed_model.qparams["tok_emb.weight"].dtype == torch.float32
    with pytest.raises(ValueError, match="dense"):
        FlagshipStep(TINY_TEST, variant="packed_flash", rows=4, seq=32, quant="int8", device="cpu")
