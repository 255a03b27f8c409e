"""The port's ``SentimentPipeline``, forward resolution and flagship
variants against the JAX package's, on the CPU.

TINY_TEST weights come from the flax init and are carried across by
``params_from_flax``; both pipelines run the hashing tokenizer
(``tokenizer_name=None`` in JAX) on the same ``SyntheticSource`` texts.
``__call__`` and ``call_packed`` must give ``[len(texts), M]`` float64
within 1e-5 of the JAX pipeline (float32 forwards summed in another
order, then a sigmoid and a normalisation that shrink the difference).
The three flagship variants must give the window the JAX forward gives
(1e-4 on vectors, as the slice test holds them) and agree with each
other, as ``tests/test_packing.py`` pins for the reference.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.models import configs as jax_configs
from svoc_tpu.models import forward as jax_forward
from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder
from svoc_tpu.models.encoder import init_params as jax_init_params
from svoc_tpu.models.sentiment import SentimentPipeline as JaxPipeline
from svoc_tpu.ops.select import first_valid_window as jax_first_valid_window

from svoc_torch.flagship import VARIANTS, FlagshipStep, TokenBatch, comment_stream
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import TINY_TEST
from svoc_torch.models.encoder import SentimentEncoder
from svoc_torch.models.forward import resolve_forward, validate_quant
from svoc_torch.models.from_jax import params_from_flax
from svoc_torch.models.packing import (
    PackedSentimentEncoder,
    pack_tokens,
    pack_tokens_auto,
    strip_padding,
)
from svoc_torch.models.sentiment import SentimentPipeline
from svoc_torch.sim.prng import PRNGKey

SEQ, BATCH = 32, 4


@pytest.fixture(scope="module")
def flax_params():
    return jax_init_params(JaxEncoder(jax_configs.TINY_TEST), seed=2)


@pytest.fixture(scope="module")
def texts():
    return SyntheticSource(batch=10, seed=4)()  # 10 = 2 full chunks of 4 and a chunk of 2


def _pipes(flax_params, attention, **kw):
    jcfg = dataclasses.replace(jax_configs.TINY_TEST, attention=attention)
    ref = JaxPipeline(cfg=jcfg, seq_len=SEQ, batch_size=BATCH, tokenizer_name=None,
                      params=flax_params, **kw)
    pipe = SentimentPipeline(dataclasses.replace(TINY_TEST, attention=attention), seq_len=SEQ,
                             batch_size=BATCH, params=params_from_flax(flax_params),
                             device="cpu", **kw)
    return pipe, ref


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_pipeline_call_matches_jax(flax_params, texts, attention, packed):
    pipe, ref = _pipes(flax_params, attention, packed=packed, max_segments=3)
    want = ref(texts)
    got = pipe(texts)
    assert got.dtype == np.float64 and got.shape == want.shape == (len(texts), 6)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


def test_call_packed_matches_jax_and_the_unpacked_call(flax_params, texts):
    pipe, ref = _pipes(flax_params, "dense")
    want = ref.call_packed(texts, max_segments=4)
    got = pipe.call_packed(texts, max_segments=4)
    assert got.dtype == np.float64 and got.shape == (len(texts), 6)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, pipe(texts), atol=1e-5)
    # one text: a single row padded to batch_size by repeating it
    np.testing.assert_allclose(pipe.call_packed(texts[:1]), pipe(texts[:1]), atol=1e-5)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_pipeline_of_no_texts(flax_params, packed):
    pipe, ref = _pipes(flax_params, "dense", packed=packed)
    got = pipe([])
    assert got.shape == ref([]).shape == (0, 6) and got.dtype == np.float64


def test_one_state_dict_serves_both_modules(flax_params):
    pipe, _ = _pipes(flax_params, "dense")
    assert type(pipe.model) is SentimentEncoder and type(pipe.packed_model) is PackedSentimentEncoder
    a, b = pipe.model.state_dict(), pipe.packed_model.state_dict()
    assert set(a) == set(b) and all(a[k].data_ptr() == b[k].data_ptr() for k in a)
    assert pipe.forward_fn() == pipe.forward and pipe.packed_forward_fn() == pipe.packed_forward


def test_pipeline_validates_up_front():
    bad = dataclasses.replace(TINY_TEST, attention="ring")
    jbad = dataclasses.replace(jax_configs.TINY_TEST, attention="ring")
    with pytest.raises(ValueError, match="packed inference supports") as ours:
        SentimentPipeline(bad, packed=True, device="cpu")
    with pytest.raises(ValueError, match="packed inference supports") as theirs:
        JaxPipeline(cfg=jbad, packed=True, tokenizer_name=None)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="label_indices") as ours:
        SentimentPipeline(TINY_TEST, label_indices=(0, 28), device="cpu")
    with pytest.raises(ValueError, match="label_indices") as theirs:
        JaxPipeline(cfg=jax_configs.TINY_TEST, label_indices=(0, 28), tokenizer_name=None)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize(
    "attention,quant",
    [("dense", "int4"), ("flash", "int8")],
)
def test_validate_quant_raises_what_the_reference_raises(attention, quant):
    cfg = dataclasses.replace(TINY_TEST, attention=attention)
    jcfg = dataclasses.replace(jax_configs.TINY_TEST, attention=attention)
    with pytest.raises(ValueError) as theirs:
        jax_forward.validate_quant(jcfg, quant)
    for fn in (validate_quant, resolve_forward):
        with pytest.raises(ValueError) as ours:
            fn(cfg, quant)
        assert str(ours.value) == str(theirs.value)


def test_resolve_forward():
    validate_quant(TINY_TEST, None)
    validate_quant(TINY_TEST, "int8")  # dense: valid
    assert resolve_forward(TINY_TEST) is SentimentEncoder
    assert resolve_forward(TINY_TEST, packed=True) is PackedSentimentEncoder
    from svoc_torch.models.quant import QuantizedPackedSentimentEncoder, QuantizedSentimentEncoder

    assert resolve_forward(TINY_TEST, "int8") is QuantizedSentimentEncoder
    assert resolve_forward(TINY_TEST, "int8", packed=True) is QuantizedPackedSentimentEncoder


def test_pack_tokens_auto_is_the_python_packer():
    from svoc_tpu.models.packing import pack_tokens_auto as jax_pack_tokens_auto

    lists = [[2, 5, 6, 3], [2, 7, 3], [2, 9, 9, 8, 3], [2, 3]]
    a, n = pack_tokens_auto(lists, 8, 2, 1)
    b, m = pack_tokens(lists, 8, 2, 1)
    c, k = jax_pack_tokens_auto(lists, 8, 2, 1)  # the reference's: native where it builds
    assert n == m == k == 4
    assert all(np.array_equal(x, y) and np.array_equal(x, z) for x, y, z in zip(a, b, c))


def test_flagship_variants_match_jax_and_each_other(flax_params):
    rows, max_seg = 8, 4
    texts = SyntheticSource(batch=rows, seed=6)()
    kw = dict(rows=rows, seq=SEQ, max_seg=max_seg, n_oracles=16, subset_size=4,
              params=params_from_flax(flax_params), params_dtype=None, device="cpu")
    steps = {v: FlagshipStep(TINY_TEST, variant=v, **kw) for v in VARIANTS}
    assert FlagshipStep(TINY_TEST, **kw).variant == "packed_flash"
    for variant, (attention, packed) in VARIANTS.items():
        assert steps[variant].pipe.cfg.attention == attention and steps[variant].packed == packed

    tok = steps["dense"].pipe.tokenizer
    ids, mask = tok(texts, SEQ)
    batch, n = pack_tokens(strip_padding(ids, mask), SEQ, max_seg, tok.pad_id, rows=rows)
    assert n == rows
    windows = {
        v: step.window(batch if step.packed else TokenBatch(ids, mask)).numpy()
        for v, step in steps.items()
    }

    # JAX: the unpacked dense forward, and the packed forward under each attention.
    ref = {}
    dense = JaxPipeline(cfg=jax_configs.TINY_TEST, seq_len=SEQ, batch_size=rows,
                        tokenizer_name=None, params=flax_params)
    ref["dense"] = np.asarray(dense.forward_fn()(flax_params, ids, mask))[:rows]
    valid = jnp.asarray(batch.seg_valid > 0).reshape(-1)
    for variant in ("packed", "packed_flash"):
        jcfg = dataclasses.replace(jax_configs.TINY_TEST, attention=VARIANTS[variant][0])
        pipe = JaxPipeline(cfg=jcfg, seq_len=SEQ, batch_size=rows, tokenizer_name=None,
                           params=flax_params)
        vecs = pipe.packed_forward_fn()(flax_params, batch.ids, batch.pos, batch.seg, batch.cls_pos)
        ref[variant] = np.asarray(jax_first_valid_window(vecs.reshape(-1, 6), valid, rows))
    for variant in VARIANTS:
        assert windows[variant].shape == (rows, 6)
        np.testing.assert_allclose(windows[variant], ref[variant], atol=1e-4, err_msg=variant)
        np.testing.assert_allclose(windows[variant], windows["dense"], atol=1e-4, err_msg=variant)

    # One consensus over the same window and draws, whatever the variant.
    draws = steps["dense"].draws(PRNGKey(0, "cpu"))
    outs = [step.consensus(torch.from_numpy(windows["dense"]), draws)[0] for step in steps.values()]
    assert all(torch.equal(o.essence, outs[0].essence) for o in outs)


def test_flagship_feeds_have_fixed_shapes(flax_params):
    kw = dict(rows=4, seq=16, max_seg=2, n_oracles=16, subset_size=2, params_dtype=None, device="cpu")
    dense = FlagshipStep(TINY_TEST, variant="dense", **kw)
    feed = dense.comments(SyntheticSource(batch=6, seed=0))
    (a, n_a), (b, n_b) = next(feed), next(feed)
    assert isinstance(a, TokenBatch) and a.ids.shape == a.mask.shape == (4, 16) and n_a == n_b == 4
    assert not np.array_equal(a.ids, b.ids)  # fresh comments in every batch
    source = SyntheticSource(batch=6, seed=0)
    texts = source() + source()
    want = dense.pipe.tokenizer(texts[:4], 16), dense.pipe.tokenizer(texts[4:8], 16)
    assert np.array_equal(a.ids, want[0][0]) and np.array_equal(b.ids, want[1][0])  # none dropped
    out, honest = dense(a, PRNGKey(0, "cpu"))
    assert out.essence.shape == (6,) and honest.shape == (16,)
    packed, n = next(FlagshipStep(TINY_TEST, variant="packed", **kw).comments(
        SyntheticSource(batch=6, seed=0)))
    assert packed.ids.shape == (4, 16) and n == int(packed.seg_valid.sum())
    assert next(comment_stream(dense.pipe.tokenizer, SyntheticSource(batch=6, seed=0), 4, 16))[1] == 4


def test_bad_flagship_variant_raises():
    with pytest.raises(ValueError, match="not in dense|packed|packed_flash"):
        FlagshipStep(TINY_TEST, variant="ring", device="cpu")
