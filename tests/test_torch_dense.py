"""The port's dense-attention configuration against the JAX package's,
on the CPU.

- ``dense_attention_reference`` against
  ``svoc_tpu.parallel.ring_attention.dense_attention_reference`` on the
  same numpy inputs: float32 within 2e-5, bf16 within 3e-2 (one bf16
  rounding of probabilities and output at a scale of a few units), with
  and without a key mask.
- ``SentimentEncoder`` and ``PackedSentimentEncoder`` with
  ``attention="dense"`` against flax with the same config on weights
  carried across by ``params_from_flax``: TINY_TEST in float32 within
  2e-5 on the logits, a bf16 copy of it within 3e-2; a row of one real
  token and a packed row with padding included.
- Dense against flash inside the port on the gathered logits (1e-4: the
  two sum the softmax in another order).
- Gradients of the dense encoder against ``jax.grad`` (1e-4), and
  ``remat=True`` against ``remat=False`` (1e-6) for both attentions.
- An unknown ``cfg.attention`` raises in both encoders.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.models import configs as jax_configs
from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder
from svoc_tpu.models.encoder import init_params as jax_init_params
from svoc_tpu.models.packing import PackedSentimentEncoder as JaxPacked
from svoc_tpu.parallel.ring_attention import dense_attention_reference as jax_dense_reference

from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import TINY_TEST
from svoc_torch.models.encoder import SentimentEncoder, load_encoder
from svoc_torch.models.from_jax import params_from_flax
from svoc_torch.models.packing import PackedSentimentEncoder, pack_tokens, strip_padding
from svoc_torch.models.tokenizer import HashingTokenizer
from svoc_torch.ops.dense_attention import (
    MASKED_BIAS,
    block_diagonal_bias,
    dense_attention,
    dense_attention_reference,
    key_padding_bias,
)

SEQ, MAX_SEG = 32, 4
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
#: logits bar per compute dtype
BARS = {"float32": 2e-5, "bfloat16": 3e-2}


def _cfgs(dtype: str, **kw):
    """The same TINY_TEST variant in both packages."""
    return (
        dataclasses.replace(TINY_TEST, dtype=TORCH_DTYPES[dtype], **kw),
        dataclasses.replace(jax_configs.TINY_TEST, dtype=JAX_DTYPES[dtype], **kw),
    )


@pytest.fixture(scope="module")
def flax_params():
    return jax_init_params(JaxEncoder(jax_configs.TINY_TEST), seed=0)


@pytest.fixture(scope="module")
def tokens():
    """Six comments, the last two a single word and the empty string (a
    row of BOS and EOS only), padded to SEQ."""
    tok = HashingTokenizer(TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=SEQ)
    texts = SyntheticSource(batch=4, seed=9)() + ["word", ""]
    ids, mask = tok(texts, SEQ)
    assert (mask == 0).any() and mask[-1].sum() == 2
    return ids, mask


@pytest.fixture(scope="module")
def packed(tokens):
    """The same comments packed, with explicit rows so that the last row
    is padding only and others end in padding."""
    batch, n = pack_tokens(strip_padding(*tokens), SEQ, MAX_SEG, TINY_TEST.pad_id, rows=5)
    assert n == 6 and (batch.seg == 0).any() and (batch.seg[-1] == 0).all()
    return batch


def _to_np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "kmask"])
def test_dense_reference_matches_jax(dtype, masked):
    rng = np.random.default_rng(3)
    b, t, h, d = 2, 24, 3, 16
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    kmask = (rng.uniform(size=(b, t)) > 0.3).astype(np.int32) if masked else None
    if masked:
        kmask[:, 0] = 1  # every query sees a key
    ref = jax_dense_reference(
        *(jnp.asarray(x).astype(JAX_DTYPES[dtype]) for x in (q, k, v)),
        None if kmask is None else jnp.asarray(kmask),
    )
    out = dense_attention_reference(
        *(torch.from_numpy(x).to(TORCH_DTYPES[dtype]) for x in (q, k, v)),
        None if kmask is None else torch.from_numpy(kmask),
    )
    assert out.dtype == TORCH_DTYPES[dtype] and out.shape == (b, t, h, d)
    np.testing.assert_allclose(_to_np(out), np.asarray(ref.astype(jnp.float32)), atol=BARS[dtype])


def test_additive_bias_averages_a_query_that_sees_no_key():
    """The encoder's dense form adds -1e9 in float32: a query whose every
    key is masked has all scores equal and averages v uniformly, with no
    NaN (a select of -inf would give NaN, the flash rule 0)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32)) for _ in range(3))
    seg = torch.tensor([[1, 1, 1, 2, 2, 0, 0, 0]], dtype=torch.int32)
    bias = block_diagonal_bias(seg)
    assert bias.shape == (1, 1, 8, 8) and bias.dtype == torch.float32
    assert bool((bias[0, 0, 5:] == MASKED_BIAS).all()) and bool((bias[0, 0, :3, :3] == 0).all())
    out = dense_attention(q, k, v, bias, torch.float32)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out[0, 5], v[0].mean(dim=0), atol=1e-6, rtol=0)
    kb = key_padding_bias(torch.tensor([[1, 1, 0]]))
    assert kb.shape == (1, 1, 1, 3) and kb.tolist() == [[[[0.0, 0.0, MASKED_BIAS]]]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_encoder_logits_match_flax(flax_params, tokens, dtype):
    cfg, jcfg = _cfgs(dtype, attention="dense")
    ids, mask = tokens
    ref = np.asarray(JaxEncoder(jcfg).apply(flax_params, jnp.asarray(ids), jnp.asarray(mask)))
    model = load_encoder(SentimentEncoder, cfg, params_from_flax(flax_params))
    with torch.inference_mode():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=BARS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_dense_encoder_logits_match_flax(flax_params, packed, dtype):
    cfg, jcfg = _cfgs(dtype, attention="dense")
    arrays = (packed.ids, packed.pos, packed.seg, packed.cls_pos)
    ref = np.asarray(JaxPacked(jcfg).apply(flax_params, *map(jnp.asarray, arrays)))
    model = load_encoder(PackedSentimentEncoder, cfg, params_from_flax(flax_params))
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in arrays)).numpy()
    assert np.isfinite(out).all()  # the padding-only row too: no NaN from its bias
    valid = packed.seg_valid > 0
    np.testing.assert_allclose(out[valid], ref[valid], atol=BARS[dtype])


def test_dense_and_flash_agree_inside_the_port(flax_params, tokens, packed):
    """Packed and unpacked, dense and flash: four forwards, one set of
    per-comment logits."""
    params = params_from_flax(flax_params)
    ids, mask = (torch.from_numpy(a) for a in tokens)
    arrays = [torch.from_numpy(a) for a in (packed.ids, packed.pos, packed.seg, packed.cls_pos)]
    valid = packed.seg_valid > 0
    per_comment = []
    with torch.inference_mode():
        for attention in ("dense", "flash"):
            cfg = dataclasses.replace(TINY_TEST, attention=attention)
            per_comment.append(load_encoder(SentimentEncoder, cfg, params)(ids, mask).numpy())
            logits = load_encoder(PackedSentimentEncoder, cfg, params)(*arrays).numpy()
            by_owner = np.zeros_like(per_comment[0])
            by_owner[packed.owner[valid]] = logits[valid]
            per_comment.append(by_owner)
    for other in per_comment[1:]:
        np.testing.assert_allclose(other, per_comment[0], atol=1e-4)


def _torch_grads(cfg, params, ids, mask):
    with torch.device("meta"):
        model = SentimentEncoder(cfg)
    model.load_state_dict({k: v.clone() for k, v in params.items()}, assign=True)
    model(torch.from_numpy(ids), torch.from_numpy(mask)).square().sum().backward()
    return {k: p.grad for k, p in model.named_parameters()}


def test_dense_encoder_gradients_match_jax(flax_params, tokens):
    ids, mask = tokens
    _, jcfg = _cfgs("float32", attention="dense")

    def loss(p):
        return jnp.sum(JaxEncoder(jcfg).apply(p, jnp.asarray(ids), jnp.asarray(mask)) ** 2)

    ref = params_from_flax(jax.grad(loss)(flax_params))
    got = _torch_grads(
        dataclasses.replace(TINY_TEST, attention="dense"), params_from_flax(flax_params), ids, mask
    )
    assert set(got) == set(ref)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_remat_gives_the_same_gradients(flax_params, tokens, attention):
    ids, mask = tokens
    params = params_from_flax(flax_params)
    plain, remat = (
        _torch_grads(dataclasses.replace(TINY_TEST, attention=attention, remat=flag), params, ids, mask)
        for flag in (False, True)
    )
    for name, g in plain.items():
        assert bool(g.abs().sum() > 0) or name.endswith("pos_emb.weight") or "bias" in name, name
        np.testing.assert_allclose(remat[name].numpy(), g.numpy(), atol=1e-6, err_msg=name)


def test_remat_reruns_each_block_once(flax_params, tokens, monkeypatch):
    """Under ``remat`` a backward runs every block's forward a second
    time; without grad nothing is rematerialized."""
    import svoc_torch.models.encoder as encoder_module

    calls = []
    real = encoder_module.dense_attention
    monkeypatch.setattr(encoder_module, "dense_attention",
                        lambda *a: (calls.append(1), real(*a))[1])
    ids, mask = tokens
    params = params_from_flax(flax_params)
    _torch_grads(dataclasses.replace(TINY_TEST, remat=True), params, ids, mask)
    assert len(calls) == 2 * TINY_TEST.n_layers
    calls.clear()
    model = load_encoder(SentimentEncoder, dataclasses.replace(TINY_TEST, remat=True), params)
    with torch.inference_mode():
        model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(calls) == TINY_TEST.n_layers


@pytest.mark.parametrize("cls", [SentimentEncoder, PackedSentimentEncoder], ids=["unpacked", "packed"])
def test_unknown_attention_raises(flax_params, tokens, packed, cls):
    model = load_encoder(cls, dataclasses.replace(TINY_TEST, attention="ring"),
                         params_from_flax(flax_params))
    if cls is SentimentEncoder:
        args = tokens
    else:
        args = (packed.ids, packed.pos, packed.seg, packed.cls_pos)
    with pytest.raises(ValueError, match="'dense' or 'flash'"):
        model(*(torch.from_numpy(a) for a in args))
