"""The port's encoder and host feed against the JAX package's, on the CPU.

TINY_TEST weights come from the flax init and are carried across by
``svoc_torch.models.from_jax.params_from_flax``.  Packed logits and
tracked vectors of ``PackedSentimentEncoder`` with ``attention="flash"``
on both sides (flax's Pallas kernel in interpret mode, the port's flash
kernel's plain version) and the unpacked ``SentimentEncoder`` under its
per-key-mask flash route (against flax's dense attention) are compared
in float32 within 1e-4 absolute (two post-LN layers of float32 matmuls
summed in another order).  The dense configuration has its own file,
``test_torch_dense.py``.  The
hashing tokenizer, the packer and the synthetic source must give
identical arrays and texts for the same seed.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.io.scraper import SyntheticSource as JaxSource
from svoc_tpu.models import configs as jax_configs
from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder
from svoc_tpu.models.encoder import init_params as jax_init_params
from svoc_tpu.models.packing import PackedSentimentEncoder as JaxPacked
from svoc_tpu.models.packing import pack_tokens as jax_pack_tokens
from svoc_tpu.models.packing import strip_padding as jax_strip_padding
from svoc_tpu.models.sentiment import TRACKED_INDICES as JAX_TRACKED
from svoc_tpu.models.sentiment import scores_to_vectors as jax_scores_to_vectors
from svoc_tpu.models.tokenizer import HashingTokenizer as JaxTokenizer

from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import TINY_TEST

FLASH = dataclasses.replace(TINY_TEST, attention="flash")
from svoc_torch.models.encoder import SentimentEncoder, init_params, load_encoder
from svoc_torch.models.from_jax import params_from_flax
from svoc_torch.models.packing import PackedSentimentEncoder, pack_tokens, strip_padding
from svoc_torch.models.sentiment import TRACKED_INDICES, SentimentPipeline, scores_to_vectors
from svoc_torch.models.tokenizer import HashingTokenizer

SEQ, MAX_SEG = 32, 4
TOL = 1e-4


@pytest.fixture(scope="module")
def flax_params():
    return jax_init_params(JaxEncoder(jax_configs.TINY_TEST), seed=0)


@pytest.fixture(scope="module")
def packed():
    tok = HashingTokenizer(TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=SEQ)
    texts = SyntheticSource(batch=24, seed=3)()
    batch, n = pack_tokens(strip_padding(*tok(texts, SEQ)), SEQ, MAX_SEG, tok.pad_id)
    assert n == len(texts)
    return batch


def test_params_from_flax_fills_every_tensor(flax_params):
    state = params_from_flax(flax_params)
    model = load_encoder(SentimentEncoder, TINY_TEST, state)
    assert set(state) == set(model.state_dict())
    q = flax_params["params"]["block_0"]["attention"]["query"]["kernel"]
    np.testing.assert_array_equal(
        model.block_0.attention.query.weight.detach().numpy(), np.asarray(q).T
    )


def test_init_params_is_seeded_and_complete():
    a = init_params(TINY_TEST, seed=5, device="cpu")
    b = init_params(TINY_TEST, seed=5, device="cpu")
    c = init_params(TINY_TEST, seed=6, device="cpu")
    with torch.device("meta"):
        names = set(SentimentEncoder(TINY_TEST).state_dict())
    assert set(a) == names
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["block_0.ffn_in.weight"], c["block_0.ffn_in.weight"])


def test_meta_construction_runs_no_initialiser():
    """``init_params`` and ``load_encoder`` build their module on the meta
    device without ``torch.nn.init``'s initialisers, whose meta versions
    import ``torch._dynamo`` (seconds in a fresh process); the weights are
    the seeded draws all the same."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, torch\n"
        "from svoc_torch.models.configs import TINY_TEST\n"
        "from svoc_torch.models.encoder import SentimentEncoder, init_params, load_encoder, meta_module\n"
        "from svoc_torch.models.packing import PackedSentimentEncoder\n"
        "params = init_params(TINY_TEST, seed=5, device='cpu')\n"
        "model = load_encoder(PackedSentimentEncoder, TINY_TEST, params)\n"
        "assert all(t.is_meta for t in meta_module(SentimentEncoder, TINY_TEST).state_dict().values())\n"
        "assert model.block_0.ffn_in.weight.data_ptr() == params['block_0.ffn_in.weight'].data_ptr()\n"
        "assert 'torch._dynamo' not in sys.modules, 'torch._dynamo imported'\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent, check=True,
                   timeout=120)
    with torch.device("meta"):  # the default initialisers: the same names and shapes
        names = {k: v.shape for k, v in SentimentEncoder(TINY_TEST).state_dict().items()}
    a = init_params(TINY_TEST, seed=5, device="cpu")
    assert {k: v.shape for k, v in a.items()} == names


def test_packed_flash_logits_and_vectors_match_flax(flax_params, packed):
    jcfg = dataclasses.replace(jax_configs.TINY_TEST, attention="flash")
    arrays = (packed.ids, packed.pos, packed.seg, packed.cls_pos)
    ref = np.asarray(JaxPacked(jcfg).apply(flax_params, *map(jnp.asarray, arrays)))

    pipe = SentimentPipeline(
        FLASH, seq_len=SEQ, params=params_from_flax(flax_params), device="cpu",
    )
    with torch.inference_mode():
        logits = pipe.packed_model(*(torch.from_numpy(a) for a in arrays)).numpy()
    valid = packed.seg_valid > 0
    np.testing.assert_allclose(logits[valid], ref[valid], atol=TOL)

    r, s, n_labels = ref.shape
    ref_vecs = np.asarray(jax_scores_to_vectors(jnp.asarray(ref.reshape(r * s, n_labels))))
    vecs = pipe.packed_forward(*(torch.from_numpy(a) for a in arrays)).numpy()
    np.testing.assert_allclose(vecs.reshape(r * s, -1)[valid.reshape(-1)],
                               ref_vecs[valid.reshape(-1)], atol=TOL)


def test_unpacked_dense_logits_match_flax(flax_params):
    """The port's per-key-mask flash route against flax's dense
    attention (every query sees at least its BOS key, so the two agree)."""
    tok = HashingTokenizer(TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=SEQ)
    ids, mask = tok(SyntheticSource(batch=5, seed=9)(), SEQ)
    assert (mask == 0).any()  # the key mask is exercised
    ref = np.asarray(
        JaxEncoder(jax_configs.TINY_TEST).apply(flax_params, jnp.asarray(ids), jnp.asarray(mask))
    )
    model = load_encoder(SentimentEncoder, FLASH, params_from_flax(flax_params))
    with torch.inference_mode():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL)


def test_scores_to_vectors_matches():
    logits = np.random.default_rng(0).standard_normal((9, 28)).astype(np.float32)
    assert TRACKED_INDICES == JAX_TRACKED
    np.testing.assert_allclose(
        scores_to_vectors(torch.from_numpy(logits)).numpy(),
        np.asarray(jax_scores_to_vectors(jnp.asarray(logits))),
        atol=1e-6,
    )


@pytest.mark.parametrize("seed", [0, 11])
def test_host_feed_is_identical(seed):
    texts = SyntheticSource(batch=40, seed=seed)()
    assert texts == JaxSource(batch=40, seed=seed)()
    ours, ref = (
        cls(TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=SEQ)(texts, SEQ)
        for cls in (HashingTokenizer, JaxTokenizer)
    )
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    lists = strip_padding(*ours)
    for rows in (None, 3):
        got, n = pack_tokens(lists, SEQ, MAX_SEG, TINY_TEST.pad_id, rows=rows)
        want, m = jax_pack_tokens(jax_strip_padding(*ref), SEQ, MAX_SEG, TINY_TEST.pad_id, rows=rows)
        assert n == m
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
