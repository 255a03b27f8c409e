"""The port's HF RoBERTa converter against the JAX package's, on the CPU.

A state dict with HF's key names and a tiny RoBERTa shape, made in the
test from a seed, goes through the reference's
``convert_roberta_state_dict`` and flax encoder and through the port's
converter and encoder: float32 logits within 2e-5.  A params file that
either package writes loads into the other with the same logits; a local
checkpoint directory loads without ``transformers``; and, where
``transformers`` is installed, the port matches
``RobertaForSequenceClassification`` within the reference's 2e-4
(``tests/test_convert.py``).
"""

import dataclasses
import json
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.models import convert as ref_convert
from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder

from svoc_torch.models import convert
from svoc_torch.models.encoder import SentimentEncoder, load_encoder
from svoc_torch.models.from_jax import params_from_flax

HF = dict(vocab_size=256, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
          max_position_embeddings=34, pad_token_id=1, layer_norm_eps=1e-5)
N_LABELS = 5


def hf_state_dict(seed=0):
    """``RobertaForSequenceClassification``'s state dict at the tiny shape."""
    rng = np.random.default_rng(seed)
    h, inter = HF["hidden_size"], HF["intermediate_size"]

    def t(*shape, scale=0.2):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    sd = {
        "roberta.embeddings.word_embeddings.weight": t(HF["vocab_size"], h),
        "roberta.embeddings.position_embeddings.weight": t(HF["max_position_embeddings"], h),
        "roberta.embeddings.token_type_embeddings.weight": t(1, h),
        "roberta.embeddings.LayerNorm.weight": 1 + t(h, scale=0.05),
        "roberta.embeddings.LayerNorm.bias": t(h, scale=0.05),
        "classifier.dense.weight": t(h, h),
        "classifier.dense.bias": t(h, scale=0.05),
        "classifier.out_proj.weight": t(N_LABELS, h),
        "classifier.out_proj.bias": t(N_LABELS, scale=0.05),
    }
    for i in range(HF["num_hidden_layers"]):
        pre = f"roberta.encoder.layer.{i}."
        for name, (out, inp) in {"attention.self.query": (h, h), "attention.self.key": (h, h),
                                 "attention.self.value": (h, h), "attention.output.dense": (h, h),
                                 "intermediate.dense": (inter, h), "output.dense": (h, inter)}.items():
            sd[pre + name + ".weight"] = t(out, inp)
            sd[pre + name + ".bias"] = t(out, scale=0.05)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[pre + name + ".weight"] = 1 + t(h, scale=0.05)
            sd[pre + name + ".bias"] = t(h, scale=0.05)
    return sd


def hf_config():
    return {**HF, "id2label": {str(i): f"l{i}" for i in range(N_LABELS)}}


def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(4, HF["vocab_size"], size=(3, 16)).astype(np.int32)
    mask = np.zeros((3, 16), np.int32)
    for i, n in enumerate([16, 9, 5]):
        mask[i, :n] = 1
        ids[i, n:] = HF["pad_token_id"]
    return ids, mask


def port_logits(cfg, params):
    ids, mask = batch()
    model = load_encoder(SentimentEncoder, cfg, params)
    with torch.no_grad():
        return model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()


def jax_logits(cfg, params):
    ids, mask = batch()
    return np.asarray(JaxEncoder(cfg).apply(params, jnp.asarray(ids), jnp.asarray(mask)))


@pytest.fixture(scope="module")
def configs():
    ours = dataclasses.replace(convert.config_from_hf(hf_config()), dtype=torch.float32)
    ref = dataclasses.replace(ref_convert.config_from_hf(types.SimpleNamespace(**HF, num_labels=N_LABELS)),
                              dtype=jnp.float32)
    return ours, ref


def test_config_mapping_takes_a_mapping_or_an_object(configs):
    ours, ref = configs
    as_object = convert.config_from_hf(types.SimpleNamespace(**HF, num_labels=N_LABELS))
    assert dataclasses.replace(as_object, dtype=torch.float32) == ours
    for field in ("vocab_size", "hidden", "n_layers", "n_heads", "intermediate", "max_len", "n_labels",
                  "pad_id", "ln_eps", "head"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert (ours.max_len, ours.n_labels) == (32, 5)


def test_converted_logits_match_the_reference(configs):
    ours, ref = configs
    sd = hf_state_dict()
    params = convert.convert_roberta_state_dict(sd, ours)
    ref_params = ref_convert.convert_roberta_state_dict(sd, ref)
    np.testing.assert_allclose(port_logits(ours, params), jax_logits(ref, ref_params), atol=2e-5, rtol=0)
    # The token-type row is folded into the positions, as there.
    expected = sd["roberta.embeddings.position_embeddings.weight"] + sd[
        "roberta.embeddings.token_type_embeddings.weight"][0]
    assert torch.equal(params["pos_emb.weight"], expected)
    assert params["block_0.attention.query.weight"].shape == (32, 32)  # [out, in] kept


def test_params_files_cross_between_the_packages(configs, tmp_path):
    ours, ref = configs
    sd = hf_state_dict(seed=1)
    ref_params = ref_convert.convert_roberta_state_dict(sd, ref)
    ref_path = ref_convert.save_params(str(tmp_path / "ref"), ref_params)
    loaded = params_from_flax(convert.load_params(ref_path))
    np.testing.assert_allclose(port_logits(ours, loaded), jax_logits(ref, ref_params), atol=2e-5, rtol=0)
    ours_path = convert.save_params(str(tmp_path / "ours.npz"), convert.convert_roberta_state_dict(sd, ours))
    assert ours_path.endswith("ours.npz")
    back = ref_convert.load_params(ours_path)
    np.testing.assert_allclose(jax_logits(ref, back), jax_logits(ref, ref_params), atol=2e-5, rtol=0)
    tree = convert.load_params(ours_path)
    assert sorted(tree["params"]) == sorted(ref_params["params"])


def test_local_checkpoint_directory_and_cli(configs, tmp_path, capsys):
    ours, _ref = configs
    sd = hf_state_dict(seed=2)
    (tmp_path / "config.json").write_text(json.dumps(hf_config()))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    model, params = convert.load_hf_checkpoint(str(tmp_path))
    assert model.cfg.n_labels == N_LABELS and model.cfg.dtype == torch.bfloat16
    np.testing.assert_allclose(port_logits(ours, params),
                               port_logits(ours, convert.convert_roberta_state_dict(sd, ours)), atol=0, rtol=0)
    with pytest.raises(FileNotFoundError):
        convert.load_hf_checkpoint(str(tmp_path / "absent"))
    out = tmp_path / "params"
    assert convert.main([str(tmp_path), "-o", str(out)]) == 0
    assert "2L/32H, 5 labels" in capsys.readouterr().out
    assert set(params_from_flax(convert.load_params(str(out) + ".npz"))) == set(params)


def test_logit_parity_with_transformers(configs):
    transformers = pytest.importorskip("transformers")
    ours, _ref = configs
    config = transformers.RobertaConfig(**HF, num_labels=N_LABELS)
    torch.manual_seed(0)
    model = transformers.RobertaForSequenceClassification(config).eval()
    params = convert.convert_roberta_state_dict(model.state_dict(), ours)
    ids, mask = batch()
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids.astype(np.int64)),
                     attention_mask=torch.from_numpy(mask.astype(np.int64))).logits.numpy()
    np.testing.assert_allclose(port_logits(ours, params), want, atol=2e-4)
