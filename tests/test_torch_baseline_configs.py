"""BASELINE configs 1-4 (``svoc_torch.tools.baseline_configs``) against the
JAX package, on the CPU, at ``bench.py``'s ``small`` sizes.

Each config runs two ways on the same seeded inputs: through the JAX
body, composed from ``svoc_tpu`` functions as ``bench.py::bench_config1``-
``bench_config4`` compose it (a chunk's ``lax.scan`` returns every update
here instead of a checksum), and through the port's function on the CPU,
with the flax weights carried across by ``params_from_flax``.  Bars:
vectors within 1e-4 (``test_torch_encoder.py``), the Beta fleets within
1e-6 (``test_torch_generators.py``), the consensus within the
reference's bars (the reliable mask exact; essences and reliabilities
1e-5; skewness 1e-4; kurtosis 1e-3), detected counts and honest masks
exact.  Config 1 also runs at a narrow DistilBERT-SST2 shape in float32,
which keeps ``pad_id`` 0, ``ln_eps`` 1e-12 and the softmax head.  The
kernels cannot run here: ``chip_smoke.py`` phase 20 holds each against
its plain version on the card.
"""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from svoc_tpu.consensus.kernel import ConsensusConfig as JaxConsensusConfig  # noqa: E402
from svoc_tpu.consensus.kernel import consensus_step as jax_consensus_step  # noqa: E402
from svoc_tpu.io.scraper import SyntheticSource as JaxSource  # noqa: E402
from svoc_tpu.models import configs as jax_configs  # noqa: E402
from svoc_tpu.models.sentiment import SentimentPipeline as JaxPipeline  # noqa: E402
from svoc_tpu.sim.generators import generate_beta_oracles as jax_beta_oracles  # noqa: E402
from svoc_tpu.sim.oracle import gen_oracle_predictions as jax_gen_oracle_predictions  # noqa: E402

from svoc_torch.models import configs  # noqa: E402
from svoc_torch.models.encoder import init_params  # noqa: E402
from svoc_torch.models.from_jax import params_from_flax  # noqa: E402
from svoc_torch.sim import prng  # noqa: E402
from svoc_torch.tools import baseline_configs as bc  # noqa: E402

VEC_TOL, BETA_TOL = 1e-4, 1e-6
CONSENSUS_BARS = {"essence": 1e-5, "essence_first_pass": 1e-5, "reliability_first_pass": 1e-5,
                  "reliability_second_pass": 1e-5, "skewness": 1e-4, "kurtosis": 1e-3}
NARROW = dict(n_layers=1, hidden=64, n_heads=4, intermediate=64, vocab_size=512)


def assert_consensus(got, ref):
    assert np.array_equal(got.reliable.numpy(), np.asarray(ref.reliable))
    for name, bar in CONSENSUS_BARS.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=0, atol=bar,
                                   err_msg=name)


def jax_config1(cfg, seq):
    """``bench_config1``'s pipeline, inputs and ``classify_and_predict``."""
    pipe = JaxPipeline(cfg=cfg, seq_len=seq, batch_size=100, tokenizer_name=None, label_indices=(0, 1))
    ids, mask = pipe.tokenizer(JaxSource(batch=100, seed=0)(), seq)
    forward = pipe.forward_fn()

    @jax.jit
    def classify_and_predict(ids, mask):
        vecs = forward(pipe.params, ids, mask)
        return vecs, jnp.mean(vecs, axis=0)

    return pipe, ids, mask, classify_and_predict(jnp.asarray(ids), jnp.asarray(mask))


@pytest.mark.parametrize("shape", ["tiny", "narrow_distilbert"])
def test_config1_matches_the_reference(shape):
    if shape == "tiny":
        jax_cfg, cfg, seq, small = jax_configs.TINY_TEST, None, bc.CONFIG1_SMALL_SEQ, True
    else:
        jax_cfg = dataclasses.replace(jax_configs.DISTILBERT_SST2, dtype=jnp.float32, **NARROW)
        cfg = dataclasses.replace(configs.DISTILBERT_SST2, dtype=torch.float32, **NARROW)
        seq, small = bc.CONFIG1_SEQ, False
        assert (cfg.pad_id, cfg.ln_eps, cfg.head, cfg.n_labels) == (0, 1e-12, "softmax", 2)
    jpipe, jids, jmask, (jvecs, jpred) = jax_config1(jax_cfg, seq)
    pipe = bc.config1_pipeline(small, "cpu", params=params_from_flax(jpipe.params), cfg=cfg)
    ids, mask = bc.comment_batch(pipe, bc.CONFIG1_COMMENTS)
    assert np.array_equal(ids.numpy(), jids) and np.array_equal(mask.numpy(), jmask)
    if shape == "narrow_distilbert":  # pad 0 fills the rows' tails; the position ids start at 1
        assert (ids.numpy()[mask.numpy() == 0] == 0).all() and mask.sum(1).max() > 32
    vecs, pred = bc.config1_step(pipe, ids, mask)
    assert vecs.shape == (100, 2) and pred.shape == (2,)
    np.testing.assert_allclose(vecs.numpy(), np.asarray(jvecs), rtol=0, atol=VEC_TOL)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=0, atol=VEC_TOL)
    np.testing.assert_allclose(vecs.sum(1).numpy(), 1.0, rtol=0, atol=1e-6)


def jax_chunk(update, key, chunk):
    """``run_chunk``'s scan over ``fold_in(key, i)``, every update kept."""
    return jax.lax.scan(lambda c, i: (c, update(jax.random.fold_in(key, i))), None, jnp.arange(chunk))[1]


def test_config2_matches_the_reference():
    ccfg = JaxConsensusConfig(n_failing=2, constrained=True)

    def one_update(key):
        values, honest = jax_beta_oracles(key, 8, 2, a=10.0, b=10.0, dim=6)
        out = jax_consensus_step(values, ccfg)
        return values, honest, out, jnp.sum(jnp.logical_and(~out.reliable, ~honest))

    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    values, honest, out, detected = jax.jit(lambda k: jax_chunk(one_update, k, bc.CONFIG2_SMALL_CHUNK))(key)
    got = bc.config2_chunk(prng.fold_in(prng.PRNGKey(0, "cpu"), 3), bc.CONFIG2_SMALL_CHUNK)
    assert got.values.shape == (bc.CONFIG2_SMALL_CHUNK, 8, 6)
    assert np.array_equal(got.honest.numpy(), np.asarray(honest))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(values), rtol=0, atol=BETA_TOL)
    assert_consensus(got.out, out)
    assert np.array_equal(got.detected.numpy(), np.asarray(detected))


def test_config3_matches_the_reference():
    ccfg = JaxConsensusConfig(n_failing=8, constrained=True)
    batch, seq = bc.CONFIG3_SMALL_BATCH, bc.CONFIG3_SMALL_SEQ
    jpipe = JaxPipeline(cfg=jax_configs.TINY_TEST, seq_len=seq, batch_size=batch, tokenizer_name=None)
    forward = jpipe.forward_fn()
    jids, jmask = jpipe.tokenizer(JaxSource(batch=batch, seed=0)(), seq)

    @jax.jit
    def step(key, ids, mask):
        vecs = forward(jpipe.params, ids, mask)
        window = vecs[: min(50, batch), :2]
        values, honest = jax_gen_oracle_predictions(key, window, 64, 8, subset_size=10)
        return window, values, honest, jax_consensus_step(values, ccfg)

    pipe = bc.config3_pipeline(True, "cpu", params=params_from_flax(jpipe.params))
    ids, mask = bc.comment_batch(pipe, batch)
    essences = set()
    jkey, key = jax.random.PRNGKey(0), prng.PRNGKey(0, "cpu")
    for s in range(2):
        jkey, key = jax.random.fold_in(jkey, s), prng.fold_in(key, s)
        jwindow, jvalues, jhonest, jout = step(jkey, jnp.asarray(jids), jnp.asarray(jmask))
        out, honest, window = bc.config3_step(pipe, key, ids, mask)
        assert window.shape == (32, 2)
        np.testing.assert_allclose(window.numpy(), np.asarray(jwindow), rtol=0, atol=VEC_TOL)
        assert np.array_equal(honest.numpy(), np.asarray(jhonest))
        assert_consensus(out, jout)
        essences.add(tuple(out.essence.tolist()))
    assert len(essences) == 2


def test_config4_matches_the_reference():
    n, chunk = bc.CONFIG4_SMALL_ORACLES, bc.CONFIG4_SMALL_CHUNK
    ccfg = JaxConsensusConfig(n_failing=n // 4, constrained=True)
    jwindow = jax.random.uniform(jax.random.PRNGKey(1), (50, 6)) / 6
    window = bc.config4_window("cpu")
    assert np.array_equal(window.numpy(), np.asarray(jwindow))

    def one_step(key):
        values, honest = jax_gen_oracle_predictions(key, jwindow, n, n // 4, subset_size=10)
        out = jax_consensus_step(values, ccfg)
        return values, honest, out, jnp.sum(jnp.logical_and(~out.reliable, ~honest))

    values, honest, out, hits = jax.jit(lambda k: jax_chunk(one_step, k, chunk))(jax.random.PRNGKey(0))
    got = bc.config4_chunk(prng.PRNGKey(0, "cpu"), window, chunk, n)
    assert got.values.shape == (chunk, n, 6)
    assert np.array_equal(got.honest.numpy(), np.asarray(honest))
    assert np.array_equal(got.values.numpy(), np.asarray(values))
    assert_consensus(got.out, out)
    assert np.array_equal(got.detected.numpy(), np.asarray(hits))


@pytest.mark.parametrize("config", [1, 2, 3, 4])
def test_the_cli_prints_bench_metric_and_unit(config, capsys):
    assert bc.main(["--config", str(config), "--small", "--device", "cpu", "--seconds", "0"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    metric, unit = bc.METRICS[config]
    if config == 4:
        metric = metric.format(n=128, f=32)
    assert report["metric"] == metric and report["unit"] == unit
    assert report["value"] > 0 and "vs_baseline" not in report
    assert report["detail"]["device"] == "cpu"
    detail = report["detail"]
    # One step (chunk) timed, after a warm-up and three for the latency:
    # chip_smoke.py phase 20 reads a kernel's launches off these calls.
    timed = detail["steps"] // detail["chunk"] if config in (2, 4) else detail["steps"]
    assert timed == 1 and detail["calls"] == 1 + 3 + timed
    if config in (2, 4):
        assert 0 < detail["mean_failing_detected"] <= detail["n_failing"]


@pytest.mark.parametrize("config", [1, 3])
def test_run_hands_its_weights_to_the_pipeline(config, monkeypatch):
    name = f"config{config}_pipeline"
    real, seen = getattr(bc, name), []

    def spy(small, device, params):
        seen.append(params)
        return real(small, device, params)

    monkeypatch.setattr(bc, name, spy)
    folds, fold_in = [], bc.prng.fold_in
    monkeypatch.setattr(bc.prng, "fold_in", lambda key, i: folds.append(i) or fold_in(key, i))
    params = init_params(configs.TINY_TEST, 7, "cpu")
    report = bc.run(config, small=True, device="cpu", seconds=0, params=params)
    assert seen == [params] and report["value"] > 0
    assert bool(folds) == (config == 3)  # config 1 draws no key: no threefry launch on the card


def test_device_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bc.config1_pipeline(), lambda: bc.config3_pipeline(), lambda: bc.config4_window(),
                 lambda: bc.run(2, small=True), lambda: bc.main(["--config", "4", "--small"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
