"""The port's fine-tune twin against ``tools/finetune_demo.py``, on the CPU.

- :func:`make_dataset` gives the reference's texts and labels for the
  same seed, and :func:`macro_f1` its scores;
- the first five AdamW losses of the port's train step on the demo's
  batches, from TINY_TEST weights carried over from the flax init, within
  1e-4 of the reference's ``make_train_step`` (dense attention, the
  reference's TINY_TEST default), and those of the port's sharded step on
  the demo's ``data(4) × model(2)`` mesh within 1e-4 of the reference's
  ``make_sharded_train_step`` on its;
- a 12-step demo on the mesh whose loss falls, whose same-mesh replay
  gives the uninterrupted run's parameters exactly and whose
  changed-mesh restore gives the checkpointed ones exactly, with each
  attention;
- the report keeps the reference's keys, filled in, and ``--zero1``
  runs the same checks.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import optax
import torch

from svoc_tpu.models import configs as jax_configs
from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder
from svoc_tpu.models.encoder import init_params as jax_init_params
from svoc_tpu.models.sentiment import TRACKED_INDICES as REF_TRACKED
from svoc_tpu.models.tokenizer import load_tokenizer as ref_load_tokenizer
from svoc_tpu.train import trainer as jt

from svoc_torch.models.configs import TINY_TEST
from svoc_torch.models.encoder import SentimentEncoder
from svoc_torch.models.from_jax import params_from_flax
from svoc_torch.models.sentiment import TRACKED_INDICES
from svoc_torch.models.tokenizer import load_tokenizer
from svoc_torch.tools import finetune_demo as demo
from svoc_torch.train.trainer import Batch, adamw, init_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref_demo():
    spec = importlib.util.spec_from_file_location("ref_finetune_demo", os.path.join(REPO, "tools",
                                                                                   "finetune_demo.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", [0, 1])
def test_dataset_is_the_references(ref_demo, seed):
    assert TRACKED_INDICES == REF_TRACKED
    assert demo.FAMILIES == ref_demo.FAMILIES and demo.FILLER == ref_demo.FILLER
    texts, labels = demo.make_dataset(np.random.default_rng(seed), 64, TRACKED_INDICES, 28)
    ref_texts, ref_labels = ref_demo.make_dataset(np.random.default_rng(seed), 64, REF_TRACKED, 28)
    assert texts == ref_texts and np.array_equal(labels, ref_labels) and labels.dtype == ref_labels.dtype
    ids, mask = load_tokenizer(TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=32)(texts, 32)
    ref_ids, ref_mask = ref_load_tokenizer(None, TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id,
                                           max_len=32)(ref_texts, 32)
    assert np.array_equal(ids, ref_ids) and np.array_equal(mask, ref_mask)


def test_macro_f1_is_the_references(ref_demo):
    rng = np.random.default_rng(4)
    truth = (rng.random((50, 6)) < 0.4).astype(np.float32)
    for flip in (0.0, 0.1, 0.5):
        pred = np.where(rng.random(truth.shape) < flip, 1 - truth, truth)
        assert demo.macro_f1(pred, truth) == ref_demo.macro_f1(pred, truth)
    assert demo.macro_f1(np.zeros((3, 2)), np.zeros((3, 2))) == ref_demo.macro_f1(
        np.zeros((3, 2)), np.zeros((3, 2))) == 0.0


def test_first_losses_match_the_reference(ref_demo):
    flax_params = jax_init_params(JaxEncoder(jax_configs.TINY_TEST), seed=0)
    tok = ref_load_tokenizer(None, TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=32)
    rng = np.random.default_rng(1)
    arrays = []
    for _ in range(5):
        texts, labels = ref_demo.make_dataset(rng, 32, REF_TRACKED, 28)
        ids, mask = tok(texts, 32)
        arrays.append((ids, mask, labels))
    jstep = jax.jit(jt.make_train_step(JaxEncoder(jax_configs.TINY_TEST), optax.adamw(3e-3)))
    jstate = jt.init_state(None, flax_params, optax.adamw(3e-3))
    with torch.device("meta"):
        model = SentimentEncoder(TINY_TEST)
    state = init_state(model, params_from_flax(flax_params), adamw(3e-3), device="cpu")
    step = make_train_step()
    for ids, mask, labels in arrays:
        jstate, jm = jstep(jstate, jt.Batch(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels)))
        state, m = step(state, Batch(*(torch.from_numpy(a) for a in (ids, mask, labels))))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), atol=1e-4, rtol=0)


def test_first_sharded_losses_match_the_references_mesh_trainer(ref_demo):
    """The twin's trainer: five AdamW steps of ``make_sharded_train_step``
    on 4x2 slots against the reference's on its 4x2 GSPMD mesh."""
    from svoc_tpu.parallel.mesh import MeshSpec as RefMeshSpec
    from svoc_tpu.parallel.mesh import make_mesh as ref_make_mesh

    from svoc_torch.parallel.mesh import MeshSpec, make_mesh
    from svoc_torch.train.trainer import make_sharded_train_step

    flax_params = jax_init_params(JaxEncoder(jax_configs.TINY_TEST), seed=0)
    tok = ref_load_tokenizer(None, TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=32)
    rng = np.random.default_rng(1)
    ref_mesh = ref_make_mesh(RefMeshSpec(("data", "model"), (4, 2)))
    jstep, jshard, _ = jt.make_sharded_train_step(JaxEncoder(jax_configs.TINY_TEST), optax.adamw(3e-3), ref_mesh,
                                                  params_template=flax_params)
    jstate = jshard(jt.init_state(None, flax_params, optax.adamw(3e-3)))
    params = params_from_flax(flax_params)
    step, shard_state, _ = make_sharded_train_step(
        TINY_TEST, make_mesh(MeshSpec(("data", "model"), (4, 2)), device="cpu"), params_template=params)
    with torch.device("meta"):
        model = SentimentEncoder(TINY_TEST)
    state = shard_state(init_state(model, params, adamw(3e-3), device="cpu"))
    for _ in range(5):
        texts, labels = ref_demo.make_dataset(rng, 32, REF_TRACKED, 28)
        ids, mask = tok(texts, 32)
        jstate, jm = jstep(jstate, jt.Batch(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels)))
        state, m = step(state, Batch(*(torch.from_numpy(a) for a in (ids, mask, labels))))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_twelve_step_demo_learns_and_replays_exactly(attention):
    report = demo.run(steps=12, device="cpu", attention=attention, target_f1=0.0)
    losses = report["loss_curve"]
    assert len(losses) == 12 and losses[-1] < losses[0] and report["losses_finite"]
    assert report["same_mesh_replay_max_abs_param_delta"] == 0.0
    assert report["changed_mesh_restore_max_abs_param_delta"] == 0.0
    assert len(report["changed_mesh_continued_losses"]) == 5
    assert report["attention"] == attention and report["device"] == "cpu" and report["ok"]


def test_report_keys_cli_and_the_parts_that_wait(tmp_path):
    """The report keeps the reference's keys, filled in; ``--zero1`` and
    the changed-mesh restore run (once they waited for the mesh trainer
    and raised) and report 0.0; without a card the default device
    raises."""
    out = tmp_path / "ft.json"
    ref_keys = json.load(open(os.path.join(REPO, "FINETUNE_r04.json"))).keys()
    for flags, zero1 in (([], False), (["--zero1"], True)):
        assert demo.main(["--steps", "4", "--device", "cpu", "--target-f1", "0", "--out", str(out)] + flags) == 0
        report = json.load(open(out))
        assert set(ref_keys) <= set(report)
        assert report["zero1_opt_sharding"] is zero1
        assert report["same_mesh_replay_max_abs_param_delta"] == 0.0
        assert report["changed_mesh_restore_max_abs_param_delta"] == 0.0
        assert len(report["changed_mesh_continued_losses"]) == 5 and report["ok"]
    with pytest.raises(SystemExit):
        demo.main(["--steps", "2", "--device", "cpu", "--changed-mesh", "--out", str(out)])
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.run(steps=2)
