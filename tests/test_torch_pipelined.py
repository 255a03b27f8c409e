"""The pipelined flagship step against the unpipelined one and against
the JAX package's bench body, on the CPU.

- ``FlagshipStep.pipelined`` over a key chain, then ``drain``, gives
  ``__call__``'s outputs one step later, key for key, bit for bit.
- Over three steps keyed ``fold_in(key, step)`` from ``PRNGKey(0)``, the
  pipelined outputs meet the reference's own body
  (``first_valid_window`` → ``gen_oracle_predictions`` →
  ``fused_consensus(interpret=True)``, ``bench.py:1916-1935``), with
  flax's TINY_TEST weights carried across by ``params_from_flax``: the
  honest and reliable masks exact, the essences and reliabilities within
  1e-5 (the bars of ``tests/test_torch_slice.py``).
- ``window_source`` yields the reference's windows over one store's
  contents.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.consensus.kernel import ConsensusConfig as JaxConfig
from svoc_tpu.io.comment_store import CommentStore as JaxCommentStore
from svoc_tpu.io.pipeline import window_source as jax_window_source
from svoc_tpu.models import configs as jax_configs
from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder
from svoc_tpu.models.encoder import init_params as jax_init_params
from svoc_tpu.models.packing import PackedSentimentEncoder as JaxPacked
from svoc_tpu.models.sentiment import scores_to_vectors as jax_scores_to_vectors
from svoc_tpu.ops.pallas_consensus import fused_consensus as jax_fused
from svoc_tpu.ops.select import first_valid_window as jax_first_valid_window
from svoc_tpu.sim.oracle import gen_oracle_predictions as jax_gen_oracle_predictions

from svoc_torch.flagship import FlagshipStep
from svoc_torch.io.comment_store import CommentStore
from svoc_torch.io.pipeline import window_source
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import TINY_TEST
from svoc_torch.models.from_jax import params_from_flax
from svoc_torch.models.packing import pack_tokens, strip_padding
from svoc_torch.sim import prng

ROWS, SEQ, MAX_SEG, ORACLES, SUBSET = 8, 32, 4, 32, 4
FIELDS = ("essence", "essence_first_pass", "reliability_first_pass", "reliability_second_pass")


@pytest.fixture(scope="module")
def flax_params():
    return jax_init_params(JaxEncoder(jax_configs.TINY_TEST), seed=3)


@pytest.fixture(scope="module")
def step(flax_params):
    return FlagshipStep(TINY_TEST, rows=ROWS, seq=SEQ, max_seg=MAX_SEG, n_oracles=ORACLES,
                        subset_size=SUBSET, params=params_from_flax(flax_params),
                        params_dtype=None, device="cpu")


def _batches(step, n):
    """``n`` packed batches of distinct seeded comments."""
    tok = step.pipe.tokenizer
    out = []
    for seed in range(n):
        ids, mask = tok(SyntheticSource(batch=ROWS * MAX_SEG, seed=10 + seed)(), SEQ)
        batch, _ = pack_tokens(strip_padding(ids, mask), SEQ, MAX_SEG, tok.pad_id, rows=ROWS)
        out.append(batch)
    return out


def _keys(n):
    """The reference's chain: PRNGKey(0), then key = fold_in(key, step)."""
    key, keys = prng.PRNGKey(0, "cpu"), []
    for i in range(n):
        key = prng.fold_in(key, i)
        keys.append(key)
    return keys


def _run_pipelined(step, batches, keys):
    """A priming forward, one pipelined step a later batch, the drain:
    the outputs of every batch in order."""
    window, outputs = step.window(batches[0]), []
    for batch, key in zip(batches[1:], keys):
        window_next, out, honest = step.pipelined(batch, key, window)
        outputs.append((out, honest))
        window = window_next
    outputs.append(step.drain(keys[len(batches) - 1], window))
    return outputs


def test_pipelined_equals_the_unpipelined_step_one_step_later(step):
    batches, keys = _batches(step, 4), _keys(4)
    plain = [step(batch, key) for batch, key in zip(batches, keys)]
    piped = _run_pipelined(step, batches, keys)
    assert len(piped) == len(plain) == 4
    for (a, ha), (b, hb) in zip(piped, plain):
        assert torch.equal(ha, hb)
        for field, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), field
    # Distinct batches, distinct outputs: the pipeline is input-sensitive.
    assert len({tuple(out.essence.tolist()) for out, _ in piped}) == 4


def test_pipelined_meets_the_reference_body(step, flax_params):
    batches, keys = _batches(step, 3), _keys(3)
    piped = _run_pipelined(step, batches, keys)

    jcfg = dataclasses.replace(jax_configs.TINY_TEST, attention="flash")
    model = JaxPacked(jcfg)
    key = jax.random.PRNGKey(0)
    for i, batch in enumerate(batches):
        key = jax.random.fold_in(key, i)
        logits = model.apply(flax_params, *map(jnp.asarray, (batch.ids, batch.pos, batch.seg, batch.cls_pos)))
        vecs = jax_scores_to_vectors(logits.reshape(ROWS * MAX_SEG, -1))
        window = jax_first_valid_window(vecs, jnp.asarray(batch.seg_valid > 0).reshape(-1), ROWS)
        values, honest = jax_gen_oracle_predictions(key, window, ORACLES, step.ccfg.n_failing, SUBSET)
        ref = jax_fused(values, JaxConfig(n_failing=step.ccfg.n_failing), interpret=True)
        out, got_honest = piped[i]
        np.testing.assert_array_equal(got_honest.numpy(), np.asarray(honest))
        np.testing.assert_array_equal(out.reliable.numpy(), np.asarray(ref.reliable))
        for field in FIELDS:
            np.testing.assert_allclose(np.asarray(getattr(out, field)), np.asarray(getattr(ref, field)),
                                       atol=1e-5, err_msg=f"step {i}: {field}")


@pytest.mark.parametrize("window,limit,max_windows", [(5, 3, 6), (4, 4, None), (50, 30, 2)])
def test_window_source_equals_the_reference(window, limit, max_windows):
    comments = SyntheticSource(batch=13, seed=7)()
    ours, theirs = CommentStore(), JaxCommentStore()
    ours.save(comments)
    theirs.save(comments)
    if max_windows is None:
        got = [w for w, _ in zip(window_source(ours, window=window, limit=limit), range(9))]
        want = [w for w, _ in zip(jax_window_source(theirs, window=window, limit=limit), range(9))]
    else:
        got = list(window_source(ours, window=window, limit=limit, max_windows=max_windows))
        want = list(jax_window_source(theirs, window=window, limit=limit, max_windows=max_windows))
    assert got == want and len(got) == (max_windows or 9)
    assert list(window_source(CommentStore(), window=5, limit=3)) == []
