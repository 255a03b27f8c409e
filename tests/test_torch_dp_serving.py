"""The port's data-parallel serving steps against the JAX package's, on the CPU.

Twins of ``tests/test_serving.py``'s data-parallel tests: the same
seeded inputs (``TINY_TEST``, 16 rows of 16 tokens, a window of 8, 16
oracles, subsets of 4) go through :mod:`svoc_tpu.parallel.serving` on
its 8 simulated CPU devices and :mod:`svoc_torch.parallel.serving` on an
8-slot CPU mesh, with the port's weights converted from the reference's
(``params_from_flax``).  The packed steps run flash attention (the
reference's Pallas kernel in interpret mode; T = 16).  Also the
pipeline's ``data_mesh`` and the session's data-parallel vectorizer.

Bars: the honest and reliable masks exact; the consensus at
``tests/test_parallel.py``'s rtols (1e-5 on essences, reliabilities and
risks; 1e-4 on skewness and kurtosis) with an atol of 1e-4: the
forward's float32 rounding differs between the packages by up to 1e-4
(``tests/test_torch_encoder.py``'s bar), and the moments of the window
carry it.  ``tests/test_torch_sharded.py`` holds the consensus body
itself to those bars on identical inputs.  Between two port meshes and
between the port's plain and pipelined packed steps: bitwise where the
reference's own tests are, ``atol=1e-5`` on the essence where they are;
a row-split pipeline within 1e-6 of the unsplit one (the CPU's matrix
products block by the rows they are given, so the last bits move).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svoc_tpu.consensus.kernel import ConsensusConfig as RefConfig  # noqa: E402
from svoc_tpu.models import configs as ref_configs  # noqa: E402
from svoc_tpu.models.encoder import SentimentEncoder as RefEncoder  # noqa: E402
from svoc_tpu.models.encoder import init_params as ref_init_params  # noqa: E402
from svoc_tpu.models.packing import pack_tokens, strip_padding  # noqa: E402
from svoc_tpu.models.quant import quantize_params as ref_quantize  # noqa: E402
from svoc_tpu.models.tokenizer import load_tokenizer  # noqa: E402
from svoc_tpu.parallel import serving as ref_serving  # noqa: E402

from svoc_torch.consensus.kernel import ConsensusConfig  # noqa: E402
from svoc_torch.models.configs import TINY_TEST  # noqa: E402
from svoc_torch.models.from_jax import params_from_flax  # noqa: E402
from svoc_torch.models.quant import quantize_params  # noqa: E402
from svoc_torch.models.sentiment import SentimentPipeline  # noqa: E402
from svoc_torch.parallel import serving  # noqa: E402
from svoc_torch.sim import prng  # noqa: E402

LABEL_IDX = (0, 1, 2, 3, 4, 5)
WINDOW, SEQ, N_ORACLES, SUBSET = 8, 16, 16, 4
FLASH = dataclasses.replace(TINY_TEST, attention="flash")
REF_FLASH = dataclasses.replace(ref_configs.TINY_TEST, attention="flash")
CCFG, REF_CCFG = ConsensusConfig(n_failing=4), RefConfig(n_failing=4)
FLOAT_FIELDS = ("essence", "essence_first_pass", "reliability_first_pass", "reliability_second_pass",
                "quadratic_risk")


@pytest.fixture(scope="module")
def flax_params():
    return ref_init_params(RefEncoder(ref_configs.TINY_TEST), seed=0)


@pytest.fixture(scope="module")
def params(flax_params):
    return params_from_flax(flax_params)


def port_mesh(slots=8):
    return serving.serving_mesh(["cpu"] * slots)


#: The encoder's float32 bar between the packages (``test_torch_encoder.py``).
FORWARD_TOL = 1e-4


def assert_consensus_close(out, ref):
    """``tests/test_parallel.py``'s rtols, with the forward's atol."""
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(out, field).numpy(), np.asarray(getattr(ref, field)),
                                   rtol=1e-5, atol=FORWARD_TOL, err_msg=field)
    for field in ("skewness", "kurtosis"):
        np.testing.assert_allclose(getattr(out, field).numpy(), np.asarray(getattr(ref, field)),
                                   rtol=1e-4, atol=FORWARD_TOL, err_msg=field)
    assert np.array_equal(out.reliable.numpy(), np.asarray(ref.reliable))
    assert bool(out.interval_valid) == bool(ref.interval_valid)


def token_batch(seed=0, batch=16):
    rng = np.random.default_rng(seed)
    return rng.integers(2, 1000, (batch, SEQ)).astype(np.int32), np.ones((batch, SEQ), np.int32)


def texts_of(tag):
    """The reference test's 16 texts (``tag`` None) or its pipelined ones."""
    if tag is None:
        return [f"short comment number {i} about consensus" for i in range(16)]
    return [f"pipelined comment {tag}-{i} consensus" for i in range(16)]


def packed_batch(tag):
    tok = load_tokenizer(None, TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=SEQ)
    texts = texts_of(tag)
    batch, n = pack_tokens(strip_padding(*tok(texts, SEQ)), SEQ, max_segments=2, pad_id=TINY_TEST.pad_id,
                           rows=8)
    assert n == 16
    arrays = (batch.ids, batch.pos, batch.seg, batch.cls_pos, batch.seg_valid > 0)
    return [torch.from_numpy(np.asarray(a)) for a in arrays], [jnp.asarray(a) for a in arrays]


def ref_row_args(mesh, arrays):
    row = ref_serving.batch_sharding(mesh)
    return [jax.device_put(a, row) for a in arrays]


def test_dp_serving_equals_the_reference(flax_params, params):
    ids, mask = token_batch()
    serve = serving.dp_serving_step_fn(port_mesh(), TINY_TEST, CCFG, N_ORACLES, window_size=WINDOW,
                                       subset_size=SUBSET, label_indices=LABEL_IDX)
    with torch.inference_mode():
        out, honest = serve(params, prng.PRNGKey(7, "cpu"), torch.from_numpy(ids), torch.from_numpy(mask))
    mesh = ref_serving.serving_mesh()
    ref_out, ref_honest = ref_serving.dp_serving_step_fn(
        mesh, ref_configs.TINY_TEST, REF_CCFG, N_ORACLES, window_size=WINDOW, subset_size=SUBSET,
        label_indices=LABEL_IDX)(flax_params, jax.random.PRNGKey(7), *ref_row_args(mesh, (ids, mask)))
    assert np.array_equal(honest.numpy(), np.asarray(ref_honest))
    assert int((~honest).sum()) == CCFG.n_failing
    assert_consensus_close(out, ref_out)


@pytest.mark.parametrize("slots", [1, 2, 4])
def test_dp_serving_matches_the_eight_slot_mesh(params, slots):
    """The sharding must not change the math: a mesh of ``slots`` gives
    the eight-slot step's fleet bit for bit and its consensus within the
    reference test's bars (the psum adds in another grouping)."""
    ids, mask = (torch.from_numpy(a) for a in token_batch(1))
    key = prng.PRNGKey(7, "cpu")
    outs = []
    for mesh in (port_mesh(), port_mesh(slots)):
        serve = serving.dp_serving_step_fn(mesh, TINY_TEST, CCFG, N_ORACLES, window_size=WINDOW,
                                           subset_size=SUBSET, label_indices=LABEL_IDX)
        with torch.inference_mode():
            outs.append(serve(params, key, ids, mask))
    (out8, honest8), (out, honest) = outs
    assert torch.equal(honest8, honest) and torch.equal(out8.reliable, out.reliable)
    torch.testing.assert_close(out8.essence, out.essence, rtol=0, atol=1e-5)
    torch.testing.assert_close(out8.skewness, out.skewness, rtol=1e-4, atol=1e-5)


def test_dp_serving_rejects_what_the_reference_rejects(params):
    with pytest.raises(ValueError, match="not divisible"):
        serving.dp_serving_step_fn(port_mesh(), TINY_TEST, CCFG, 12, window_size=WINDOW)
    with pytest.raises(ValueError, match="int8"):
        serving.dp_serving_step_fn(port_mesh(), TINY_TEST, CCFG, N_ORACLES, quant="fp8")
    with pytest.raises(ValueError, match="out of range"):
        serving.dp_serving_step_fn(port_mesh(), TINY_TEST, CCFG, N_ORACLES, label_indices=(0, 40))
    serve = serving.dp_serving_step_fn(port_mesh(), TINY_TEST, CCFG, N_ORACLES, window_size=32,
                                       label_indices=LABEL_IDX)
    ids, mask = (torch.from_numpy(a) for a in token_batch())
    with pytest.raises(ValueError, match="smaller than window_size"):
        serve(params, prng.PRNGKey(0, "cpu"), ids, mask)
    with pytest.raises(ValueError, match="int8"):
        ref_serving.dp_serving_step_fn(ref_serving.serving_mesh(), ref_configs.TINY_TEST, REF_CCFG,
                                       n_oracles=N_ORACLES, quant="fp8")


def test_packed_flash_serving_equals_the_reference_and_the_unpacked_step(flax_params, params):
    """Flash attention per data shard against the reference's Pallas
    flash in interpret mode; and the packed window is the unpacked
    step's on the same texts."""
    ours, theirs = packed_batch(None)
    key = prng.PRNGKey(3, "cpu")
    serve = serving.packed_serving_step_fn(port_mesh(), FLASH, CCFG, N_ORACLES, window_size=WINDOW,
                                           subset_size=SUBSET, label_indices=LABEL_IDX)
    with torch.inference_mode():
        out, honest = serve(params, key, *ours)
    mesh = ref_serving.serving_mesh()
    ref_out, ref_honest = ref_serving.packed_serving_step_fn(
        mesh, REF_FLASH, REF_CCFG, N_ORACLES, window_size=WINDOW, subset_size=SUBSET,
        label_indices=LABEL_IDX)(flax_params, jax.random.PRNGKey(3), *ref_row_args(mesh, theirs))
    assert np.array_equal(honest.numpy(), np.asarray(ref_honest))
    assert_consensus_close(out, ref_out)

    tok = load_tokenizer(None, TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=SEQ)
    ids, mask = tok(texts_of(None), SEQ)
    unpacked = serving.dp_serving_step_fn(port_mesh(), TINY_TEST, CCFG, N_ORACLES, window_size=WINDOW,
                                          subset_size=SUBSET, label_indices=LABEL_IDX)
    with torch.inference_mode():
        u_out, u_honest = unpacked(params, key, torch.from_numpy(ids), torch.from_numpy(mask))
    torch.testing.assert_close(out.essence, u_out.essence, rtol=0, atol=2e-4)
    assert torch.equal(honest, u_honest) and torch.equal(out.reliable, u_out.reliable)


def test_pipelined_packed_serving_is_lossless_and_equals_the_reference(flax_params, params):
    """The pipelined twin gives the plain step's outputs one step later,
    bit for bit, the drain closing the last batch; the plain step's
    outputs are the reference's."""
    kw = dict(window_size=WINDOW, subset_size=SUBSET, label_indices=LABEL_IDX)
    mesh = port_mesh()
    serve = serving.packed_serving_step_fn(mesh, FLASH, CCFG, N_ORACLES, **kw)
    pserve = serving.packed_serving_pipelined_step_fn(mesh, FLASH, CCFG, N_ORACLES, **kw)
    drain = serving.fleet_step_fn(mesh, CCFG, N_ORACLES, subset_size=SUBSET)
    batches = [packed_batch(s) for s in range(3)]
    keys = [prng.PRNGKey(50 + s, "cpu") for s in range(3)]
    with torch.inference_mode():
        plain = [serve(params, k, *b[0]) for k, b in zip(keys, batches)]
        prev, _, _ = pserve(params, keys[0], *batches[0][0], torch.zeros(WINDOW, len(LABEL_IDX)))
        got = []
        for k_prev, b in zip(keys, batches[1:]):
            prev, out, honest = pserve(params, k_prev, *b[0], prev)
            got.append((out, honest))
        got.append(drain(keys[2], prev))
    for (out, honest), (p_out, p_honest) in zip(got, plain):
        assert all(torch.equal(a, b) for a, b in zip(out, p_out)) and torch.equal(honest, p_honest)

    ref_mesh = ref_serving.serving_mesh()
    ref_serve = ref_serving.packed_serving_step_fn(ref_mesh, REF_FLASH, REF_CCFG, N_ORACLES, **kw)
    ref_out, ref_honest = ref_serve(flax_params, jax.random.PRNGKey(52), *ref_row_args(ref_mesh, batches[2][1]))
    assert np.array_equal(plain[2][1].numpy(), np.asarray(ref_honest))
    assert_consensus_close(plain[2][0], ref_out)


def test_int8_dp_serving_equals_the_reference_and_one_slot(flax_params, params):
    """``quant="int8"``: the port's fold of the same weights through the
    W8A8 forward on 8 slots equals its 1-slot step (per-row activation
    scales make the split invisible) and the reference's int8 step."""
    qparams = quantize_params(params, TINY_TEST)
    ids, mask = token_batch()
    key = prng.PRNGKey(9, "cpu")
    outs = []
    for mesh in (port_mesh(), port_mesh(1)):
        serve = serving.dp_serving_step_fn(mesh, TINY_TEST, CCFG, N_ORACLES, window_size=WINDOW,
                                           subset_size=SUBSET, label_indices=LABEL_IDX, quant="int8")
        with torch.inference_mode():
            outs.append(serve(qparams, key, torch.from_numpy(ids), torch.from_numpy(mask)))
    (out8, honest8), (out1, honest1) = outs
    torch.testing.assert_close(out8.essence, out1.essence, rtol=0, atol=1e-5)
    assert torch.equal(honest8, honest1) and torch.equal(out8.reliable, out1.reliable)
    mesh = ref_serving.serving_mesh()
    ref_out, ref_honest = ref_serving.dp_serving_step_fn(
        mesh, ref_configs.TINY_TEST, REF_CCFG, N_ORACLES, window_size=WINDOW, subset_size=SUBSET,
        label_indices=LABEL_IDX, quant="int8")(ref_quantize(flax_params, ref_configs.TINY_TEST),
                                               jax.random.PRNGKey(9), *ref_row_args(mesh, (ids, mask)))
    assert np.array_equal(honest8.numpy(), np.asarray(ref_honest))
    assert_consensus_close(out8, ref_out)


def test_int8_packed_serving_tracks_float(params):
    qparams = quantize_params(params, TINY_TEST)
    ours, _ = packed_batch(None)
    key = prng.PRNGKey(3, "cpu")
    kw = dict(window_size=WINDOW, subset_size=SUBSET, label_indices=LABEL_IDX)
    with torch.inference_mode():
        fout, fhonest = serving.packed_serving_step_fn(port_mesh(), TINY_TEST, CCFG, N_ORACLES, **kw)(
            params, key, *ours)
        qout, qhonest = serving.packed_serving_step_fn(port_mesh(), TINY_TEST, CCFG, N_ORACLES, quant="int8",
                                                       **kw)(qparams, key, *ours)
    assert torch.equal(qhonest, fhonest)
    torch.testing.assert_close(qout.essence, fout.essence, rtol=0, atol=0.05)
    assert torch.isfinite(qout.essence).all()


def test_gated_fleet_step_and_the_mesh_helpers():
    window = torch.rand(WINDOW, 6, generator=torch.Generator().manual_seed(4))
    out, honest, admitted = serving.fleet_step_fn(port_mesh(), CCFG, N_ORACLES, subset_size=SUBSET,
                                                  gate=(0.0, 1.0))(prng.PRNGKey(1, "cpu"), window)
    assert admitted.shape == (N_ORACLES,) and bool(admitted.all()) and bool(out.interval_valid)
    mesh = port_mesh(4)
    assert mesh.axis_names == ("data",) and mesh.size == 4
    assert serving.batch_sharding(mesh).spec == ("data", None)
    assert serving.serving_mesh(device="cpu").size == 1


@pytest.mark.parametrize("packed", [False, True])
def test_pipeline_data_mesh_equals_the_unmeshed_pipeline(params, packed):
    """``SentimentPipeline(data_mesh=)`` splits each forward's rows over
    the slots: the vectors are the unmeshed pipeline's to the last bits
    the CPU's row blocking moves."""
    texts = [f"comment {i} on the data mesh" for i in range(20)]
    kw = dict(seq_len=SEQ, batch_size=8, params=params, packed=packed, max_segments=2, device="cpu")
    plain = SentimentPipeline(FLASH, **kw)(texts)
    meshed = SentimentPipeline(FLASH, data_mesh=port_mesh(4), **kw)(texts)
    np.testing.assert_allclose(meshed, plain, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        SentimentPipeline(FLASH, data_mesh=port_mesh(3), **kw)


def test_session_builds_a_data_parallel_vectorizer_with_several_cards(monkeypatch):
    """The session's default vectorizer takes a data mesh of every card
    when there are several (``svoc_tpu/apps/session.py:424-437``), and
    none on one card or the CPU."""
    from svoc_torch.apps import session as session_mod

    built = {}

    class Spy:
        def __init__(self, **kw):
            built.update(kw)

    monkeypatch.setattr("svoc_torch.models.sentiment.SentimentPipeline", Spy)
    s = session_mod.Session(device="cpu")
    s.vectorizer
    assert built["data_mesh"] is None and built["batch_size"] == 32

    built.clear()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    s = session_mod.Session(device="cpu")
    s.device = torch.device("cuda")
    s.vectorizer
    mesh = built["data_mesh"]
    assert mesh.axis_names == ("data",) and [str(d) for d in mesh.devices.flat] == [f"cuda:{i}" for i in range(4)]
