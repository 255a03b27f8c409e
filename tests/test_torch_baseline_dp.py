"""BASELINE configs 7 and 11 (``svoc_torch.tools.baseline_configs``) against the
JAX package, on the CPU, at ``bench.py``'s ``small`` sizes.

Each config runs two ways on the same seeded inputs: through
``svoc_tpu.parallel.serving``'s functions composed as
``bench.py::bench_config7`` and ``_bench_packed_dp_serving(quant="int8")``
compose them, on the 8 virtual CPU devices of ``tests/conftest.py``; and
through the port's functions on an 8-slot CPU mesh, with the flax weights
carried across by ``params_from_flax`` and the same ``SyntheticSource``
batches and keys.  Bars: the sentiment vectors within 1e-4
(``test_torch_encoder.py``); the W8A8 forward at ``test_torch_quant.py``'s
bars (the float forward's logits within ``0.15·max(1, |ref|)``, and the
reference's int8 logits within 1e-5 on every segment whose quantized
activations are the reference's; see below); the consensus as
``test_torch_baseline_configs.py`` holds it (the reliable mask exact;
essences and reliabilities 1e-5; skewness 1e-4; kurtosis 1e-3); the
honest mask exact; and within the port, config 11's pipelined step of
batch k equal to its plain step's on batch k, exactly.

The W8A8 forwards of the two packages quantize each layer's input row by
row.  Where an input lies within an ulp of a rounding boundary of that
quantization, the packages' float32 forwards (1e-6 apart) put it in
neighbouring int8 steps, and the segment's logits move by up to about
1.5e-2 (6 to 11 of 131 to 133 segments in config 11's small batches);
``test_torch_quant.py`` holds the fold, the row quantization and the
int32 sums equal on identical inputs.  So config 11's int8 logits are
held to the reference's at the quantization bar, ``0.15·max(1, |ref|)``,
with at least :data:`INT8_EXACT_SHARE` of the segments within 1e-5; its
step is split where the packages part: the window within the int8
vectors' bar (0.05, the share above within 1e-4), and the fleet and
consensus of the reference's window at the consensus bars.  No kernel is on these paths but threefry, which runs
its plain version here; ``chip_smoke.py`` phase 21 runs both configs on
the card.
"""

import collections
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from svoc_tpu.consensus.kernel import ConsensusConfig as JaxConsensusConfig  # noqa: E402
from svoc_tpu.io.scraper import SyntheticSource as JaxSource  # noqa: E402
from svoc_tpu.models import configs as jax_configs  # noqa: E402
from svoc_tpu.models import quant as jax_quant  # noqa: E402
from svoc_tpu.models.packing import pack_tokens_auto as jax_pack_tokens_auto  # noqa: E402
from svoc_tpu.models.packing import strip_padding as jax_strip_padding  # noqa: E402
from svoc_tpu.models.sentiment import SentimentPipeline as JaxPipeline  # noqa: E402
from svoc_tpu.parallel import serving as jax_serving  # noqa: E402

from svoc_torch.io.scraper import SyntheticSource  # noqa: E402
from svoc_torch.models import quant  # noqa: E402
from svoc_torch.models.configs import TINY_TEST  # noqa: E402
from svoc_torch.models.encoder import load_encoder  # noqa: E402
from svoc_torch.models.packing import PackedSentimentEncoder  # noqa: E402
from svoc_torch.models.from_jax import params_from_flax  # noqa: E402
from svoc_torch.models.sentiment import SentimentPipeline  # noqa: E402
from svoc_torch.parallel.serving import serving_mesh  # noqa: E402
from svoc_torch.sim import prng  # noqa: E402
from svoc_torch.tools import baseline_configs as bc  # noqa: E402

VEC_TOL = 1e-4
CONSENSUS_BARS = {"essence": 1e-5, "essence_first_pass": 1e-5, "reliability_first_pass": 1e-5,
                  "reliability_second_pass": 1e-5, "skewness": 1e-4, "kurtosis": 1e-3}
#: Config 11: the int8 vectors' bar (``tests/test_quant.py``), and the least share of a batch's segments
#: (of the window's rows) whose int8 logits agree within 1e-5 (vectors within 1e-4): 0.92-0.95 measured.
INT8_VECTOR_BAR, INT8_EXACT_SHARE = 0.05, 0.85
SLOTS = 8  # the reference's virtual CPU devices (tests/conftest.py)
#: The keys of the tests' steps: the warm-up's and the timed loop's first two.
STEP_KEYS = (0, 1, 2)


def assert_consensus(got, ref):
    assert np.array_equal(got.reliable.numpy(), np.asarray(ref.reliable))
    for name, bar in CONSENSUS_BARS.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=0, atol=bar,
                                   err_msg=name)


def keys_of(i):
    """``PRNGKey(0)`` folded as the timed loop folds it, ``i`` times."""
    jkey, key = jax.random.PRNGKey(0), prng.PRNGKey(0, "cpu")
    for s in range(i):
        jkey, key = jax.random.fold_in(jkey, s), prng.fold_in(key, s)
    return jkey, key


@pytest.fixture(scope="module")
def jax_ref():
    """The reference's small sizes on its 8 devices (``bench.py:1601-1621,
    2196-2227``): the seeded float pipeline, the mesh and its sharding."""
    assert len(jax.devices()) == SLOTS
    mesh = jax_serving.serving_mesh()
    return dict(mesh=mesh, shard=jax_serving.batch_sharding(mesh))


def port_setup(config, flax_params):
    return bc.dp_serving(config, small=True, device="cpu", params=params_from_flax(flax_params),
                         mesh=serving_mesh(["cpu"] * SLOTS))


# -- config 7 -----------------------------------------------------------------


@pytest.fixture(scope="module")
def config7(jax_ref):
    per_dev, seq, n_oracles = bc.CONFIG7_SMALL_ROWS, bc.DP_SMALL_SEQ, bc.DP_SMALL_ORACLES_PER_SLOT * SLOTS
    batch = per_dev * SLOTS
    ccfg = JaxConsensusConfig(n_failing=max(2, n_oracles // 8), constrained=True)
    jpipe = JaxPipeline(cfg=jax_configs.TINY_TEST, seq_len=seq, batch_size=batch, tokenizer_name=None)
    serve = jax_serving.dp_serving_step_fn(jax_ref["mesh"], jax_configs.TINY_TEST, ccfg, n_oracles,
                                           window_size=min(50, batch), subset_size=10)
    source = JaxSource(batch=batch, seed=0)
    batches = [jpipe.tokenizer(source(), seq) for _ in range(2)]
    s = port_setup(7, jpipe.params)
    ours = bc.dp_batches(s, SyntheticSource(batch=s.rows, seed=0), 2)
    return dict(jpipe=jpipe, serve=serve, batches=batches, s=s, ours=ours, ccfg=ccfg)


def test_config7_sizes_are_bench_small(config7):
    s = config7["s"]
    assert (s.rows, s.seq, s.n_oracles, s.ccfg.n_failing, s.window) == (256, 32, 128, 16, 50)
    assert s.mesh.size == SLOTS and s.pipelined is None and s.fold_s == 0.0
    assert s.ccfg == bc.ConsensusConfig(n_failing=config7["ccfg"].n_failing, constrained=True)


@pytest.mark.parametrize("b", [0, 1])
def test_config7_batches_and_vectors_match_the_reference(config7, b):
    """The native tokenizer's batch is the reference's, and the slots'
    row-split forward gives its vectors."""
    ids, mask = config7["batches"][b]
    (t_ids, t_mask), n = config7["ours"][b]
    assert n == 256 and np.array_equal(t_ids.numpy(), ids) and np.array_equal(t_mask.numpy(), mask)
    jvecs = np.asarray(config7["jpipe"].forward_fn()(config7["jpipe"].params, jnp.asarray(ids), jnp.asarray(mask)))
    s = config7["s"]
    pipe = SentimentPipeline(TINY_TEST, seq_len=s.seq, batch_size=s.rows, params=s.params, data_mesh=s.mesh,
                             device="cpu")
    vecs = pipe.forward(t_ids, t_mask)
    assert vecs.shape == (256, 6)
    np.testing.assert_allclose(vecs.numpy(), jvecs, rtol=0, atol=VEC_TOL)


@pytest.mark.parametrize("i", STEP_KEYS)
def test_config7_step_matches_the_reference(config7, jax_ref, i):
    jkey, key = keys_of(i)
    b = i % 2
    ids, mask = (jax.device_put(jnp.asarray(a), jax_ref["shard"]) for a in config7["batches"][b])
    jout, jhonest = config7["serve"](config7["jpipe"].params, jkey, ids, mask)
    out, honest = bc.dp_step(config7["s"], key, config7["ours"][b][0])
    assert np.array_equal(honest.numpy(), np.asarray(jhonest))
    assert int((~honest).sum()) == 16
    assert_consensus(out, jout)


def test_config7_distinct_warmups(config7):
    """bench.py's check: the two warm-up batches give distinct essences."""
    s, key = config7["s"], prng.PRNGKey(0, "cpu")
    essences = [bc.dp_step(s, key, b)[0].essence for b, _ in config7["ours"]]
    assert not torch.equal(*essences)


# -- config 11 ----------------------------------------------------------------


def jax_packed_batches(jpipe, source, rows, seq, max_seg, n):
    """``bench.py::packed_comment_stream``'s batches, serially."""
    buf, out = collections.deque(), []
    need = rows * max_seg
    while len(out) < n:
        while len(buf) < need:
            buf.extend(jax_strip_padding(*jpipe.tokenizer(source(), seq)))
        batch, count = jax_pack_tokens_auto(list(buf), seq, max_seg, jpipe.tokenizer.pad_id, rows=rows)
        for _ in range(count):
            buf.popleft()
        out.append((batch, count))
    return out


@pytest.fixture(scope="module")
def config11(jax_ref):
    per_dev, seq, max_seg = bc.CONFIG11_SMALL_ROWS, bc.DP_SMALL_SEQ, bc.CONFIG11_SMALL_SEGMENTS
    n_oracles = bc.DP_SMALL_ORACLES_PER_SLOT * SLOTS
    rows = per_dev * SLOTS
    ccfg = JaxConsensusConfig(n_failing=max(2, n_oracles // 8), constrained=True)
    jpipe = JaxPipeline(cfg=jax_configs.TINY_TEST, seq_len=seq, batch_size=rows, tokenizer_name=None)
    qtree = jax_quant.quantize_params(jpipe.params, jax_configs.TINY_TEST)
    kw = dict(window_size=min(50, rows), subset_size=10, quant="int8")
    serve = jax_serving.packed_serving_step_fn(jax_ref["mesh"], jax_configs.TINY_TEST, ccfg, n_oracles, **kw)
    pserve = jax_serving.packed_serving_pipelined_step_fn(jax_ref["mesh"], jax_configs.TINY_TEST, ccfg,
                                                          n_oracles, **kw)
    batches = jax_packed_batches(jpipe, JaxSource(batch=rows, seed=1), rows, seq, max_seg, 2)
    batches += jax_packed_batches(jpipe, JaxSource(batch=rows, seed=0), rows, seq, max_seg, 2)
    s = port_setup(11, jpipe.params)
    ours = bc.dp_batches(s, SyntheticSource(batch=s.rows, seed=1), 2)
    ours += bc.dp_batches(s, SyntheticSource(batch=s.rows, seed=0), 2)
    return dict(jpipe=jpipe, qtree=qtree, serve=serve, pserve=pserve, batches=batches, s=s, ours=ours)


def test_config11_sizes_are_bench_small(config11):
    s = config11["s"]
    assert (s.rows, s.seq, s.max_seg, s.n_oracles, s.ccfg.n_failing, s.window) == (128, 32, 4, 128, 16, 50)
    assert quant.is_quantized_tree(s.params) and s.fold_s >= 0.0
    assert s.pipelined is not None and s.drain is not None


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_config11_packed_batches_match_the_reference(config11, b):
    batch, n = config11["batches"][b]
    arrays, count = config11["ours"][b]
    assert count == n
    want = (batch.ids, batch.pos, batch.seg, batch.cls_pos, np.asarray(batch.seg_valid) > 0)
    assert all(np.array_equal(t.numpy(), np.asarray(a)) for t, a in zip(arrays, want))


def test_config11_fold_equals_the_reference(config11):
    """``quantize_params`` on the carried float weights is the reference's fold, bit for bit."""
    ours = config11["s"].params
    theirs = params_from_flax(config11["qtree"])
    assert set(ours) == set(theirs)
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)


@pytest.mark.parametrize("b", [0, 2])
def test_config11_w8a8_forward_meets_the_quant_bars(config11, b):
    """On a config-11 batch: the reference's int8 logits within 1e-5, the
    float forward's within 0.15·max(1, |ref|) (``test_torch_quant.py``)."""
    batch, _ = config11["batches"][b]
    arrays = [t.long() for t in config11["ours"][b][0][:4]]
    valid = np.asarray(batch.seg_valid) > 0
    ref = np.asarray(jax_quant.quantized_packed_forward(
        config11["qtree"], jnp.asarray(batch.ids), jnp.asarray(batch.pos), jnp.asarray(batch.seg),
        jnp.asarray(batch.cls_pos), jax_configs.TINY_TEST))
    out = quant.quantized_packed_forward(config11["s"].params, *arrays, TINY_TEST).numpy()
    gaps = np.abs(out[valid] - ref[valid]).max(-1)
    assert gaps.max() < 0.15 * max(1.0, np.abs(ref[valid]).max())
    assert np.mean(gaps <= 1e-5) >= INT8_EXACT_SHARE
    with torch.no_grad():
        floats = load_encoder(PackedSentimentEncoder, TINY_TEST, params_from_flax(config11["jpipe"].params))(
            *arrays).numpy()
    assert np.abs(out[valid] - floats[valid]).max() < 0.15 * max(1.0, np.abs(floats[valid]).max())


@pytest.mark.parametrize("i", STEP_KEYS)
def test_config11_step_matches_the_reference(config11, jax_ref, i):
    """The step split where the packages part: its window (the int8
    forward's vectors) within the int8 bar of the reference's, and its
    fleet and consensus on the reference's window at the consensus bars;
    the plain step's honest mask and the reference's plain step's, exact."""
    jkey, key = keys_of(i)
    b = i % 2 + (2 if i else 0)
    batch, _ = config11["batches"][b]
    arrays = [jax.device_put(jnp.asarray(a), jax_ref["shard"])
              for a in (batch.ids, batch.pos, batch.seg, batch.cls_pos, np.asarray(batch.seg_valid) > 0)]
    jout, jhonest = config11["serve"](config11["qtree"], jkey, *arrays)
    jwindow, _, _ = config11["pserve"](config11["qtree"], jkey, *arrays, jnp.zeros((50, 6), jnp.float32))
    s = config11["s"]
    window, _, _ = bc.dp_pipelined(s, key, config11["ours"][b][0], bc.zero_window(s))
    rows = np.abs(window.numpy() - np.asarray(jwindow)).max(-1)
    assert rows.max() <= INT8_VECTOR_BAR and np.mean(rows <= VEC_TOL) >= INT8_EXACT_SHARE
    out, honest = bc.dp_drain(s, key, torch.from_numpy(np.array(jwindow)))
    assert np.array_equal(honest.numpy(), np.asarray(jhonest))
    assert_consensus(out, jout)
    _, plain_honest = bc.dp_step(s, key, config11["ours"][b][0])
    assert torch.equal(plain_honest, honest)


def test_config11_pipelined_is_lossless(config11):
    """bench.py's timed loop, primed with a warm-up window: the pipelined
    output of batch k is the plain step's on batch k under batch k's key,
    exactly, the drain closing the last."""
    s, ours = config11["s"], config11["ours"]
    key = prng.PRNGKey(0, "cpu")
    prev_window, primed, _ = bc.dp_pipelined(s, key, ours[0][0], bc.zero_window(s))
    prev_key, got, plain = key, [], []
    for step, (batch, _) in enumerate(ours[2:]):
        key = prng.fold_in(key, step)
        prev_window, out, honest = bc.dp_pipelined(s, prev_key, batch, prev_window)
        got.append((out, honest))
        plain.append(bc.dp_step(s, key, batch))
        prev_key = key
    got.append(bc.dp_drain(s, prev_key, prev_window))
    got = got[1:]  # the first output is the warm-up batch's
    assert len(got) == len(plain) == 2
    for (out, honest), (p_out, p_honest) in zip(got, plain):
        assert all(torch.equal(a, b) for a, b in zip(out, p_out)) and torch.equal(honest, p_honest)
    assert not torch.equal(got[0][0].essence, got[1][0].essence)


# -- the entry points ---------------------------------------------------------


@pytest.mark.parametrize("config", [7, 11])
def test_run_returns_bench_metric_unit_and_rate(config):
    report = bc.run(config, small=True, device="cpu", seconds=0)
    metric, unit = bc.METRICS[config]
    assert report["metric"] == metric.format(n_dev=1, n=16, s=4) and report["unit"] == unit
    assert report["value"] > 0 and "vs_baseline" not in report
    d = report["detail"]
    assert d["device"] == "cpu" and d["n_mesh_devices"] == 1 and d["consensus_n_oracles"] == 16
    # Two warm-ups and three latency steps, then one timed step (and, for
    # config 11, the primed step and the drain): a kernel's launches.
    assert d["steps"] == 1 and d["calls"] == 2 + 3 + (1 if config == 7 else 3)
    assert d["distinct_essences"] == 1 if config == 7 else 2


@pytest.mark.parametrize("config", [7, 11])
def test_the_cli_accepts_configs_7_and_11(config, capsys):
    assert bc.main(["--config", str(config), "--small", "--device", "cpu", "--seconds", "0"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["metric"].startswith(f"config {config}: ") and report["unit"] == "comments/sec"
    assert report["detail"]["rows"] == (32 if config == 7 else 16)


def test_the_metric_strings_are_bench_py_s():
    assert bc.METRICS[7][0].format(n_dev=1, n=1024, s=1) == (
        "config 7: data-parallel serving over 1 device(s) — sharded sentiment batch -> 1024-oracle fleet -> "
        "consensus")
    assert bc.METRICS[11][0].format(n_dev=1, n=1024, s=8) == (
        "config 11: INT8 (W8A8) sequence-packed data-parallel serving over 1 device(s) — 8-seg packed rows -> "
        "1024-oracle fleet -> consensus")


def test_dp_serving_refuses_other_configs_and_defaults_to_cuda(monkeypatch):
    with pytest.raises(ValueError, match="not a data-parallel serving config"):
        bc.dp_serving(3, small=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bc.dp_serving(7, small=True), lambda: bc.run(11, small=True),
                 lambda: bc.main(["--config", "7", "--small"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
