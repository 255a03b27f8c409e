"""The port's Byzantine strategies and breakdown certificate
(``svoc_torch.robustness.{attacks,certify}``,
``svoc_torch.tools.robustness_cert``) against the JAX package's, on the CPU:

- ``apply_attack``, every strategy at several colluder counts over a
  batch of trials (the reference vmapped): within 1e-6 (an ulp of the
  direction's norm), the jitter bit for bit;
- ``_grid_eval`` fed the same honest, benign and position arrays (numpy,
  from a seed) through both packages: mean and max deviations within
  1e-5, capture (the reliable mask) and ``valid_fraction`` (for the
  constrained estimator) within 1e-6, the float32 mean of the same masks.  For the unconstrained one the
  reference's jitted grid contracts ``1 - min(ms, √q)/ms`` into a fused
  multiply-add and reads a saturated reliability as -1.5e-8 (invalid)
  where the port reads 0 (valid); the certificate does not read it;
- ``certificate`` on the same sweep: equal;
- ``robustness_cert --smoke`` on the CPU against the reference's smoke:
  the 10 checks, the Byzantine fingerprint, each certificate's
  ``certified`` and tolerated counts, every cell within 1e-5; and the
  tool's seed-0 constants against that live run.
"""

import dataclasses
import runpy
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from svoc_tpu.consensus.kernel import ConsensusConfig as RefConfig  # noqa: E402
from svoc_tpu.robustness import attacks as ref_attacks  # noqa: E402
from svoc_tpu.robustness import certify as ref_certify  # noqa: E402
from svoc_torch.consensus.kernel import ConsensusConfig  # noqa: E402
from svoc_torch.robustness import attacks, certify  # noqa: E402
from svoc_torch.sim import prng  # noqa: E402
from svoc_torch.tools import robustness_cert  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
T, N, M = 8, 8, 6  # the smoke's trials and fleet


def _fleets(seed, unconstrained=False):
    rng = np.random.default_rng(seed)
    if unconstrained:
        honest = rng.normal(10.0, 3.0, (T, N, M)).astype(np.float32)
        benign = rng.normal(10.0, 3.0, (T, N, M)).astype(np.float32)
    else:
        honest = rng.beta(20, 20, (T, N, M)).astype(np.float32)
        benign = rng.beta(20, 20, (T, N, M)).astype(np.float32)
    positions = np.argsort(rng.random((T, N)), axis=-1).astype(np.int32)
    return honest, benign, positions


@pytest.mark.parametrize("attack_id", range(len(attacks.ATTACK_NAMES)))
def test_apply_attack_equals_reference(attack_id):
    assert attacks.ATTACK_NAMES == ref_attacks.ATTACK_NAMES
    honest, _, positions = _fleets(attack_id)
    jkeys = jax.random.split(jax.random.PRNGKey(3), T)
    tkeys = prng.split(prng.PRNGKey(3, "cpu"), T)
    frac = ((np.arange(T) + 1.0) / T).astype(np.float32)
    for k in (0, 3, 6):
        cm = positions < k
        want = jax.vmap(lambda key, v, c, f: ref_attacks.apply_attack(key, v, c, attack_id, 0.45, 4, round_frac=f))(
            jkeys, jnp.asarray(honest), jnp.asarray(cm), jnp.asarray(frac))
        got = attacks.apply_attack(tkeys, torch.from_numpy(honest), torch.from_numpy(cm), attack_id, 0.45, 4,
                                   round_frac=torch.from_numpy(frac))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        assert np.array_equal(got.numpy()[~cm], honest[~cm])  # only colluder slots move


def test_apply_attack_unconstrained_target_and_no_clip():
    honest, _, positions = _fleets(9, unconstrained=True)
    target = tuple(float(x) for x in np.full(M, 10.0) + 10.0 / np.sqrt(M))
    cm = positions < 4
    for aid in range(len(attacks.ATTACK_NAMES)):
        want = jax.vmap(lambda key, v, c: ref_attacks.apply_attack(key, v, c, aid, 5.0, 2, target=jnp.asarray(target),
                                                                   clip=None))(
            jax.random.split(jax.random.PRNGKey(5), T), jnp.asarray(honest), jnp.asarray(cm))
        got = attacks.apply_attack(prng.split(prng.PRNGKey(5, "cpu"), T), torch.from_numpy(honest),
                                   torch.from_numpy(cm), aid, 5.0, 2, target=target, clip=None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("constrained", [True, False])
def test_grid_eval_equals_reference(constrained):
    """The smoke's grid layout (every attack at 0-4 colluders and one
    magnitude, then a benign row a count) over numpy fleets, so the
    reference's jitted grid is the one its smoke compiles."""
    honest, benign, positions = _fleets(11, unconstrained=not constrained)
    mag = 0.45 if constrained else 5.0
    ids = [a for a in range(len(attacks.ATTACK_NAMES)) for _ in range(5)] + [-1] * 5
    counts = list(range(5)) * (len(attacks.ATTACK_NAMES) + 1)
    mags = [mag] * (5 * len(attacks.ATTACK_NAMES)) + [0.0] * 5
    target = tuple([1.0] * M) if constrained else tuple(float(x) for x in (np.full((M,), 10.0, np.float32)
                                                                            + 10.0 / np.sqrt(M)))
    clip = (0.0, 1.0) if constrained else None
    jkeys = jax.vmap(lambda i: jax.random.split(jax.random.fold_in(jax.random.PRNGKey(2), i), T))(
        jnp.arange(len(ids)))
    tkeys = prng.split(prng.split(prng.PRNGKey(2, "cpu"), len(ids)), T)
    want = ref_certify._grid_eval(jkeys, jnp.asarray(honest), jnp.asarray(benign), jnp.asarray(positions),
                                  jnp.asarray(ids, jnp.int32), jnp.asarray(counts, jnp.int32),
                                  jnp.asarray(mags, jnp.float32),
                                  cfg=RefConfig(n_failing=2, constrained=constrained, max_spread=10.0), n_failing=2,
                                  clip=clip, target=target)
    got = certify._grid_eval(tkeys, torch.from_numpy(honest), torch.from_numpy(benign),
                             torch.from_numpy(positions.astype(np.int64)), ids, counts, mags,
                             cfg=ConsensusConfig(n_failing=2, constrained=constrained, max_spread=10.0),
                             n_failing=2, clip=clip, target=target)
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w, np.float64), g.numpy().astype(np.float64)
        if i < 2:  # mean and max deviation
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        elif i == 2 or constrained:  # capture; valid fraction (constrained): the same masks, an ulp of the mean
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def _as_ref_sweep(sweep):
    out = dict(sweep)
    out["cells"] = [ref_certify.BreakdownCell(**dataclasses.asdict(c)) for c in sweep["cells"]]
    return out


@pytest.fixture(scope="module")
def smokes():
    """The reference's and the port's ``robustness_cert --smoke`` at seed 0."""
    ref_tool = runpy.run_path(str(REPO / "tools" / "robustness_cert.py"), run_name="ref_robustness_cert")
    return ref_tool["run"](0, True), robustness_cert.run(0, True, device="cpu")


def test_smoke_equals_reference(smokes):
    ref, port = smokes
    assert port["checks"] == ref["checks"] and port["ok"] and set(port["checks"]) == set(ref["checks"])
    assert len(port["checks"]) == 10
    assert port["byzantine"]["fingerprint"] == ref["byzantine"]["fingerprint"]
    assert port["byzantine_replay_fingerprint"] == ref["byzantine_replay_fingerprint"]
    assert port["certificate_summary"] == robustness_cert.certificate_summary(ref["certificates"])
    for name in ("constrained", "unconstrained"):
        for a, b in zip(ref["sweeps"][name]["cells"], port["sweeps"][name]["cells"]):
            assert (a["attack"], a["colluders"], a["magnitude"]) == (b["attack"], b["colluders"], b["magnitude"])
            for key in ("mean_deviation", "max_deviation"):
                assert abs(a[key] - b[key]) <= 1e-5, (name, a, b)
            assert a["mean_capture"] == pytest.approx(b["mean_capture"], abs=1e-6)
        for c, v in ref["sweeps"][name]["benign_deviation"].items():
            assert abs(port["sweeps"][name]["benign_deviation"][c] - v) <= 1e-5


def test_certificate_of_the_same_sweep_equals_reference(smokes):
    _, port = smokes
    cells = port["sweeps"]["constrained"]["cells"]
    sweep = dict(port["sweeps"]["constrained"], cells=[certify.BreakdownCell(**c) for c in cells],
                 benign_deviation={int(k): v for k, v in port["sweeps"]["constrained"]["benign_deviation"].items()})
    for bound in (0.05, 0.01, 0.002):
        assert certify.certificate(sweep, bound_abs=bound) == ref_certify.certificate(_as_ref_sweep(sweep),
                                                                                      bound_abs=bound)


def test_reference_constants_equal_the_live_smoke(smokes):
    """The seed-0 constants the card's run is held to: the Byzantine
    fingerprint and the smoke certificates, against the live reference
    (the full mode's were computed the same way, by ``tools/robustness_cert.py``)."""
    ref, port = smokes
    assert robustness_cert.REFERENCE["byzantine_fingerprint"] == ref["byzantine"]["fingerprint"]
    assert robustness_cert.REFERENCE["smoke"] == robustness_cert.certificate_summary(ref["certificates"])
    assert port["reference_mismatches"] == {}
    assert set(robustness_cert.REFERENCE["full"]) == {"constrained", "unconstrained"}
