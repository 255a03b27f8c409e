"""The masked reductions on a non-finite block: the port against the JAX
package's, on the CPU.

The probe block is 7 × 6 uniform values with one ``+inf`` entry, in a
row the first pass drops (``n_failing`` 2).

- ``consensus_step`` in both modes gives NaN in exactly the components
  where the reference's does (the essence, skewness and kurtosis), the
  same ``interval_valid``, and every finite output within the bars of
  ``tests/test_torch_consensus.py``: essence and reliabilities 1e-5,
  skewness 1e-4, kurtosis 1e-3.
- The gated forms reduce a sanitised block, so they give bit-identical
  results whether a masked reduction multiplies by the mask or selects
  (held here against select-form copies of the reductions).
- The fused route is pinned: the port's plain version (what B2 is held
  to on the card) beside the reference's interpret-mode Pallas route,
  which on such a block disagrees with the reference's own XLA route.
  The input is outside the contract (the contract panics on it).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.consensus.kernel import ConsensusConfig as JaxConfig
from svoc_tpu.consensus.kernel import consensus_step as jax_consensus_step
from svoc_tpu.ops.pallas_consensus import fused_consensus as jax_fused

from svoc_torch.consensus import kernel
from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.ops import stats
from svoc_torch.ops.fused_consensus import fused_consensus_plain

BARS = {"essence": 1e-5, "essence_first_pass": 1e-5, "reliability_first_pass": 1e-5,
        "reliability_second_pass": 1e-5, "quadratic_risk": 1e-5, "skewness": 1e-4,
        "kurtosis": 1e-3}


def probe_block(n=7, seed=0):
    """``n`` × 6 uniform values with ``+inf`` at row 3, component 2."""
    v = np.random.default_rng(seed).uniform(0.0, 1.0, (n, 6)).astype(np.float32)
    v[3, 2] = np.inf
    return v


@pytest.mark.parametrize("constrained", [True, False], ids=["constrained", "unconstrained"])
def test_consensus_step_nan_pattern_equals_the_reference(constrained):
    values = probe_block()
    ref = jax_consensus_step(jnp.asarray(values), JaxConfig(n_failing=2, constrained=constrained))
    got = kernel.consensus_step(torch.from_numpy(values),
                                ConsensusConfig(n_failing=2, constrained=constrained))
    assert not bool(got.reliable[3])  # the inf row is dropped by the first pass
    assert np.array_equal(np.asarray(ref.reliable), got.reliable.numpy())
    assert bool(ref.interval_valid) == bool(got.interval_valid)
    for field in ("essence", "skewness", "kurtosis"):
        r, p = np.asarray(getattr(ref, field)), getattr(got, field).numpy()
        assert np.array_equal(np.isnan(r), np.isnan(p)), (field, r, p)
    # The non-finite component is NaN in both packages' moments.
    assert bool(torch.isnan(got.skewness[2])) and bool(torch.isnan(got.kurtosis[2]))
    assert bool(torch.isnan(got.essence[2])) == (not constrained)
    for field, bar in BARS.items():
        r = np.asarray(getattr(ref, field), dtype=np.float64)
        p = getattr(got, field).numpy().astype(np.float64)
        assert np.array_equal(np.isfinite(r), np.isfinite(p)), field
        fin = np.isfinite(r)
        np.testing.assert_allclose(p[fin], r[fin], rtol=0, atol=bar * max(1.0, np.abs(r[fin]).max(initial=0)),
                                   err_msg=field)
        assert np.array_equal(p[~fin], r[~fin], equal_nan=True), field


def _select_forms(monkeypatch):
    """Swap in the select forms of the masked reductions (the port's
    before the repair)."""

    def masked_mean(values, mask):
        m = mask.to(values.dtype).sum()
        return torch.where(mask[:, None], values, 0.0).sum(dim=0) / torch.clamp(m, min=1.0)

    def masked_component_variance(values, mask, center):
        d = torch.where(mask[:, None], values - center[None, :], 0.0)
        m = mask.to(values.dtype).sum()
        return torch.sum(d * d, dim=0) / torch.clamp(m, min=1.0)

    monkeypatch.setattr(stats, "masked_mean", masked_mean)
    monkeypatch.setattr(stats, "masked_component_variance", masked_component_variance)


def _gated_inputs(seed):
    """A [4, 7, 6] cube with NaN, inf, out-of-range and quarantined rows,
    one all-quarantined claim and one padding claim."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.0, 1.0, (4, 7, 6)).astype(np.float32)
    ok = np.ones((4, 7), dtype=bool)
    v[0, 6, :], ok[0, 6] = np.inf, False
    v[1, 2, 0], ok[1, 2] = np.nan, False
    v[1, 5, :], ok[1, 5] = -3.5, False
    ok[2, :] = False
    v[2, 0, 1] = np.inf
    claim_mask = np.array([True, True, True, False])
    return torch.from_numpy(v), torch.from_numpy(ok), torch.from_numpy(claim_mask)


def _gated_outputs(values, ok, claim_mask):
    out = []
    for constrained in (True, False):
        cfg = ConsensusConfig(n_failing=2, constrained=constrained)
        out.append(kernel.consensus_step_gated(values[0], ok[0], cfg))
        out.append(kernel.consensus_step_gated_batched(values, ok, cfg))
        out.append(kernel.consensus_step_gated_claims(values, ok, claim_mask, cfg))
    return out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gated_forms_bit_identical_to_the_select_forms(seed, monkeypatch):
    inputs = _gated_inputs(seed)
    now = _gated_outputs(*inputs)
    with monkeypatch.context() as mp:
        _select_forms(mp)
        before = _gated_outputs(*inputs)
    for a, b in zip(now, before):
        for field, x, y in zip(a._fields, a, b):
            assert torch.equal(_bits(x), _bits(y)), field


def test_fused_route_pinned_beside_the_reference_interpret_route():
    """The port's fused plain version on a 16 × 6 block with one inf
    entry (row 3, component 2), pinned, beside what the reference's
    interpret-mode Pallas route gives on the same block."""
    values = probe_block(16)
    cfg = ConsensusConfig(n_failing=2, constrained=True)
    got = fused_consensus_plain(torch.from_numpy(values), cfg)
    ref = jax_fused(jnp.asarray(values), JaxConfig(n_failing=2, constrained=True), interpret=True)

    # The port: the inf row and the worst finite row are unreliable,
    # the essences and rel2 finite, rel1 -inf (a risk of inf), the
    # moments NaN only in the non-finite component.
    assert got.reliable.sum() == 14 and not bool(got.reliable[3])
    assert bool(torch.isfinite(got.essence).all()) and bool(torch.isfinite(got.essence_first_pass).all())
    assert got.reliability_first_pass.item() == -np.inf
    assert np.isfinite(got.reliability_second_pass.item())
    assert torch.isinf(got.quadratic_risk[3]) and int(torch.isfinite(got.quadratic_risk).sum()) == 15
    for moment in (got.skewness, got.kurtosis):
        assert torch.isnan(moment).tolist() == [False, False, True, False, False, False]

    # The reference's interpret route: NaN essence₁ and essence in the
    # non-finite component, NaN risks and reliabilities, every oracle
    # reliable.
    assert np.isnan(np.asarray(ref.essence_first_pass)).tolist() == [False, False, True, False, False, False]
    assert np.isnan(np.asarray(ref.essence)).tolist() == [False, False, True, False, False, False]
    assert np.isnan(np.asarray(ref.quadratic_risk)).all()
    assert np.isnan(float(ref.reliability_first_pass)) and np.isnan(float(ref.reliability_second_pass))
    assert np.asarray(ref.reliable).all()

    # Where the two agree: the components the inf never reaches in the
    # first pass.
    finite = [0, 1, 3, 4, 5]
    np.testing.assert_allclose(got.essence_first_pass.numpy()[finite],
                               np.asarray(ref.essence_first_pass)[finite], atol=1e-5)
