"""The port's seeded fault injection and chaos scenarios against the JAX
package's, on the CPU.

- ``FaultPlan``'s draws: the same decisions, fired-fault history and
  fingerprint for the same seed over the same call sequence, through
  error, timeout, stall, prefix, ``after`` and ``max_fires`` specs, and
  through ``FaultInjectingBackend``;
- ``run_chaos_scenario`` at seeds 4 and 5 (6 cycles) and at seed 4 (12
  cycles, the chaos smoke's run): the fingerprint, the fired-fault
  count, the per-cycle outcomes and the replacement history;
- ``run_byzantine_scenario`` at seed 0: the same, with its injection and
  quarantine logs;
- the port's chaos smoke passes at its defaults.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import svoc_tpu.resilience.chaos as ref_chaos
import svoc_tpu.resilience.faults as ref_faults
from svoc_tpu.consensus.state import OracleConsensusContract as RefContract
from svoc_tpu.io.chain import ChainAdapter as RefAdapter
from svoc_tpu.io.chain import LocalChainBackend as RefBackend
from svoc_tpu.utils.metrics import MetricsRegistry as RefRegistry

import svoc_torch.resilience.chaos as chaos
import svoc_torch.resilience.faults as faults
from svoc_torch.consensus.state import OracleConsensusContract
from svoc_torch.io.chain import ChainAdapter, LocalChainBackend
from svoc_torch.tools import chaos_smoke
from svoc_torch.utils.metrics import MetricsRegistry


def _history(result):
    return [{k: r[k] for k in ("step", "slot", "old", "new")}
            for r in result["replacement_history"]]


def _outcomes(result):
    """The per-cycle outcomes without the wall clock of each replacement."""
    return [dict(o, replaced=[{k: v for k, v in r.items() if k != "ts"} for r in o["replaced"]])
            for o in result["outcomes"]]


def _same_run(port, ref):
    assert _outcomes(port) == _outcomes(ref)
    for key in ("fingerprint", "journal_fingerprint", "journal_events",
                "faults_fired", "duplicate_txs", "replacements", "offender_replaced",
                "consensus_active", "final_cycle_complete"):
        assert port.get(key) == ref.get(key), key
    assert _history(port) == _history(ref)


@pytest.mark.parametrize("seed, cycles", [(4, 6), (5, 6), (4, 12)])
def test_chaos_scenario_equals_reference(seed, cycles):
    ref = ref_chaos.run_chaos_scenario(seed, cycles=cycles, registry=RefRegistry())
    port = chaos.run_chaos_scenario(seed, cycles=cycles, registry=MetricsRegistry())
    _same_run(port, ref)
    assert port["faults_fired"] > 0 and port["duplicate_txs"] == 0
    if (seed, cycles) == (4, 12):
        assert port["fingerprint"] == chaos_smoke.REFERENCE_FINGERPRINT
        assert port["faults_fired"] == 17 and port["offender_replaced"]


def test_byzantine_scenario_equals_reference():
    ref = ref_chaos.run_byzantine_scenario(0, registry=RefRegistry())
    port = chaos.run_byzantine_scenario(0, registry=MetricsRegistry())
    assert _outcomes(port) == _outcomes(ref)
    for key in ("fingerprint", "journal_fingerprint", "injections", "quarantines",
                "missed_injections", "false_quarantines", "reason_mismatches",
                "essence_in_band", "colluders_voted_out", "injector_voted_out",
                "replacements", "duplicate_txs"):
        assert port[key] == ref[key], key
    assert _history(port) == _history(ref)
    assert port["injections"] > 0 and port["missed_injections"] == 0
    assert port["false_quarantines"] == 0 and port["injector_voted_out"]


def _specs(mod):
    return [
        mod.FaultSpec(op="invoke:update_prediction", kind="error", target=0x10, probability=0.4),
        mod.FaultSpec(op="invoke:*", kind="timeout", probability=0.2, after=3),
        mod.FaultSpec(op="call:get_oracle_list", kind="stall", probability=0.5, stall_s=0.25),
        mod.FaultSpec(op="invoke:update_prediction", target=0x12, max_fires=2),
    ]


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_fault_plan_draws_equal_reference(seed):
    calls = [("invoke:update_prediction", 0x10 + (i % 4)) for i in range(40)]
    calls += [("call:get_oracle_list", None)] * 10 + [("invoke:vote_for_a_proposition", 0xA0)] * 5
    ref_plan = ref_faults.FaultPlan(seed, _specs(ref_faults), registry=RefRegistry())
    plan = faults.FaultPlan(seed, _specs(faults), registry=MetricsRegistry())
    got = [getattr(plan.decide(op, t), "kind", None) for op, t in calls]
    want = [getattr(ref_plan.decide(op, t), "kind", None) for op, t in calls]
    assert got == want and any(got)
    assert plan.history() == ref_plan.history()
    assert plan.fingerprint() == ref_plan.fingerprint()


@pytest.mark.parametrize("value", [0, 0x1F, "alpha", None, (1, "x"), 2**40])
def test_keying_primitives_equal_reference(value):
    assert faults.crc_key(value) == ref_faults.crc_key(value)
    assert faults.mix_key(7, faults.crc_key(value), 2**63 + 5) == ref_faults.mix_key(
        7, ref_faults.crc_key(value), 2**63 + 5)


def test_fault_injecting_backend_equals_reference():
    """The wrapper over a live chain: the same txs fail, the same stalls
    sleep, and the chain ends in the same state."""
    def run(mod, fixedpoint, contract_cls, backend_cls, adapter_cls, reg, **kw):
        contract = contract_cls(admins=[0xA0, 0xA1, 0xA2], oracles=[0x10 + i for i in range(7)],
                                n_failing_oracles=2, dimension=6, **kw)
        slept = []
        plan = mod.FaultPlan(3, mod.standard_fault_specs(transient=[0x10, 0x11],
                                                         persistent=[0x16]) + [
            mod.FaultSpec(op="call:get_oracle_list", kind="stall", stall_s=0.5, max_fires=1)],
            registry=reg)
        adapter = adapter_cls(mod.FaultInjectingBackend(backend_cls(contract), plan,
                                                        sleep=slept.append))
        out = []
        rng = np.random.default_rng(0)
        for _ in range(3):
            for slot, oracle in enumerate(adapter.call_oracle_list()):
                try:
                    adapter._invoke_prediction_felts(
                        oracle, fixedpoint.encode_vector(rng.uniform(0.05, 0.95, 6)))
                    out.append("ok")
                except mod.InjectedFault as e:
                    out.append(type(e).__name__)
        return out, slept, plan.history(), [list(o.value) for o in contract.oracles]

    import svoc_tpu.ops.fixedpoint as ref_fixedpoint
    import svoc_torch.ops.fixedpoint as fixedpoint

    port = run(faults, fixedpoint, OracleConsensusContract, LocalChainBackend, ChainAdapter,
               MetricsRegistry(), device="cpu")
    ref = run(ref_faults, ref_fixedpoint, RefContract, RefBackend, RefAdapter, RefRegistry())
    assert port == ref
    assert {"ok", "InjectedFault"} <= set(port[0]) and port[1] == [0.5]


def test_fault_spec_validation():
    for mod in (faults, ref_faults):
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultSpec(op="x", kind="melt")
        with pytest.raises(ValueError, match="outside"):
            mod.FaultSpec(op="x", probability=1.5)
        assert mod.FaultSpec(op="invoke:*").matches("invoke:anything", 3)
        assert not mod.FaultSpec(op="invoke:a", target=1).matches("invoke:a", 2)


def test_chaos_smoke_passes(capsys):
    assert chaos_smoke.main([]) == 0
    assert '"matches_reference_fingerprint": true' in capsys.readouterr().out
