"""The port's claim router in its other modes against the JAX
package's, on the CPU (``tests/test_torch_fabric.py`` holds the seeded
scenario).

- The request-fed cycle with the sanitized dispatch (gate and consensus
  in one pass over the cube, a poisoned feed and an unknown claim among
  the feeds): the same reports and fingerprints as the reference's.
- The weighted rotation under a batch cap, with a paused claim and a
  claim whose tamper hook raises (isolated, counted in its own
  ``fabric_claim_errors``): the same reports, claim states and journal.
- The claim mesh, the resident staging and the console hook run;
  ``consensus_impl`` routing is refused.
"""

import types

import numpy as np
import pytest

pytest.importorskip("jax")

from svoc_tpu.fabric import registry as ref_registry
from svoc_tpu.fabric import scenario as ref_scenario
from svoc_tpu.fabric import session as ref_fabric_session
from svoc_tpu.io.comment_store import CommentStore as RefStore
from svoc_tpu.utils.events import EventJournal as RefJournal
from svoc_tpu.utils.metrics import MetricsRegistry as RefRegistry

from svoc_torch.fabric import registry, scenario
from svoc_torch.fabric import session as fabric_session
from svoc_torch.fabric.router import ClaimRouter
from svoc_torch.io.comment_store import CommentStore
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.sim.generators import claim_seed
from svoc_torch.utils.events import EventJournal
from svoc_torch.utils.metrics import MetricsRegistry


def _fabric(port: bool, n_claims=5, **kw):
    if port:
        cls, spec_cls, store_cls = fabric_session.MultiSession, registry.ClaimSpec, CommentStore
        kw.update(journal=EventJournal(), metrics=MetricsRegistry(), device="cpu")
    else:
        cls, spec_cls, store_cls = (ref_fabric_session.MultiSession, ref_registry.ClaimSpec,
                                    RefStore)
        kw.update(journal=RefJournal(), metrics=RefRegistry())

    def store_factory(claim_id):
        store = store_cls()
        store.save(SyntheticSource(batch=60, seed=claim_seed(3, claim_id))())
        return store

    multi = cls(base_seed=3, vectorizer=ref_scenario.deterministic_vectorizer,
                store_factory=store_factory, lineage_scope="fx", commit_mode="batched", **kw)
    for i in range(n_claims):
        multi.add_claim(spec_cls(claim_id=f"c{i}", weight=1 + (i % 3)))
    return multi


def _strip(report):
    return {k: v for k, v in report.items() if k != "claims"}, {
        c: v["commit"] for c, v in report["claims"].items()
    }


def test_request_fed_sanitized_fabric_equals_the_reference():
    port = _fabric(True, sanitized_dispatch=True)
    ref = _fabric(False, sanitized_dispatch=True)
    rng = np.random.default_rng(4)
    for step in range(4):
        feeds = {f"c{i}": rng.uniform(0.05, 0.95, size=(int(rng.integers(1, 9)), 6))
                 for i in range(5) if (i + step) % 3}
        if step == 2:
            feeds["c1"] = np.full((3, 6), np.nan)
            feeds["ghost"] = np.zeros((1, 6))
        p, r = port.step(feeds), ref.step(feeds)
        assert _strip(p) == _strip(r)
    assert port.router._resolve_journal().fingerprint() == ref.router._resolve_journal().fingerprint()
    for cid in port.claim_ids():
        assert port.claim_fingerprint(cid) == ref.claim_fingerprint(cid)


def test_weighted_rotation_pause_and_a_raising_tamper():
    def boom(cycle, block):
        if cycle == 1:
            raise RuntimeError("tamper hook failed")
        return block

    fabrics = []
    for port in (True, False):
        multi = _fabric(port, max_claims_per_batch=2)
        spec_cls = registry.ClaimSpec if port else ref_registry.ClaimSpec
        multi.add_claim(spec_cls(claim_id="bad", tamper=boom))
        fabrics.append(multi)
    for step in range(9):
        if step == 3:
            for multi in fabrics:
                multi.pause("c2")
        p, r = (multi.step() for multi in fabrics)
        assert _strip(p) == _strip(r)
    assert fabrics[0].metrics.counter(
        "fabric_claim_errors", labels={"claim": "bad", "stage": "fetch"}
    ).count == 1
    p_snap, r_snap = (multi.claims_state() for multi in fabrics)
    assert {c: (s["cycles"], s["lineage"], s["consensus"]["reliable"]) for c, s in p_snap.items()} == {
        c: (s["cycles"], s["lineage"], s["consensus"]["reliable"]) for c, s in r_snap.items()
    }
    assert fabrics[0].router._resolve_journal().fingerprint() == (
        fabrics[1].router._resolve_journal().fingerprint()
    )


def test_options_that_wait_raise():
    """The claim mesh, the resident staging, the console hook and the
    compile plane's options run: the mesh pins its spec as the
    reference's router does, the prewarm routing, the worker, its
    attachment and the scenario's warmup, which leaves the journal as it
    was.  ``consensus_impl`` routing is refused."""
    from svoc_tpu.fabric.registry import ClaimRegistry as RefRegistry
    from svoc_tpu.fabric.router import ClaimRouter as RefRouter

    reg = registry.ClaimRegistry()
    for mesh in ("2x1", "2x4", "off", None):
        assert ClaimRouter(reg, device="cpu", mesh=mesh).mesh_spec == RefRouter(
            RefRegistry(), mesh=mesh, consensus_impl="xla").mesh_spec
    resident = ClaimRouter(reg, device="cpu", device_resident=True)
    assert resident.device_resident
    with pytest.raises(ValueError):
        ClaimRouter(reg, device="cpu", consensus_impl="pallas")
    assert ClaimRouter(reg, device="cpu", warmup_mode="prewarm").warmup_mode == "prewarm"
    with pytest.raises(ValueError, match="warmup_mode"):
        ClaimRouter(reg, device="cpu", warmup_mode="eager")
    multi = fabric_session.MultiSession(device="cpu")
    worker = multi.start_prewarm(background=False, force=True)
    assert multi.router.prewarmer is worker and worker.stats()["universe"] == 0
    other = object()
    multi.router.attach_prewarmer(other)
    assert multi.router.prewarmer is other
    console = types.SimpleNamespace()
    multi.attach(console)
    assert console.fabric is multi
    warmed = scenario.run_fabric_scenario(0, cycles=1, warmup=True, device="cpu")
    plain = scenario.run_fabric_scenario(0, cycles=1, device="cpu")
    assert warmed["journal_fingerprint"] == plain["journal_fingerprint"]
