"""The port's fault-space fuzzer (``svoc_torch.durability.fuzz`` and
``svoc_torch.tools.chaos_fuzz``) against the JAX package's, on the CPU:

- ``draw_plan`` gives the reference's plan for seeds 0-39, and the
  directed pass (one seed per ``fuzz`` point) targets every point;
- ``shrink_plan`` walks to the reference's plan on a fixed failing
  predicate, within the same trials;
- a clean child run in each commit mode, in process, recovers the
  reference's fingerprint;
- every tier-1 entry of the committed corpus replays green through the
  port's subprocess children (``python -m svoc_torch.tools.chaos_fuzz
  --child ... --device cpu``), with byte-identical rerun fingerprints
  equal to the reference's recovered ones;
- the fuzzer's ``REFERENCE_FINGERPRINTS`` equal live reference runs
  (the corpus, the felt soak, three directed seeds and one of seeds
  18-31), and cover the tool's default budget, seeds 0-31;
- the codec-divergence witness counts the reference's divergences;
- ``load_corpus`` reads the durable entries only, as the reference's.
"""

import concurrent.futures
import json
import os
import tempfile

import pytest

pytest.importorskip("jax")

import jax  # noqa: F401

import svoc_tpu.durability.faultspace as ref_faultspace
import svoc_tpu.durability.fuzz as ref_fuzz
import svoc_tpu.ops.fixedpoint as ref_fixedpoint

import svoc_torch.durability.faultspace as faultspace
import svoc_torch.durability.forked as forked
import svoc_torch.durability.fuzz as fuzz
from svoc_torch.tools import chaos_fuzz

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "chaos_corpus")
TIER1 = [e for e in ref_fuzz.load_corpus(CORPUS_DIR) if e.get("tier1", True)]


def test_draw_plan_equals_reference_for_40_seeds():
    ref_surface, surface = ref_faultspace.load_surface(), faultspace.load_surface()
    for seed in range(40):
        assert fuzz.draw_plan(seed, surface).as_dict() == ref_fuzz.draw_plan(seed, ref_surface).as_dict()
        assert fuzz.draw_plan(seed).as_dict() == ref_fuzz.draw_plan(seed).as_dict()


def test_directed_pass_covers_every_fuzz_point():
    points = fuzz.fuzz_points(faultspace.load_surface())
    assert list(points) == list(ref_fuzz.fuzz_points(ref_faultspace.load_surface()))
    targets = [fuzz.draw_plan(seed).events[-1].point for seed in range(len(points))]
    assert targets == list(points) and len(points) == 18


def _shrink_start(p):
    FaultEvent = p.FaultEvent
    return p.fuzz.FuzzPlan(seed=5, cycles=7, events=(
        FaultEvent(point="chainlog.tx.post_apply", nth=4, action="kill"),
        FaultEvent(point="wal.intent.pre_fsync", nth=6, action="torn"),
        FaultEvent(point="snapshot.pre_rename", nth=2, action="kill"),
        FaultEvent(point="reconcile.mid_cycle", nth=1, action="kill", phase=1),
    ))


@pytest.mark.parametrize("budget", [5, 40])
def test_shrink_plan_equals_reference(budget):
    class P:
        pass

    ref, port = P(), P()
    ref.fuzz, ref.FaultEvent = ref_fuzz, ref_faultspace.FaultEvent
    port.fuzz, port.FaultEvent = fuzz, faultspace.FaultEvent

    def shrink(p):
        tried = []

        def fails(plan):
            tried.append(plan.as_dict())
            return plan.cycles >= 3 and any(e.point == "wal.intent.pre_fsync" for e in plan.events)

        out = p.fuzz.shrink_plan(_shrink_start(p), fails, budget=budget)
        return out["plan"].as_dict(), out["trials"], tried

    assert shrink(port) == shrink(ref)


@pytest.mark.parametrize("mode", ["per_tx", "batched"])
def test_clean_child_fingerprint_equals_reference(mode):
    """One fault-free child in process: the invariants hold and the
    recovered fingerprint, chain counts and fired points are the
    reference's."""
    def run(f):
        result = f.run_fuzz_child(tempfile.mkdtemp(prefix="fuzz-child-"),
                                  f.FuzzPlan(seed=11, cycles=3, commit_mode=mode), 0,
                                  **({"device": "cpu"} if f is fuzz else {}))
        return {k: result[k] for k in ("fingerprint", "chain", "duplicate_txs", "codec_divergences",
                                       "wal_open_cycles", "lost_commits", "final_unknown", "fired",
                                       "journal_events")}

    port, ref = run(fuzz), run(ref_fuzz)
    assert port == ref
    assert port["duplicate_txs"] == 0 and port["codec_divergences"] == 0 and not port["wal_open_cycles"]
    assert ("chain.batch.mid_fleet" in port["fired"]) == (mode == "batched")


def test_codec_divergence_witness_equals_reference(tmp_path):
    path = str(tmp_path / "chain-x.jsonl")
    rows = [{"caller": 1, "fn": "update_prediction", "prediction": [500000, 7], "digest": "d"},
            {"caller": 1, "fn": "update_prediction", "prediction": [ref_fixedpoint.FELT_PRIME - 10**40],
             "digest": "d"},
            {"caller": 2, "fn": "update_proposition", "prediction": [-1], "digest": "e"},
            {"caller": 1, "fn": "update_prediction", "prediction": [ref_fixedpoint.FELT_PRIME + 3, 1],
             "digest": "f"}]
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    assert fuzz._codec_divergences(path) == ref_fuzz._codec_divergences(path) == 2


def test_load_corpus_reads_the_durable_entries_only():
    port = fuzz.load_corpus(CORPUS_DIR)
    assert port == ref_fuzz.load_corpus(CORPUS_DIR)
    assert len(port) == 4 and all(e["format"] == "svoc-chaos-corpus-v1" for e in port)


def test_child_argv_is_the_port_module():
    argv = fuzz.default_child_argv("plan.json", "wd", 1, "cpu")
    assert argv[1:4] == ["-m", "svoc_torch.tools.chaos_fuzz", "--child"]
    assert argv[-2:] == ["--device", "cpu"] and "--device" not in fuzz.default_child_argv("p", "w", 0)


@pytest.fixture(scope="module")
def corpus_runs(tmp_path_factory):
    """Every tier-1 entry: the port's ``run_and_check`` on the CPU (two
    runs of subprocess children) beside the reference's ``run_plan``,
    all at once on a thread pool (each child is its own interpreter)."""
    base = tmp_path_factory.mktemp("corpus")
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        port = {e["name"]: pool.submit(fuzz.run_and_check, fuzz.FuzzPlan.from_dict(e["plan"]),
                                       str(base / "port" / e["name"]), device="cpu") for e in TIER1}
        ref = {e["name"]: pool.submit(ref_fuzz.run_plan, ref_fuzz.FuzzPlan.from_dict(e["plan"]),
                                      str(base / "ref" / e["name"])) for e in TIER1}
        extra = {key: pool.submit(ref_fuzz.run_plan, plan, str(base / "ref" / str(key)))
                 for key, plan in REFERENCE_PLANS.items()}
        runs = {name: (port[name].result(), ref[name].result()) for name in port}
        runs["reference"] = {key: f.result()["result"]["fingerprint"] for key, f in extra.items()}
        return runs


#: The reference plans whose recovered fingerprints the port's fuzzer
#: keeps as constants, beside the corpus: the felt soak, three directed
#: seeds (a run-stage kill, a recovery-stage storm, a torn write) and one
#: seed past the directed pass.
REFERENCE_PLANS = {
    "felt_soak": ref_fuzz.FuzzPlan(seed=9_000_000, commit_mode="batched", cycles=8, label="felt_soak"),
    0: ref_fuzz.draw_plan(0),
    6: ref_fuzz.draw_plan(6),
    13: ref_fuzz.draw_plan(13),
    24: ref_fuzz.draw_plan(24),
}


def test_reference_constants_equal_the_live_reference(corpus_runs):
    """``chaos_fuzz.REFERENCE_FINGERPRINTS`` (what the card's run is held
    to) against live reference runs: every tier-1 corpus entry, the felt
    soak, three of the directed seeds and seed 24; the seeds cover the
    tool's default budget of 32."""
    consts = chaos_fuzz.REFERENCE_FINGERPRINTS
    assert consts["corpus"] == {name: corpus_runs[name][1]["result"]["fingerprint"] for name in consts["corpus"]}
    assert sorted(consts["corpus"]) == sorted(e["name"] for e in TIER1)
    live = corpus_runs["reference"]
    assert consts["felt_soak"] == live["felt_soak"]
    assert {seed: consts["seeds"][seed] for seed in (0, 6, 13, 24)} == {seed: live[seed] for seed in (0, 6, 13, 24)}
    assert sorted(consts["seeds"]) == list(range(chaos_fuzz.DEFAULT_SEEDS)) == list(range(32))


@pytest.mark.parametrize("name", [e["name"] for e in TIER1])
def test_corpus_entry_replays_green(corpus_runs, name):
    checked, _ = corpus_runs[name]
    assert checked["violations"] == [] and checked["replay_identical"] is True


@pytest.mark.parametrize("name", [e["name"] for e in TIER1])
def test_corpus_entry_recovers_the_reference_fingerprint(corpus_runs, name):
    checked, ref = corpus_runs[name]
    port = checked["run"]
    assert [p["killed"] for p in port["phases"]] == [p["killed"] for p in ref["phases"]]
    assert port["result"]["fingerprint"] == ref["result"]["fingerprint"]
    assert port["fired"] == ref["fired"] and port["unexecuted_events"] == ref["unexecuted_events"]
    assert set(port["result"]["child_seconds"]) == {"start_s", "interpreter_s", "torch_import_s", "port_import_s",
                                                    "cuda_init_s", "workload_s", "forked"}
    assert port["result"]["child_seconds"]["forked"] is False and port["result"]["child_seconds"]["torch_import_s"] > 0


def test_fork_server_children_recover_the_reference_fingerprint(tmp_path):
    """A plan whose first child is SIGKILLed at its fault point, its
    children forked from the fork server (torch and the child's modules
    imported once, CUDA never initialised there): the kill comes back as
    -9, the recovered fingerprint is the spawned children's and the
    reference's, and the rerun is identical."""
    seed = 6  # a recovery-stage restart storm: three children
    plan = fuzz.draw_plan(seed, faultspace.load_surface())
    checked = fuzz.run_and_check(plan, str(tmp_path / "fork"), device="cpu", launcher=fuzz.fork_child)
    run = checked["run"]
    assert checked["violations"] == [] and checked["replay_identical"] is True
    assert [p["returncode"] for p in run["phases"]][:1] == [-9] and run["phases"][-1]["returncode"] == 0
    assert run["result"]["fingerprint"] == chaos_fuzz.REFERENCE_FINGERPRINTS["seeds"][seed]
    seconds = run["result"]["child_seconds"]
    assert seconds["forked"] is True and seconds["torch_import_s"] == seconds["port_import_s"] == 0.0
    assert set(chaos_fuzz.CHILD_MODULES) <= set(forked.PRELOAD)  # the server imported them
    with pytest.raises(ValueError, match="children only"):
        fuzz.fork_child(["python", "-m", "elsewhere"], 1.0)
