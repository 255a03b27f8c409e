"""The port's svoclint engine and CLI (``svoc_torch.analysis``,
``svoc_torch.tools.svoclint``), on the CPU.

The engine behaviours ``tests/test_svoclint.py`` holds for the
reference, run on the port's engine and CLI (``main`` in process, with
its output captured): inline, trailing and file-level suppression; the
baseline's round trip, line-drift tolerance, stale entries and rebase
hints; the cache's cold and warm runs, per-file invalidation and
version mismatch; ``--changed`` with git and without it; exit codes 0,
1 and 2, and SVOC000 on a syntax error.  Then the port's own cases: the
torch spellings of a host sync in a dispatch span and in a ``shard_map``
body, the port's collectives under SVOC017, the port's tree clean
against its baseline through the CLI, and a lint that loads no ``jax``,
``flax``, ``svoc_tpu`` or ``torch`` module (the two CLI subprocesses).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from svoc_torch.analysis import Baseline, analyze_paths, analyze_source
from svoc_torch.analysis.cache import CACHE_BASENAME, RULESET_VERSION
from svoc_torch.tools import svoclint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def src(text):
    return textwrap.dedent(text)


def rules_of(findings):
    return sorted({f.rule for f in findings})


def lint(capsys, *args):
    """``(exit code, stdout, stderr)`` of the port's CLI, run in process
    and never on the repository's findings cache."""
    args = list(args)
    if "--cache" not in args and "--no-cache" not in args:
        args.append("--no-cache")
    rc = svoclint.main(args)
    out, err = capsys.readouterr()
    return rc, out, err


#: A host sync the port's way inside a dispatch span.
SYNC = src(
    """
    from svoc_torch.utils.metrics import stage_span

    def forward(model, x):
        with stage_span("forward"):
            return model(x).cpu()
    """
)


# ---------------------------------------------------------------------------
# the port's spellings
# ---------------------------------------------------------------------------


def test_cpu_is_a_host_sync_in_a_dispatch_span_not_in_a_host_stage():
    (f,) = analyze_source(SYNC)
    assert (f.rule, f.line, f.snippet) == ("SVOC001", 6, "return model(x).cpu()")
    assert f.message == 'host sync `.cpu()` inside dispatch-path span "forward"'
    assert analyze_source(SYNC.replace('"forward"', '"pack"')) == []


@pytest.mark.parametrize("call", ["x.numpy()", "x.tolist()", "torch.cuda.synchronize()",
                                  "done.synchronize()", "x.item()"])
def test_every_port_spelling_is_a_host_sync(call):
    code = src(
        f"""
        import torch
        from svoc_torch.utils.metrics import stage_span

        def step(x, done):
            with stage_span("consensus"):
                return {call}
        """
    )
    assert [f.rule for f in analyze_source(code)] == ["SVOC001"]


def test_tolist_in_a_port_shard_map_body_is_flagged():
    findings = analyze_source(
        src(
            """
            from svoc_torch.parallel.mesh import P
            from svoc_torch.parallel.sharded import shard_map

            def body(x):
                return x.tolist()

            def rows(mesh):
                return shard_map(body, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"))
            """
        )
    )
    assert [(f.rule, f.line) for f in findings] == [("SVOC001", 6)]
    assert "inside jit-traced `body`" in findings[0].message


_AXES = src(
    """
    from svoc_torch.parallel import sharded
    from svoc_torch.parallel.sharded import all_gather, psum

    DATA_AXIS = "data"
    ORACLE_AXIS = "oracle"

    def body(x):
        a = psum(x, DATA_AXIS)
        b = psum(x, "bogus")
        c = sharded.all_gather(x, "oraclez")
        return a, b, c, all_gather(x, ORACLE_AXIS)

    def psum_local(x, axis):
        return x

    def other(x):
        return psum_local(x, "bogus")
    """
)


def test_svoc017_knows_the_port_collectives():
    findings = analyze_source(_AXES)
    assert [(f.rule, f.line) for f in findings] == [("SVOC017", 10), ("SVOC017", 11)]
    assert "`psum` in `body` names axis `bogus`" in findings[0].message
    assert "`all_gather` in `body` names axis `oraclez`" in findings[1].message


def test_a_port_collective_in_the_claim_shard_parity_body_is_an_error():
    code = src(
        """
        from svoc_torch.parallel.sharded import all_gather

        CLAIM_AXIS = "claim"
        ORACLE_AXIS = "oracle"

        def _host_cube_body(cfg):
            def body(values):
                return all_gather(values, ORACLE_AXIS)
            return body

        def _fleet_cube_body(cfg):
            def body(values):
                return all_gather(values, ORACLE_AXIS)
            return body
        """
    )
    findings = analyze_source(code, path="svoc_torch/parallel/claim_shard.py")
    assert [(f.rule, f.line) for f in findings] == [("SVOC017", 9)]
    assert "collective `all_gather` inside exact-parity claim-cube body `_host_cube_body.body`" in (
        findings[0].message
    )
    assert analyze_source(code, path="svoc_torch/parallel/fleet.py") == []


# ---------------------------------------------------------------------------
# suppression
# ---------------------------------------------------------------------------


def test_inline_suppression_silences_one_rule_on_one_line():
    findings = analyze_source(
        src(
            """
            from svoc_torch.utils.metrics import stage_span

            def f(x):
                with stage_span("forward"):
                    a = x.cpu()  # svoclint: disable=SVOC001 -- the span's one fetch
                    b = x.numpy()
                    return a, b
            """
        )
    )
    assert [f.snippet for f in findings] == ["b = x.numpy()"]


@pytest.mark.parametrize("comment", ["disable=SVOC001, SVOC002", "disable=SVOC001,SVOC002", "disable=all"])
def test_inline_suppression_lists_and_all(comment):
    code = src(
        f"""
        from svoc_torch.parallel.sharded import shard_map

        def body(x):
            print(x.cpu())  # svoclint: {comment}
            return x

        run = shard_map(body, mesh=None, in_specs=(), out_specs=None)
        """
    )
    assert analyze_source(code) == []
    assert rules_of(analyze_source(code.replace(f"# svoclint: {comment}", ""))) == ["SVOC001", "SVOC002"]


def test_trailing_suppression_covers_every_line_of_the_statement():
    findings = analyze_source(
        src(
            """
            from svoc_torch.utils.metrics import stage_span

            def g(mean, median):
                with stage_span("consensus"):
                    return {
                        "mean": mean.cpu(),
                        "median": median.cpu(),
                    }  # svoclint: disable=SVOC001
            """
        )
    )
    assert findings == []


def test_file_level_suppression_and_a_comment_in_a_string():
    assert analyze_source("# svoclint: disable-file=SVOC001\n" + SYNC) == []
    in_string = 'NOTE = """ svoclint: disable-file=SVOC001 """\n' + SYNC
    assert rules_of(analyze_source(in_string)) == ["SVOC001"]


# ---------------------------------------------------------------------------
# the baseline
# ---------------------------------------------------------------------------


def test_baseline_round_trip_drift_and_edits(tmp_path):
    findings = analyze_source(SYNC, path="pkg/mod.py")
    path = str(tmp_path / "baseline.json")
    Baseline.from_findings(findings, reason="grandfathered in test").dump(path)
    loaded = Baseline.load(path)
    assert json.load(open(path))["entries"][0]["reason"] == "grandfathered in test"
    new, baselined, stale = loaded.split(analyze_source(SYNC, path="pkg/mod.py"))
    assert new == [] and len(baselined) == 1 and stale == []
    # lines added above: the same snippet, still baselined
    new, baselined, stale = loaded.split(analyze_source("import os\nimport sys\n" + SYNC, path="pkg/mod.py"))
    assert new == [] and len(baselined) == 1 and stale == []
    # the flagged line edited: not covered, and the old entry is stale
    edited = SYNC.replace("model(x).cpu()", "model(x * 2).cpu()")
    new, baselined, stale = loaded.split(analyze_source(edited, path="pkg/mod.py"))
    assert len(new) == 1 and baselined == [] and len(stale) == 1
    # the finding fixed: the entry is stale, so baselines only shrink
    assert loaded.split([]) == ([], [], stale)


def test_baseline_context_blocks_a_lookalike(tmp_path):
    path = str(tmp_path / "baseline.json")
    Baseline.from_findings(analyze_source(SYNC, path="pkg/mod.py")).dump(path)
    lookalike = SYNC.replace("def forward(model, x):", "def other(model, x):") + "    # another statement\n"
    new, baselined, stale = Baseline.load(path).split(analyze_source(lookalike, path="pkg/mod.py"))
    assert len(new) == 1 and baselined == [] and len(stale) == 1


def test_write_baseline_keeps_curated_reasons_and_rebase_hints(tmp_path, capsys):
    mod, bl = tmp_path / "mod.py", tmp_path / "bl.json"
    mod.write_text(SYNC)
    assert lint(capsys, str(mod), "--baseline", str(bl), "--write-baseline", "--root", str(tmp_path))[0] == 0
    data = json.load(open(bl))
    data["entries"][0]["reason"] = "curated explanation"
    json.dump(data, open(bl, "w"))
    assert lint(capsys, str(mod), "--baseline", str(bl), "--write-baseline", "--root", str(tmp_path))[0] == 0
    assert json.load(open(bl))["entries"][0]["reason"] == "curated explanation"
    rc, out, _ = lint(capsys, str(mod), "--baseline", str(bl), "--root", str(tmp_path))
    assert rc == 0 and "0 new, 1 baselined" in out
    # the flagged statement edited: a stale entry with its likely successor
    mod.write_text(SYNC.replace("model(x).cpu()", "model(x * 2).cpu()"))
    rc, out, _ = lint(capsys, str(mod), "--baseline", str(bl), "--root", str(tmp_path))
    assert rc == 1 and "stale baseline entry" in out and "suggested rebase" in out
    rc, out, _ = lint(capsys, str(mod), "--baseline", str(bl), "--root", str(tmp_path), "--format", "json")
    (entry,) = json.loads(out)["stale_baseline_entries"]
    assert entry["suggested_rebase"]["snippet"] == "return model(x * 2).cpu()"
    # the finding truly fixed: stale, with no successor to suggest
    mod.write_text("x = 1\n")
    rc, out, _ = lint(capsys, str(mod), "--baseline", str(bl), "--root", str(tmp_path))
    assert rc == 1 and "stale baseline entry" in out and "suggested rebase" not in out


def test_write_baseline_refuses_parse_errors(tmp_path, capsys):
    (tmp_path / "broken.py").write_text("def f(:\n")
    bl = tmp_path / "bl.json"
    rc, _, err = lint(capsys, str(tmp_path), "--baseline", str(bl), "--write-baseline")
    assert rc == 1 and "refused" in err
    assert all(e["rule"] != "SVOC000" for e in json.load(open(bl))["entries"])


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


def _make_tree(root, n):
    for i in range(n):
        body = "\n".join(f"def fn_{i}_{j}(x):\n    return x + {j}\n" for j in range(20))
        (root / f"mod_{i:03d}.py").write_text(f'"""module {i}"""\nimport json\n\n{body}\n')


def test_cache_cold_warm_edit_and_version(tmp_path):
    tree = tmp_path / "tree"
    tree.mkdir()
    _make_tree(tree, 12)
    cache = str(tmp_path / CACHE_BASENAME)
    cold = analyze_paths([str(tree)], root=str(tmp_path), cache_path=cache)
    assert cold.parsed == cold.files == 12 and cold.cache_hits == 0
    warm = analyze_paths([str(tree)], root=str(tmp_path), cache_path=cache)
    assert warm.parsed == 0 and warm.cache_hits == 12
    assert warm.all_findings == cold.all_findings
    # one file edited: only it is parsed again
    (tree / "mod_003.py").write_text(SYNC)
    edited = analyze_paths([str(tree)], root=str(tmp_path), cache_path=cache)
    assert edited.parsed == 1 and edited.cache_hits == 11
    assert rules_of(edited.all_findings) == ["SVOC001"]
    # a cache another rule set wrote (the reference's version) is dropped whole
    data = json.load(open(cache))
    assert data["ruleset"] == RULESET_VERSION
    data["ruleset"] = "svoclint-3-contract-1"
    json.dump(data, open(cache, "w"))
    again = analyze_paths([str(tree)], root=str(tmp_path), cache_path=cache)
    assert again.parsed == 12 and again.cache_hits == 0


def test_the_cache_file_is_the_ports_own(capsys, tmp_path):
    assert CACHE_BASENAME == ".svoclint_torch_cache.json"
    assert svoclint.DEFAULT_CACHE == os.path.join(REPO, CACHE_BASENAME)
    bad = tmp_path / "bad.py"
    bad.write_text(SYNC)
    cache = str(tmp_path / "c.json")
    first = lint(capsys, str(bad), "--no-baseline", "--cache", cache)
    second = lint(capsys, str(bad), "--no-baseline", "--cache", cache)
    assert first[0] == second[0] == 1 and "SVOC001" in second[1] and "0 parsed" in second[1]


# ---------------------------------------------------------------------------
# --changed
# ---------------------------------------------------------------------------


def _git(cwd, *args):
    return subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
                          capture_output=True, text=True, cwd=cwd, timeout=30)


def test_changed_lints_only_files_differing_from_main(tmp_path, capsys):
    if _git(tmp_path, "--version").returncode != 0:
        pytest.skip("git unavailable")
    repo = tmp_path / "repo"
    repo.mkdir()
    assert _git(repo, "init", "-q", "-b", "main").returncode == 0
    (repo / "committed_bad.py").write_text(SYNC)
    (repo / "touched.py").write_text("x = 1\n")
    _git(repo, "add", "-A")
    assert _git(repo, "commit", "-q", "-m", "seed").returncode == 0
    rc, out, _ = lint(capsys, str(repo), "--changed", "--no-baseline", "--root", str(repo))
    assert rc == 0 and "no changed python files" in out
    (repo / "touched.py").write_text(SYNC)
    rc, out, _ = lint(capsys, str(repo), "--changed", "--no-baseline", "--root", str(repo))
    assert rc == 1 and "touched.py" in out and "committed_bad.py" not in out


def test_changed_falls_back_to_the_full_tree_without_git(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(SYNC)
    rc, out, err = lint(capsys, str(bad), "--changed", "--no-baseline", "--root", str(tmp_path))
    assert rc == 1 and "SVOC001" in out and "full tree" in err


# ---------------------------------------------------------------------------
# exit codes
# ---------------------------------------------------------------------------


def test_exit_codes_and_svoc000(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert lint(capsys, str(clean), "--no-baseline")[0] == 0
    assert lint(capsys, str(tmp_path / "not" / "a" / "path"))[0] == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert lint(capsys, str(clean), "--baseline", str(bad))[0] == 2
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    rc, out, _ = lint(capsys, str(broken), "--no-baseline")
    assert rc == 1 and "SVOC000" in out
    rc, out, _ = lint(capsys, "--list-rules")
    assert rc == 0 and [line.split()[0] for line in out.splitlines()] == [f"SVOC{i:03d}" for i in range(1, 18)]


# ---------------------------------------------------------------------------
# the port's tree, through the CLI
# ---------------------------------------------------------------------------


def test_the_ports_tree_is_clean_against_its_baseline(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "svoc_torch.tools.svoclint", "--format", "json",
         "--cache", str(tmp_path / CACHE_BASENAME)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    counts = payload["counts"]
    assert counts["new"] == counts["stale_baseline_entries"] == 0 and payload["findings"] == []
    assert counts["files"] > 100 and counts["suppressed"] > 30
    entries = Baseline.load(svoclint.DEFAULT_BASELINE).entries
    assert counts["baselined"] == len(entries) and all(e.get("reason") for e in entries)
    assert not any("triage me" in e["reason"] for e in entries)


def test_linting_loads_no_jax_and_no_torch():
    code = (
        "import contextlib, io, sys\n"
        "from svoc_torch.tools import svoclint\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    rc = svoclint.main(['--no-cache', '--sarif', '/dev/null'])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'svoc_tpu', 'torch'))\n"
        "assert rc == 0, rc\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
