"""The port's svoclint (``svoc_torch.analysis``) against the reference's
analyzer (``svoc_tpu.analysis``), on the CPU.

- **Corpus parity.** Every string literal of ``tests/test_svoclint.py``
  that parses as a Python module (as written, or dedented), read from
  the file as data, goes through both packages' ``analyze_source`` under
  ``fixture.py`` and under each path suffix a rule scopes by.  Each
  snippet is one case.  The findings' (rule, line, col, severity,
  path_trace) must be equal, and their messages and hints equal once
  ``svoc_tpu`` reads ``svoc_torch`` (the port names its own modules).
- **Tree parity.** Both analyzers over ``svoc_tpu tools`` give the same
  findings and suppression counts, but for the extras the port's new
  spellings raise (SVOC001's ``.cpu()``/``.numpy()``/``.tolist()``/
  ``.synchronize()``, SVOC017's port collectives), listed in
  :data:`EXTRAS` by (rule, path, snippet).  There are none: no traced
  body or dispatch span of the reference spells a host sync the port's
  way.
- **SARIF.** Both packages' documents of the same findings are equal,
  in process and through both CLIs' ``--sarif``.

Tolerance: none.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from svoc_tpu.analysis import RULE_DOCS as REF_RULE_DOCS
from svoc_tpu.analysis import analyze_paths as ref_analyze_paths
from svoc_tpu.analysis import analyze_source as ref_analyze_source
from svoc_tpu.analysis.sarif import to_sarif as ref_to_sarif

from svoc_torch.analysis import RULE_DOCS, analyze_paths, analyze_source
from svoc_torch.analysis.sarif import to_sarif

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: ``fixture.py`` and every path suffix a rule scopes by: SVOC005's
#: fixed-point modules, SVOC006's thread-entry modules, SVOC017's parity
#: module, SVOC013's serializers, and the journal and metrics modules.
SUFFIXES = (
    "fixture.py",
    "ops/fixedpoint.py",
    "consensus/wsad_engine.py",
    "apps/web.py",
    "parallel/serving.py",
    "parallel/claim_shard.py",
    "utils/checkpoint.py",
    "durability/recovery.py",
    "utils/events.py",
    "utils/metrics.py",
)

#: The port's extra findings over ``svoc_tpu tools``, by (rule, path,
#: snippet): none.
EXTRAS = ()


def _corpus():
    """The reference test file's string literals that parse as modules,
    each once, in the order they first appear."""
    with open(os.path.join(REPO, "tests", "test_svoclint.py"), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
            continue
        for text in (node.value, textwrap.dedent(node.value)):
            try:
                ast.parse(text)
            except SyntaxError:
                continue
            if text not in out:
                out.append(text)
            break
    return out


CORPUS = _corpus()


def _port_key(f):
    return (f.rule, f.line, f.col, f.severity, f.path_trace, f.message, f.hint, f.snippet, f.context)


def _ref_key(f):
    return (f.rule, f.line, f.col, f.severity, f.path_trace,
            f.message.replace("svoc_tpu", "svoc_torch"), f.hint.replace("svoc_tpu", "svoc_torch"),
            f.snippet, f.context)


def test_the_corpus_is_the_reference_tests_snippets():
    assert len(CORPUS) > 250
    assert sum("\n" in s for s in CORPUS) > 100  # the multi-line fixtures, not only names


@pytest.mark.parametrize("snippet", CORPUS, ids=[f"s{i:03d}" for i in range(len(CORPUS))])
def test_every_snippet_of_the_reference_tests_lints_the_same(snippet):
    for path in SUFFIXES:
        ours = [_port_key(f) for f in analyze_source(snippet, path=path)]
        theirs = [_ref_key(f) for f in ref_analyze_source(snippet, path=path)]
        assert ours == theirs, path


@pytest.fixture(scope="module")
def trees():
    paths = [os.path.join(REPO, "svoc_tpu"), os.path.join(REPO, "tools")]
    return analyze_paths(paths, root=REPO), ref_analyze_paths(paths, root=REPO)


def test_the_reference_tree_lints_the_same_but_for_the_listed_extras(trees):
    ours, theirs = trees
    assert ours.files == theirs.files > 100
    assert ours.parse_errors == theirs.parse_errors == []
    port = [_port_key(f) + (f.path,) for f in ours.all_findings]
    ref = [_ref_key(f) + (f.path,) for f in theirs.all_findings]
    extras = [k for k in port if k not in ref]
    assert [(k[0], k[-1], k[7]) for k in extras] == list(EXTRAS)
    assert [k for k in port if k not in extras] == ref
    assert len(ref) == 6  # the reference's six baselined SVOC003 findings
    assert ours.suppressed == theirs.suppressed


def test_the_rule_tables_are_the_references():
    assert RULE_DOCS == REF_RULE_DOCS


def test_sarif_of_the_same_findings_is_the_same_document(trees):
    ours, theirs = trees
    assert to_sarif(ours.all_findings, RULE_DOCS, root=REPO) == ref_to_sarif(
        theirs.all_findings, REF_RULE_DOCS, root=REPO
    )
    # the corpus's interprocedural findings carry path traces, whose hops
    # become related locations; the same list goes through both writers
    findings = [f for s in CORPUS for f in analyze_source(s, path="utils/events.py")]
    assert sum(bool(f.path_trace) for f in findings) > 20
    assert to_sarif(findings, RULE_DOCS) == ref_to_sarif(findings, REF_RULE_DOCS)


def test_both_clis_write_the_same_sarif(tmp_path):
    args = ["svoc_tpu", "tools", "--no-baseline", "--no-cache"]
    procs = {
        "port": subprocess.Popen(
            [sys.executable, "-m", "svoc_torch.tools.svoclint", *args, "--sarif", str(tmp_path / "port.sarif")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ),
        "ref": subprocess.Popen(
            [sys.executable, os.path.join("tools", "svoclint.py"), *args, "--sarif", str(tmp_path / "ref.sarif")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ),
    }
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 1, (name, out, err)  # six findings with no baseline
    docs = {name: json.loads((tmp_path / f"{name}.sarif").read_text()) for name in procs}
    assert docs["port"] == docs["ref"]
    assert docs["port"]["runs"][0]["tool"]["driver"]["name"] == "svoclint"
    assert len(docs["port"]["runs"][0]["results"]) == 6
