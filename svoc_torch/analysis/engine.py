"""File walking, per-module + whole-package analysis, report assembly.

``analyze_paths`` is the whole pipeline minus baseline policy (the CLI
owns that): discover ``*.py`` files, parse each (or reuse the
content-hash cache), build its :class:`~svoc_torch.analysis.jitmap.JitMap`,
run every per-module rule, then fold the per-module
:class:`~svoc_torch.analysis.callgraph.ModuleSummary` extracts into one
:class:`~svoc_torch.analysis.callgraph.Program` and run the
interprocedural rules (SVOC008–015, SVOC017) over it, drop suppressed
findings, and return an :class:`AnalysisReport`.  SVOC015 additionally
reads ``docs/OBSERVABILITY.md`` (resolved against the analysis root)
— the one non-Python input the engine threads through as
``PackageContext.docs_path``.

Two-phase shape: phase 1 is embarrassingly per-file (and therefore
cacheable — ``.svoclint_cache.json`` keys on content hash, so a warm
run parses nothing); phase 2 is cross-file by definition and always
runs fresh, but consumes only the compact summaries, so it costs
milliseconds, not re-parses.

Import cost discipline: this module (and everything it pulls in) must
import neither JAX nor the analyzed code — ``make lint`` runs on boxes
with no accelerator stack warmed up, and a lint that pays XLA init
would be slower than the tests it gates.

The port's copy of :mod:`svoc_tpu.analysis.engine` (``engine.py:1-353``),
unchanged but for the package's name. The cache file is the port's own
(``.svoclint_torch_cache.json``).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import time
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from svoc_torch.analysis.cache import FileEntry, FindingsCache, source_digest
from svoc_torch.analysis.callgraph import ModuleSummary, Program, summarize_module
from svoc_torch.analysis.findings import Finding, SuppressionIndex
from svoc_torch.analysis.interrules import PACKAGE_RULES, PackageContext
from svoc_torch.analysis.jitmap import JitMap
from svoc_torch.analysis.rules import ALL_RULES

SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", "_build"}

#: SVOC015's docs-side input, relative to the analysis root.
OBSERVABILITY_DOC = "docs/OBSERVABILITY.md"


def _load_docs(root: str) -> Tuple[Optional[str], List[str]]:
    """``(root-relative docs path, lines)`` for the observability
    taxonomy, or ``(None, [])`` when the root has no docs tree (fixture
    dirs, vendored subsets) — SVOC015 skips in that case."""
    full = os.path.join(root, *OBSERVABILITY_DOC.split("/"))
    try:
        with open(full, "r", encoding="utf-8") as fh:
            return OBSERVABILITY_DOC, fh.read().splitlines()
    except OSError:
        return None, []


@dataclasses.dataclass
class ModuleUnit:
    """One parsed module, ready for the rules."""

    path: str  # posix, relative to the analysis root
    source: str
    lines: List[str]
    tree: ast.Module
    jitmap: JitMap
    suppressions: SuppressionIndex

    @property
    def tags(self) -> Set[str]:
        return self.suppressions.tags


@dataclasses.dataclass
class AnalysisReport:
    """Everything one run produced, pre-baseline."""

    findings: List[Finding]
    files: int
    suppressed: int
    duration_s: float
    parse_errors: List[Finding] = dataclasses.field(default_factory=list)
    #: rel paths of every analyzed file — baseline rewrites use this to
    #: preserve entries for files OUTSIDE the analyzed subset
    analyzed_paths: List[str] = dataclasses.field(default_factory=list)
    #: files that actually went through ``ast.parse`` this run — a warm
    #: cache run reports 0 here (the cache test's behavioral assert)
    parsed: int = 0
    cache_hits: int = 0

    @property
    def all_findings(self) -> List[Finding]:
        """Rule findings plus parse errors (a file svoclint cannot read
        is a finding, not a silent skip — CI must fail loudly)."""
        return sorted(
            self.parse_errors + self.findings,
            key=lambda f: (f.path, f.line, f.col, f.rule),
        )


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    # Dedup by realpath: overlapping path args ("tools tools/x.py")
    # must not analyze a file twice — duplicate findings would consume
    # the baseline multiset and fail a clean tree.
    seen: Set[str] = set()

    def emit(path: str) -> Iterator[str]:
        real = os.path.realpath(path)
        if real not in seen:
            seen.add(real)
            yield path

    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield from emit(path)
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(
                d for d in dirnames if d not in SKIP_DIRS and not d.startswith(".")
            )
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    yield from emit(os.path.join(dirpath, fname))


def _relpath(path: str, root: Optional[str]) -> str:
    if root:
        try:
            rel = os.path.relpath(path, root)
            if not rel.startswith(".."):
                path = rel
        except ValueError:
            pass
    return path.replace(os.sep, "/")


def _build_unit(path: str, source: str):
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return Finding(
            rule="SVOC000",
            severity="error",
            path=path,
            line=e.lineno or 1,
            col=e.offset or 0,
            message=f"file does not parse: {e.msg}",
            hint="svoclint analyzes the AST — fix the syntax error first",
            snippet=(e.text or "").strip(),
        )
    return ModuleUnit(
        path=path,
        source=source,
        lines=source.splitlines(),
        tree=tree,
        jitmap=JitMap(tree),
        suppressions=SuppressionIndex(source),
    )


def _run_rules(unit: ModuleUnit) -> Tuple[List[Finding], int]:
    """``(kept findings, suppressed count)`` for one module."""
    raw: List[Finding] = []
    for rule in ALL_RULES:
        raw.extend(rule(unit))
    # Overlapping scopes (nested spans, re-wrapped defs) can visit a
    # node twice — report each (rule, line, col, message) once.
    seen = set()
    out: List[Finding] = []
    for f in sorted(raw, key=lambda f: (f.line, f.col, f.rule, f.message)):
        key = (f.rule, f.line, f.col, f.message)
        if key in seen:
            continue
        seen.add(key)
        out.append(f)
    kept = [
        f for f in out if not unit.suppressions.is_suppressed(f.rule, f.line)
    ]
    return kept, len(out) - len(kept)


def _run_package_rules(
    summaries: List[ModuleSummary],
    lines_by_path: Dict[str, List[str]],
    suppressions: Dict[str, SuppressionIndex],
    docs_path: Optional[str] = None,
) -> Tuple[List[Finding], int]:
    """The interprocedural phase: one Program over every summary."""
    program = Program(summaries)
    ctx = PackageContext(lines_by_path, docs_path=docs_path)
    raw: List[Finding] = []
    for rule in PACKAGE_RULES:
        raw.extend(rule(program, ctx))
    seen = set()
    deduped: List[Finding] = []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule, f.message)):
        key = (f.rule, f.path, f.line, f.message)
        if key in seen:
            continue
        seen.add(key)
        deduped.append(f)
    kept: List[Finding] = []
    n_suppressed = 0
    for f in deduped:
        idx = suppressions.get(f.path)
        if idx is not None and idx.is_suppressed(f.rule, f.line):
            n_suppressed += 1
        else:
            kept.append(f)
    return kept, n_suppressed


def analyze_module(path: str, source: str) -> List[Finding]:
    """Run every rule — per-module AND interprocedural, over this one
    module as the whole program — on one source; suppressions applied."""
    unit = _build_unit(path, source)
    if isinstance(unit, Finding):
        return [unit]
    findings, _suppressed = _run_rules(unit)
    summary = summarize_module(path, unit.tree, unit.tags, source_lines=unit.lines)
    # No docs here: a single source string is not the package, and
    # loading docs/OBSERVABILITY.md from the CWD would make
    # analyze_source results depend on where the test runner sits.
    # SVOC015 needs a real root — analyze_paths threads it through.
    pkg, _pkg_suppressed = _run_package_rules(
        [summary], {path: unit.lines}, {path: unit.suppressions},
        docs_path=None,
    )
    return sorted(
        findings + pkg, key=lambda f: (f.line, f.col, f.rule, f.message)
    )


def analyze_source(source: str, path: str = "fixture.py") -> List[Finding]:
    """Test/tooling entry point: analyze one source string."""
    return analyze_module(path, source)


def analyze_paths(
    paths: Iterable[str],
    root: Optional[str] = None,
    cache_path: Optional[str] = None,
) -> AnalysisReport:
    """Analyze every ``*.py`` under ``paths``; paths in findings are
    relative to ``root`` (default: the current working directory).
    With ``cache_path``, unchanged files (by content hash) skip parsing
    and the per-module rules entirely — the interprocedural pass runs
    either way, over the (possibly cached) summaries."""
    root = root or os.getcwd()
    t0 = time.perf_counter()
    cache = FindingsCache(cache_path) if cache_path else None
    findings: List[Finding] = []
    parse_errors: List[Finding] = []
    analyzed: List[str] = []
    summaries: List[ModuleSummary] = []
    lines_by_path: Dict[str, List[str]] = {}
    suppressions: Dict[str, SuppressionIndex] = {}
    suppressed = 0
    files = 0
    parsed = 0
    for fpath in iter_python_files(paths):
        files += 1
        rel = _relpath(fpath, root)
        analyzed.append(rel)
        try:
            with open(fpath, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            parse_errors.append(
                Finding(
                    rule="SVOC000",
                    severity="error",
                    path=rel,
                    line=1,
                    col=0,
                    message=f"unreadable file: {e}",
                    hint="",
                )
            )
            continue
        lines_by_path[rel] = source.splitlines()
        if cache is not None:
            sha = source_digest(source)
            entry = cache.lookup(rel, sha)
            if entry is not None:
                findings.extend(entry.findings)
                if entry.parse_error is not None:
                    parse_errors.append(entry.parse_error)
                suppressed += entry.suppressed
                if entry.summary is not None:
                    summaries.append(entry.summary)
                suppressions[rel] = SuppressionIndex.from_dict(
                    entry.suppressions
                )
                continue
        parsed += 1
        unit = _build_unit(rel, source)
        if isinstance(unit, Finding):
            parse_errors.append(unit)
            if cache is not None:
                cache.store(
                    rel,
                    FileEntry(
                        sha=sha,
                        findings=[],
                        parse_error=unit,
                        suppressed=0,
                        summary=None,
                        suppressions={},
                    ),
                )
            continue
        kept, n_suppressed = _run_rules(unit)
        findings.extend(kept)
        suppressed += n_suppressed
        summary = summarize_module(rel, unit.tree, unit.tags, source_lines=unit.lines)
        summaries.append(summary)
        suppressions[rel] = unit.suppressions
        if cache is not None:
            cache.store(
                rel,
                FileEntry(
                    sha=sha,
                    findings=kept,
                    parse_error=None,
                    suppressed=n_suppressed,
                    summary=summary,
                    suppressions=unit.suppressions.to_dict(),
                ),
            )
    docs_path, docs_lines = _load_docs(root)
    if docs_path is not None:
        lines_by_path[docs_path] = docs_lines
    pkg_findings, pkg_suppressed = _run_package_rules(
        summaries, lines_by_path, suppressions, docs_path=docs_path
    )
    findings.extend(pkg_findings)
    suppressed += pkg_suppressed
    if cache is not None:
        cache.save(root=root)
    return AnalysisReport(
        findings=findings,
        files=files,
        suppressed=suppressed,
        duration_s=time.perf_counter() - t0,
        parse_errors=parse_errors,
        analyzed_paths=analyzed,
        parsed=parsed,
        cache_hits=cache.hits if cache is not None else 0,
    )
