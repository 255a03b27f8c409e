"""svoclint over the port: ``svoc_torch``'s lint gate.

The port of ``tools/svoclint.py`` (the CLI of :mod:`svoc_tpu.analysis`),
over :mod:`svoc_torch.analysis`.  Usage::

    python -m svoc_torch.tools.svoclint                        # text report
    python -m svoc_torch.tools.svoclint --format json          # machine form
    python -m svoc_torch.tools.svoclint --changed              # pre-commit loop
    python -m svoc_torch.tools.svoclint --sarif out.sarif      # code scanning
    python -m svoc_torch.tools.svoclint svoc_torch --write-baseline
    python -m svoc_torch.tools.svoclint --list-rules

Exit codes: **0** clean (every finding fixed, suppressed, or baselined),
**1** non-baselined findings (or stale baseline entries — baselines only
shrink), **2** usage/internal error.  The default paths are the
repository's ``svoc_torch`` tree, the default baseline is
``svoc_torch/tools/svoclint_baseline.json`` (every entry carries a
``reason``), and the content-hash findings cache is
``.svoclint_torch_cache.json`` at the repository's root (gitignored; not
the reference's ``.svoclint_cache.json``, whose entries another rule set
wrote).  ``--changed`` lints only the files that differ from ``git
merge-base HEAD main`` (the full tree when git is unavailable);
``--sarif <path>`` also writes the NEW findings as a SARIF 2.1.0
document whose tool is ``svoclint``, as the reference's.

No JAX and no torch import anywhere on this path
(tests/test_torch_svoclint.py checks it in a subprocess).  Rules and the
suppression/baseline workflow are documented in
docs/STATIC_ANALYSIS.md.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from svoc_torch.analysis import (  # noqa: E402 (path bootstrap above)
    Baseline,
    RULE_DOCS,
    analyze_paths,
    suggest_rebase,
)
from svoc_torch.analysis.cache import CACHE_BASENAME  # noqa: E402

# Anchored to the repo (not the CWD): running the linter from another
# directory must still honor the checked-in baseline.
DEFAULT_BASELINE = os.path.join(
    REPO_ROOT, "svoc_torch", "tools", "svoclint_baseline.json"
)
DEFAULT_CACHE = os.path.join(REPO_ROOT, CACHE_BASENAME)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="svoclint", description=__doc__.splitlines()[0]
    )
    p.add_argument(
        "paths",
        nargs="*",
        # repo-anchored like DEFAULT_BASELINE: the bare invocation must
        # work from any CWD
        default=[os.path.join(REPO_ROOT, "svoc_torch")],
        help="files/directories to analyze (default: the repo's "
        "svoc_torch tree)",
    )
    p.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="report format (default: text)",
    )
    p.add_argument(
        "--baseline",
        default=None,
        help=f"baseline JSON path (default: {DEFAULT_BASELINE} when present)",
    )
    p.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore any baseline file (report every finding)",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="write all current findings to the baseline file and exit 0",
    )
    p.add_argument(
        "--changed",
        action="store_true",
        help="lint only files differing from `git merge-base HEAD main` "
        "(plus untracked), restricted to the given paths; falls back to "
        "the full tree when git is unavailable.  Stale baseline entries "
        "outside the changed subset are ignored (the full run owns them).",
    )
    p.add_argument(
        "--cache",
        default=DEFAULT_CACHE,
        help="findings-cache path (content-hash keyed; skips re-parsing "
        f"unchanged files; default: {DEFAULT_CACHE})",
    )
    p.add_argument(
        "--no-cache",
        action="store_true",
        help="disable the findings cache for this run",
    )
    p.add_argument(
        "--sarif",
        default=None,
        metavar="PATH",
        help="also write the NEW findings as a SARIF 2.1.0 document to "
        "PATH (path_trace hops become relatedLocations); baselined and "
        "suppressed findings are not exported",
    )
    p.add_argument(
        "--list-rules", action="store_true", help="print the rule table and exit"
    )
    p.add_argument(
        "--root",
        default=REPO_ROOT,
        help="path findings are reported relative to (default: the repo "
        "root, so baseline path keys are stable across CWDs)",
    )
    return p


def _list_rules() -> int:
    for rule_id in sorted(RULE_DOCS):
        doc = RULE_DOCS[rule_id]
        print(f"{rule_id}  {doc['name']:32s} [{doc['severity']}] {doc['summary']}")
    return 0


def _git_changed_files(root: str):
    """Repo-root-relative paths of ``*.py`` files differing from the
    merge-base with main (ACMR) plus untracked files, or None when git
    (or the main ref) is unavailable — the caller falls back to the
    full tree, never to silence."""

    def run(cwd, *args):
        proc = subprocess.run(
            ["git", *args], capture_output=True, text=True, cwd=cwd,
            timeout=30,
        )
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr.strip() or "git failed")
        return proc.stdout

    try:
        # git reports diff paths relative to the TOPLEVEL, whatever cwd
        # the command ran from — resolve against it, not args.root, or
        # a non-toplevel --root silently drops every tracked change.
        top = run(root, "rev-parse", "--show-toplevel").strip()
        base = run(top, "merge-base", "HEAD", "main").strip()
        diff = run(
            top, "diff", "--name-only", "--diff-filter=ACMR", base,
            "--", "*.py",
        )
        untracked = run(
            top, "ls-files", "--others", "--exclude-standard", "--", "*.py"
        )
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    files = [l.strip() for l in (diff + untracked).splitlines() if l.strip()]
    return sorted(os.path.join(top, f) for f in set(files))


def _restrict_to_changed(paths, root):
    """``(files, fell_back)``: the changed files under ``paths``, or
    the original paths when git is unavailable."""
    changed = _git_changed_files(root)
    if changed is None:
        print(
            "svoclint: --changed requested but git/main unavailable — "
            "linting the full tree",
            file=sys.stderr,
        )
        return list(paths), True
    roots = [os.path.abspath(p) for p in paths]
    out = []
    for full in changed:  # already absolute (toplevel-joined)
        if not os.path.exists(full):
            continue  # deleted files have nothing to lint
        for r in roots:
            if full == r or full.startswith(r + os.sep):
                out.append(full)
                break
    return out, False


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        return _list_rules()

    for path in args.paths:
        if not os.path.exists(path):
            print(f"svoclint: path does not exist: {path}", file=sys.stderr)
            return 2

    paths = list(args.paths)
    changed_subset = False
    if args.changed:
        paths, fell_back = _restrict_to_changed(paths, args.root)
        changed_subset = not fell_back
        if changed_subset and not paths:
            print("svoclint: clean — no changed python files under the "
                  "given paths")
            return 0

    cache_path = None if args.no_cache else args.cache
    report = analyze_paths(paths, root=args.root, cache_path=cache_path)
    findings = report.all_findings

    baseline_path = args.baseline or (
        DEFAULT_BASELINE if os.path.exists(DEFAULT_BASELINE) else None
    )

    if args.write_baseline:
        out_path = args.baseline or DEFAULT_BASELINE
        # Never grandfather SVOC000: a file the linter cannot parse is
        # analyzed by NO rule, and baselining that would turn "CI must
        # fail loudly" (engine.py) into a permanent silent skip.
        writable = [f for f in findings if f.rule != "SVOC000"]
        skipped = len(findings) - len(writable)
        # Regenerating must not clobber the rest of the baseline: carry
        # curated reasons forward for keys that still match, and keep
        # entries VERBATIM for files outside the analyzed subset (a
        # `--write-baseline` over one tree must not drop another
        # tree's grandfathered entries).
        analyzed = set(report.analyzed_paths)
        old_reasons = {}
        kept_entries = []
        if os.path.exists(out_path):
            try:
                for e in Baseline.load(out_path).entries:
                    if e.get("path") not in analyzed:
                        kept_entries.append(e)
                        continue
                    key = (
                        str(e.get("rule", "")),
                        str(e.get("path", "")),
                        str(e.get("snippet", "")),
                        str(e.get("context", "")),
                    )
                    old_reasons.setdefault(key, e.get("reason", ""))
            except (OSError, ValueError):
                pass
        merged = Baseline()
        for e in kept_entries:
            merged.add(e)
        for f in writable:
            merged.add(
                {
                    "rule": f.rule,
                    "path": f.path,
                    "snippet": f.snippet,
                    "context": f.context,
                    "reason": old_reasons.get(f.baseline_key())
                    or "grandfathered by --write-baseline; triage me",
                }
            )
        merged.dump(out_path)
        print(
            f"svoclint: wrote {len(writable)} finding(s) "
            f"(+{len(kept_entries)} kept for unanalyzed paths) to "
            f"{out_path} ({report.files} files, {report.duration_s:.2f}s)"
        )
        if skipped:
            print(
                f"svoclint: refused to baseline {skipped} SVOC000 "
                "parse-error finding(s) — fix the syntax errors",
                file=sys.stderr,
            )
            return 1
        return 0

    stale = []
    baselined = []
    if baseline_path and not args.no_baseline:
        try:
            baseline = Baseline.load(baseline_path)
        except (OSError, ValueError) as e:
            print(f"svoclint: bad baseline {baseline_path}: {e}", file=sys.stderr)
            return 2
        findings, baselined, stale = baseline.split(findings)
        if changed_subset:
            # A --changed run sees only a slice of the tree: entries
            # for files OUTSIDE the slice are not stale, they are
            # simply unobserved — the full run owns their lifecycle.
            analyzed = set(report.analyzed_paths)
            stale = [e for e in stale if e.get("path") in analyzed]

    # Stale-entry diagnostics: the grandfathered statement was usually
    # EDITED, not fixed — name the likely successor so the failure is
    # an actionable one-line rebase instead of an archaeology session.
    all_current = report.all_findings
    suggestions = {
        id(e): suggest_rebase(e, all_current) for e in stale
    }

    if args.sarif:
        from svoc_torch.analysis.sarif import write_sarif  # noqa: E402

        write_sarif(args.sarif, findings, RULE_DOCS, root=args.root)

    if args.format == "json":
        payload = {
            "findings": [f.to_dict() for f in findings],
            "counts": {
                "new": len(findings),
                "baselined": len(baselined),
                "suppressed": report.suppressed,
                "stale_baseline_entries": len(stale),
                "files": report.files,
                "parsed": report.parsed,
                "cache_hits": report.cache_hits,
            },
            "stale_baseline_entries": [
                dict(
                    e,
                    suggested_rebase=(
                        suggestions[id(e)].to_dict()
                        if suggestions[id(e)] is not None
                        else None
                    ),
                )
                for e in stale
            ],
            "duration_s": round(report.duration_s, 3),
        }
        print(json.dumps(payload, indent=2))
    else:
        for f in findings:
            print(f.render())
        for entry in stale:
            print(
                f"stale baseline entry (finding no longer present — remove "
                f"it): {entry['rule']} {entry['path']} | {entry['snippet']}"
            )
            hint = suggestions[id(entry)]
            if hint is not None:
                print(
                    f"    suggested rebase -> same rule+path at "
                    f"{hint.path}:{hint.line}: | {hint.snippet}\n"
                    "    (update the entry's snippet/context to match, "
                    "or fix the finding and delete the entry)"
                )
        status = "clean" if not findings and not stale else "FAILED"
        print(
            f"svoclint: {status} — {len(findings)} new, {len(baselined)} "
            f"baselined, {report.suppressed} suppressed, {len(stale)} stale "
            f"baseline entr{'y' if len(stale) == 1 else 'ies'} "
            f"({report.files} files, {report.parsed} parsed, "
            f"in {report.duration_s:.2f}s)"
        )

    return 1 if findings or stale else 0


if __name__ == "__main__":
    sys.exit(main())
