"""Content-hash findings cache: warm ``make lint`` never re-parses.

``analyze_paths`` reads every file anyway (the bytes feed the hash),
but parsing + rule-walking dominates the cold cost.  The cache stores,
per file, everything the engine derives from the AST — the kept
per-module findings, the parse error (if any), the suppression index,
and the interprocedural :class:`ModuleSummary` — keyed by
``(RULESET_VERSION, sha256(source))``.  A warm run therefore:

- skips ``ast.parse`` and the per-module rules for unchanged files,
- still runs the package rules (SVOC008–017) fresh every time — they
  are cross-file by definition and consume only the cached summaries,
  which is exactly why summaries are JSON-serializable.

``RULESET_VERSION`` must be bumped whenever any rule, the summary
shape, or the suppression semantics change: a stale version invalidates
every entry at load (never per-entry surprises).  The file lives at
the repo root as ``.svoclint_torch_cache.json`` and is gitignored — it
is a derived artifact, like ``__pycache__``.

The port's copy of :mod:`svoc_tpu.analysis.cache` (``cache.py:1-191``);
its version string and file name are its own, because its SVOC001 and
SVOC017 tables differ from the reference's.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

from svoc_torch.analysis.callgraph import ModuleSummary
from svoc_torch.analysis.findings import Finding

#: Bump on ANY change to rules, summaries, or suppression handling.
#: (``-3-contract-1``: the SVOC013–017 contract plane widened the
#: summary shape — attrs/self_sets/excepts/specs/collectives/consts —
#: so every ``-2-`` entry must re-extract.)
RULESET_VERSION = "svoclint-3-contract-1-torch-1"

#: Not the reference's ``.svoclint_cache.json``: the two rule sets would
#: otherwise invalidate each other's entries at every load.
CACHE_BASENAME = ".svoclint_torch_cache.json"


def source_digest(source: str) -> str:
    return hashlib.sha256(source.encode("utf-8")).hexdigest()


def _finding_to_dict(f: Finding) -> Dict[str, Any]:
    return f.to_dict()


def _finding_from_dict(d: Dict[str, Any]) -> Finding:
    return Finding(
        rule=d["rule"],
        severity=d["severity"],
        path=d["path"],
        line=int(d["line"]),
        col=int(d.get("col", 0)),
        message=d.get("message", ""),
        hint=d.get("hint", ""),
        snippet=d.get("snippet", ""),
        context=d.get("context", ""),
        path_trace=tuple(d.get("path_trace", ())),
    )


class FileEntry:
    """One cached file's derived state."""

    def __init__(
        self,
        sha: str,
        findings: List[Finding],
        parse_error: Optional[Finding],
        suppressed: int,
        summary: Optional[ModuleSummary],
        suppressions: Dict[str, Any],
    ):
        self.sha = sha
        self.findings = findings
        self.parse_error = parse_error
        self.suppressed = suppressed
        self.summary = summary
        self.suppressions = suppressions

    def to_dict(self) -> Dict[str, Any]:
        return {
            "sha": self.sha,
            "findings": [_finding_to_dict(f) for f in self.findings],
            "parse_error": (
                _finding_to_dict(self.parse_error) if self.parse_error else None
            ),
            "suppressed": self.suppressed,
            "summary": self.summary.to_dict() if self.summary else None,
            "suppressions": self.suppressions,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FileEntry":
        return cls(
            sha=str(d.get("sha", "")),
            findings=[_finding_from_dict(x) for x in d.get("findings", ())],
            parse_error=(
                _finding_from_dict(d["parse_error"])
                if d.get("parse_error")
                else None
            ),
            suppressed=int(d.get("suppressed", 0)),
            summary=(
                ModuleSummary.from_dict(d["summary"])
                if d.get("summary")
                else None
            ),
            suppressions=dict(d.get("suppressions", {})),
        )


class FindingsCache:
    """Load/lookup/store; corrupt or version-mismatched files are
    treated as empty (a cache must never be able to fail a lint)."""

    def __init__(self, path: str):
        self.path = path
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._fresh: Dict[str, FileEntry] = {}
        self.hits = 0
        self.misses = 0
        try:
            with open(path, "r", encoding="utf-8") as fh:
                data = json.load(fh)
            if (
                isinstance(data, dict)
                and data.get("ruleset") == RULESET_VERSION
                and isinstance(data.get("entries"), dict)
            ):
                self._entries = data["entries"]
        except (OSError, ValueError):
            pass

    def lookup(self, rel_path: str, sha: str) -> Optional[FileEntry]:
        raw = self._entries.get(rel_path)
        if not isinstance(raw, dict) or raw.get("sha") != sha:
            self.misses += 1
            return None
        try:
            entry = FileEntry.from_dict(raw)
        except (KeyError, TypeError, ValueError):
            self.misses += 1
            return None
        self.hits += 1
        self._fresh[rel_path] = entry
        return entry

    def store(self, rel_path: str, entry: FileEntry) -> None:
        self._fresh[rel_path] = entry

    def save(self, root: Optional[str] = None) -> None:
        """Persist this run's entries MERGED over the previous ones: a
        subset run (``--changed``, a single-file lint) must not evict
        the full tree's warm entries.  Carried-over entries whose file
        no longer exists (deleted modules, dead tmp fixture paths) are
        pruned at save time, so the cache is bounded by the set of
        live files rather than growing with every path ever linted.
        Relative entry paths resolve against ``root`` (the analysis
        root the engine used) — falling back to the cache file's own
        directory only when no root is given."""
        base = root or os.path.dirname(os.path.abspath(self.path))

        def alive(rel: str) -> bool:
            full = rel if os.path.isabs(rel) else os.path.join(base, rel)
            return os.path.exists(full)

        entries = {
            p: e for p, e in self._entries.items()
            if p not in self._fresh and alive(p)
        }
        entries.update({p: e.to_dict() for p, e in self._fresh.items()})
        payload = {
            "comment": (
                "svoclint derived-state cache (content-hash keyed). "
                "Safe to delete at any time; gitignored."
            ),
            "ruleset": RULESET_VERSION,
            "entries": entries,
        }
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(payload, fh)
            os.replace(tmp, self.path)  # svoclint: disable=SVOC012
            # (no fsync: a torn cache self-heals on the next run — it is
            # a derived artifact, not a durability surface)
        except OSError:
            pass
