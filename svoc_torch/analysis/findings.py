"""Finding records, inline suppressions, and the checked-in baseline.

Suppression syntax (same line as the finding)::

    x = np.asarray(v)  # svoclint: disable=SVOC001
    y = float(z)       # svoclint: disable=SVOC001,SVOC002 -- why
    z = risky()        # svoclint: disable=all

A whole file opts out of one rule with a module-level comment anywhere
in the file (conventionally right under the docstring)::

    # svoclint: disable-file=SVOC005

Baseline format (``svoc_torch/tools/svoclint_baseline.json``): findings are keyed
by ``(rule, path, stripped source line, stripped next line)`` — NOT by
line number, so unrelated edits moving a grandfathered line don't
invalidate the baseline, while editing the flagged statement itself
(the thing that could change its hazard) does; the next-line context
keeps a generic opener like ``jax.jit(`` from matching an unrelated
new finding in the same file.  Matching is multiset-consume: two
identical grandfathered statements need two entries, and a stale entry
(the finding was fixed) is reported so baselines only ever shrink.

The port's copy of :mod:`svoc_tpu.analysis.findings` (``findings.py:1-304``),
unchanged but for the package's name.
"""

from __future__ import annotations

import dataclasses
import io
import json
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Set, Tuple

SEVERITIES = ("error", "warning")

# Comma lists tolerate the natural human spacing ("SVOC001, SVOC002").
_DISABLE_RE = re.compile(
    r"#\s*svoclint:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
)
_DISABLE_FILE_RE = re.compile(
    r"#\s*svoclint:\s*disable-file=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
)
_TAG_RE = re.compile(
    r"#\s*svoclint:\s*tag=([A-Za-z0-9_-]+(?:\s*,\s*[A-Za-z0-9_-]+)*)"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One reported hazard: where, what, and how to fix it."""

    rule: str  # "SVOC001"
    severity: str  # "error" | "warning"
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    hint: str
    snippet: str = ""  # stripped source line (baseline key part)
    #: the stripped NEXT non-empty source line — disambiguates generic
    #: snippets (a bare ``jax.jit(`` opener) so a new finding elsewhere
    #: in the file can't silently consume a dead grandfather entry
    context: str = ""
    #: Interprocedural findings only (SVOC008–012): the call chain that
    #: justifies the finding, entry first, hazard last.  Empty for the
    #: per-module rules.  NOT part of the baseline key — a refactor of
    #: an intermediate hop must not orphan a grandfathered entry.
    path_trace: Tuple[str, ...] = ()

    def baseline_key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.snippet, self.context)

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["path_trace"] = list(self.path_trace)
        return d

    def render(self) -> str:
        text = (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"[{self.severity}] {self.message}"
        )
        if self.hint:
            text += f"\n    hint: {self.hint}"
        if self.snippet:
            text += f"\n    | {self.snippet}"
        for hop in self.path_trace:
            text += f"\n    via: {hop}"
        return text


class SuppressionIndex:
    """Per-file comment scan: inline disables, file disables, tags.

    Built from ``tokenize`` (not regex over raw source) so a disable
    string inside a string literal is not honored, and so the comment's
    *logical statement* can be resolved: a trailing disable on any
    physical line of a multi-line statement covers the statement's
    reported line.
    """

    def __init__(self, source: str):
        self.line_disables: Dict[int, Set[str]] = {}
        self.file_disables: Set[str] = set()
        self.tags: Set[str] = set()
        try:
            tokens = list(
                tokenize.generate_tokens(io.StringIO(source).readline)
            )
        except (tokenize.TokenError, IndentationError, SyntaxError):
            tokens = []
        # Track the first line of the current LOGICAL statement: a
        # trailing disable on the closing line of a multi-line call must
        # cover the statement's reported line (the first one).
        _passive = {
            tokenize.NL,
            tokenize.INDENT,
            tokenize.DEDENT,
            tokenize.COMMENT,
            tokenize.ENDMARKER,
        }
        logical_start: Optional[int] = None
        for tok in tokens:
            if tok.type == tokenize.NEWLINE:
                logical_start = None
            elif tok.type not in _passive and logical_start is None:
                logical_start = tok.start[0]
            if tok.type != tokenize.COMMENT:
                continue
            m = _DISABLE_FILE_RE.search(tok.string)
            if m:
                self.file_disables.update(
                    r.strip().upper() for r in m.group(1).split(",") if r.strip()
                )
            m = _TAG_RE.search(tok.string)
            if m:
                self.tags.update(
                    t.strip().lower() for t in m.group(1).split(",") if t.strip()
                )
            m = _DISABLE_RE.search(tok.string)
            if m and "disable-file" not in tok.string:
                rules = {
                    r.strip().upper() for r in m.group(1).split(",") if r.strip()
                }
                # Cover EVERY physical line of the logical statement up
                # to the comment: findings anchor at their node's own
                # lineno, which for a multi-line literal can be any
                # interior line.
                first = (
                    logical_start if logical_start is not None else tok.start[0]
                )
                for line in range(min(first, tok.start[0]), tok.start[0] + 1):
                    self.line_disables.setdefault(line, set()).update(rules)

    def is_suppressed(self, rule: str, line: int) -> bool:
        rule = rule.upper()
        if rule in self.file_disables or "ALL" in self.file_disables:
            return True
        rules = self.line_disables.get(line, ())
        return rule in rules or "ALL" in rules

    # -- cache round-trip (svoc_torch.analysis.cache) -------------------------

    def to_dict(self) -> Dict[str, object]:
        return {
            "lines": {
                str(k): sorted(v) for k, v in self.line_disables.items()
            },
            "file": sorted(self.file_disables),
            "tags": sorted(self.tags),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "SuppressionIndex":
        idx = cls.__new__(cls)
        idx.line_disables = {
            int(k): set(v) for k, v in dict(d.get("lines", {})).items()
        }
        idx.file_disables = set(d.get("file", ()))
        idx.tags = set(d.get("tags", ()))
        return idx


class Baseline:
    """The checked-in set of grandfathered findings."""

    VERSION = 1

    def __init__(self, entries: Optional[Iterable[Dict[str, str]]] = None):
        # multiset of (rule, path, snippet, context) -> remaining count
        self._counts: Dict[Tuple[str, str, str, str], int] = {}
        self.entries: List[Dict[str, str]] = []
        for e in entries or ():
            self.add(e)

    def add(self, entry: Dict[str, str]) -> None:
        key = (
            str(entry.get("rule", "")),
            str(entry.get("path", "")),
            str(entry.get("snippet", "")),
            str(entry.get("context", "")),
        )
        self.entries.append(dict(entry))
        self._counts[key] = self._counts.get(key, 0) + 1

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
        if isinstance(data, dict):
            entries = data.get("entries", [])
        else:  # bare list form
            entries = data
        return cls(entries)

    @classmethod
    def from_findings(
        cls, findings: Iterable[Finding], reason: str = ""
    ) -> "Baseline":
        bl = cls()
        for f in findings:
            bl.add(
                {
                    "rule": f.rule,
                    "path": f.path,
                    "snippet": f.snippet,
                    "context": f.context,
                    "reason": reason,
                }
            )
        return bl

    def dump(self, path: str) -> None:
        payload = {
            "version": self.VERSION,
            "comment": (
                "Grandfathered svoclint findings. Keyed by (rule, path, "
                "source line, next line) so line drift doesn't invalidate "
                "entries. Every entry needs a 'reason'; fix findings "
                "instead of adding entries whenever possible "
                "(docs/STATIC_ANALYSIS.md)."
            ),
            "entries": sorted(
                self.entries,
                key=lambda e: (e.get("path", ""), e.get("rule", ""), e.get("snippet", "")),
            ),
        }
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=False)
            fh.write("\n")

    def split(
        self, findings: List[Finding]
    ) -> Tuple[List[Finding], List[Finding], List[Dict[str, str]]]:
        """``(new, baselined, stale_entries)`` — consume matches so a
        baseline entry covers exactly one live finding."""
        remaining = dict(self._counts)
        new: List[Finding] = []
        matched: List[Finding] = []
        for f in findings:
            key = f.baseline_key()
            if remaining.get(key, 0) > 0:
                remaining[key] -= 1
                matched.append(f)
            else:
                new.append(f)
        stale: List[Dict[str, str]] = []
        for key, count in remaining.items():
            for _ in range(count):
                stale.append(
                    {
                        "rule": key[0],
                        "path": key[1],
                        "snippet": key[2],
                        "context": key[3],
                    }
                )
        return new, matched, stale


def suggest_rebase(
    stale_entry: Dict[str, str], findings: Iterable[Finding]
) -> Optional[Finding]:
    """The nearest CURRENT finding a stale baseline entry probably
    meant: same rule + path, closest snippet by similarity.  A stale
    entry usually means the grandfathered statement was *edited*, not
    fixed — naming the likely successor turns a bare failure into an
    actionable rebase ("update the entry's snippet/context to this").
    Returns None when nothing with the same rule+path exists (the
    finding really was fixed — delete the entry)."""
    import difflib

    rule = stale_entry.get("rule", "")
    path = stale_entry.get("path", "")
    old_snippet = stale_entry.get("snippet", "")
    candidates = [f for f in findings if f.rule == rule and f.path == path]
    if not candidates:
        return None
    return max(
        candidates,
        key=lambda f: difflib.SequenceMatcher(
            None, old_snippet, f.snippet
        ).ratio(),
    )
