"""SVOC015 — emission-taxonomy sync: docs/OBSERVABILITY.md ⇄ the code.

The observability contract is only useful if the taxonomy the docs
promise is the taxonomy the process emits: a dashboard built from a
documented-but-never-emitted series alerts on nothing, and an
undocumented event type is invisible to the replay tooling that keys
on the docs tables.  The reference's ``TestDocsInventory`` pinned this for
fault points; this rule generalizes it to the WHOLE taxonomy as a
two-way join:

- **code side** — every literal event type at an emission callsite
  (``emit_event(...)``, ``journal.emit(...)``, and wrapper forms like
  ``self._emit("supervisor.health", ...)`` — any ``*emit*`` leaf whose
  first argument is event-shaped) and every literal metric family at a
  registry callsite (``counter/gauge/histogram/timer``).  First
  positional args that are bare Names resolve through the module's
  string constants; anything else is skipped (under-approximate).
- **docs side** — the markdown tables of docs/OBSERVABILITY.md.  A
  table whose header row contains ``type`` and ``emitted`` is an event
  table; one whose first header cell is ``series`` is a series table.
  The FIRST cell's backticked tokens are the documented names.
- **join** — event types match exactly.  Series match against the
  Prometheus-rendered names (``utils/metrics.py``): a family ``f``
  may be documented as ``svoc_f``, ``svoc_f_total`` (counter render),
  ``svoc_f_seconds`` / ``svoc_f_seconds_max`` (timer render); the
  ``svoc_`` prefix and ``{label=...}`` suffixes are stripped before
  matching.

Both directions fail the lint: emitted-but-undocumented anchors at the
first emission site, documented-but-unemitted anchors at the docs
table row.  The documented-but-unemitted direction only runs when the
analyzed set contains the journal AND metrics modules — a subset run
(one file, ``--changed``) cannot prove an absence.

The port's copy of :mod:`svoc_tpu.analysis.emissions` (``emissions.py:1-249``),
unchanged but for the package's name. It reads the reference's
``docs/OBSERVABILITY.md`` in place, read-only: the port's events and
metric families are meant to be the reference's.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from svoc_torch.analysis.callgraph import (
    _EVENT_TYPE_RE,
    Program,
    is_emit_callsite,
)
from svoc_torch.analysis.findings import Finding

#: Metric-registry constructor leaves (utils/metrics.py surface).
METRIC_LEAVES = {"counter", "gauge", "histogram", "timer"}

#: The canonical docs path, relative to the analysis root.
OBSERVABILITY_DOC = "docs/OBSERVABILITY.md"

#: Modules whose presence marks the analyzed set as "whole package"
#: for the documented-but-unemitted direction.
_COMPLETENESS_SUFFIXES = ("utils/events.py", "utils/metrics.py")

_BACKTICK_RE = re.compile(r"`([^`]+)`")


def _norm_doc_series(token: str) -> str:
    """``svoc_sse_frames_dropped{stream="journal"}`` -> ``sse_frames_dropped``."""
    token = token.split("{", 1)[0].strip()
    if token.startswith("svoc_"):
        token = token[len("svoc_"):]
    return token


def parse_observability_tables(
    lines: List[str],
) -> Tuple[Dict[str, int], Dict[str, int]]:
    """``(event type -> first doc line, normalized series -> first doc
    line)`` from the markdown tables (prose backticks do NOT count —
    a mention is not documentation)."""
    doc_events: Dict[str, int] = {}
    doc_series: Dict[str, int] = {}
    mode = None
    for lineno, raw in enumerate(lines, 1):
        text = raw.strip()
        if not text.startswith("|"):
            mode = None
            continue
        # markdown escapes a literal pipe inside a cell as ``\|``
        # (``{event=hit\|miss}``) — protect it across the cell split
        text = text.replace("\\|", "\x00")
        cells = [
            c.replace("\x00", "|").strip()
            for c in text.strip("|").split("|")
        ]
        if not cells:
            continue
        if all(set(c) <= set("-: ") for c in cells):
            continue  # the |---|---| separator row
        lowered = [c.lower() for c in cells]
        if "type" in lowered and any("emitted" in c for c in lowered):
            mode = "events"
            continue
        if lowered[0] == "series":
            mode = "series"
            continue
        if mode is None:
            continue
        for token in _BACKTICK_RE.findall(cells[0]):
            if mode == "events":
                doc_events.setdefault(token, lineno)
            else:
                doc_series.setdefault(_norm_doc_series(token), lineno)
    return doc_events, doc_series


def collect_emissions(
    program: Program,
) -> Tuple[Dict[str, List[Tuple[str, int]]], Dict[str, List[Tuple[str, int]]]]:
    """``(event type -> sites, metric family -> sites)`` across the
    whole program, constants resolved, wrappers included."""
    events: Dict[str, List[Tuple[str, int]]] = {}
    families: Dict[str, List[Tuple[str, int]]] = {}
    for module in program.modules.values():
        for fs in module.functions:
            for call in fs.calls:
                arg0 = call.arg0
                if arg0 is None and call.arg0_name:
                    arg0 = module.consts.get(call.arg0_name)
                if not arg0:
                    continue
                site = (module.path, call.line)
                if is_emit_callsite(call.leaf, call.root, call.name, arg0) or (
                    "emit" in call.leaf and _EVENT_TYPE_RE.match(arg0)
                ):
                    events.setdefault(arg0, []).append(site)
                elif call.leaf in METRIC_LEAVES:
                    families.setdefault(arg0, []).append(site)
    return events, families


def _rendered_names(family: str) -> Tuple[str, ...]:
    """Every Prometheus name utils/metrics.py can render ``family``
    under, svoc_ prefix already stripped on the docs side."""
    return (
        family,
        family + "_total",
        family + "_seconds",
        family + "_seconds_max",
    )


def rule_svoc015(program: Program, ctx) -> List[Finding]:
    docs_path = getattr(ctx, "docs_path", None)
    if docs_path is None:
        return []
    doc_lines = ctx.lines(docs_path)
    if not doc_lines:
        return []
    doc_events, doc_series = parse_observability_tables(doc_lines)
    events, families = collect_emissions(program)
    out: List[Finding] = []

    # code -> docs: every emitted name must be in a table
    rendered_index: Dict[str, str] = {}
    for family in families:
        for name in _rendered_names(family):
            rendered_index.setdefault(name, family)
    for etype, sites in sorted(events.items()):
        if etype in doc_events:
            continue
        path, line = sites[0]
        out.append(
            ctx.finding(
                "SVOC015",
                path,
                line,
                f"event type `{etype}` is emitted here but absent from "
                f"{docs_path}'s event-taxonomy table — replay tooling "
                "and dashboards key on that table",
                "add a `| type | emitted by | data |` row for it (or fix "
                "the typo in the literal)",
                trace=(
                    f"{path}:{line} emits `{etype}`",
                    f"{docs_path} event table has no such row",
                ),
            )
        )
    for family, sites in sorted(families.items()):
        if any(name in doc_series for name in _rendered_names(family)):
            continue
        path, line = sites[0]
        out.append(
            ctx.finding(
                "SVOC015",
                path,
                line,
                f"metric family `{family}` is registered here but "
                f"absent from {docs_path}'s series tables (looked for "
                f"`svoc_{family}` and its _total/_seconds renders)",
                "add a `| series | type | meaning |` row to the series "
                "catalogue (docs/OBSERVABILITY.md §series)",
                trace=(
                    f"{path}:{line} registers family `{family}`",
                    f"{docs_path} series tables have no such row",
                ),
            )
        )

    # docs -> code: only meaningful over the whole package
    complete = all(
        any(m.path.endswith(suffix) for m in program.modules.values())
        for suffix in _COMPLETENESS_SUFFIXES
    )
    if complete:
        for etype, lineno in sorted(doc_events.items()):
            if etype in events:
                continue
            out.append(
                ctx.finding(
                    "SVOC015",
                    docs_path,
                    lineno,
                    f"documented event type `{etype}` is never emitted "
                    "by the analyzed package — the taxonomy row is a "
                    "promise nothing keeps",
                    "emit it or delete the row (documented-but-never-"
                    "emitted rows rot dashboards and replay tooling)",
                    trace=(
                        f"{docs_path}:{lineno} documents `{etype}`",
                        "no emission site found in the analyzed set",
                    ),
                )
            )
        for series, lineno in sorted(doc_series.items()):
            if series in rendered_index:
                continue
            out.append(
                ctx.finding(
                    "SVOC015",
                    docs_path,
                    lineno,
                    f"documented series `svoc_{series}` matches no "
                    "registered metric family in the analyzed package",
                    "register the family or delete the row; combined "
                    "shorthand rows (`` `x` / `_suffix` ``) must be "
                    "written out as full names",
                    trace=(
                        f"{docs_path}:{lineno} documents `svoc_{series}`",
                        "no counter/gauge/histogram/timer call registers "
                        "a matching family",
                    ),
                )
            )
    return out
