"""SARIF 2.1.0 export — svoclint findings for editor/CI ingestion.

GitHub code scanning, VS Code's SARIF viewer, and most CI annotators
speak `SARIF 2.1.0
<https://docs.oasis-open.org/sarif/sarif/v2.1.0/sarif-v2.1.0.html>`_;
emitting it makes every svoclint finding a first-class annotation
instead of a log line someone has to grep.  The mapping:

- each rule in :data:`~svoc_torch.analysis.rules.RULE_DOCS` becomes a
  ``tool.driver.rules`` entry (id, name, summary, default level);
- each finding becomes a ``result`` — ``ruleId``, ``level``
  (``error``/``warning``, straight from the rule's severity),
  ``message`` (the finding message, hint appended), and one
  ``location`` at the anchor line/column;
- a finding's ``path_trace`` (the interprocedural call chain that
  justifies it) becomes ``relatedLocations``, one per hop IN ORDER —
  hops that lead with a ``path:line`` anchor get a physical location,
  purely narrative hops (``"docs table has no such row"``) carry just
  their message.  Viewers render these as the "trace" panel, which is
  exactly what they are.

Only NEW findings are exported — baselined and suppressed ones are
accepted debt and would bury the signal under 6 permanent annotations.

The writer lives here (not in tools/svoclint.py) so tests exercise the
document shape without a subprocess; the CLI's ``--sarif <path>`` flag
is a thin wrapper.  No JAX import, same as the whole analysis package.

The port's copy of :mod:`svoc_tpu.analysis.sarif` (``sarif.py:1-148``),
unchanged but for the package's name. The tool's name stays ``svoclint``, so the SARIF
documents of both analyzers over the same findings are equal.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List

from svoc_torch.analysis.findings import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"

#: The ``path:line`` anchor trace hops carry, in any of the repo's
#: forms: leading (``"fabric/router.py:887 emits ..."``), qualified
#: (``"fabric/router.py::ClaimRouter.step:887 silent handler"``), or
#: embedded (``"journal emit \`x()\` at fabric/router.py:887"``).
#: Anchored paths never contain spaces (repo-relative posix), so
#: ``\S`` is exact; the FIRST anchor in the hop wins.
_HOP_ANCHOR_RE = re.compile(
    r"(?P<path>\S+?\.py)(?:::(?P<qual>[^\s:]+))?:(?P<line>\d+)\b"
)


def _location(path: str, line: int, col: int = 1, message: str = "") -> Dict:
    loc: Dict = {
        "physicalLocation": {
            "artifactLocation": {"uri": path, "uriBaseId": "SRCROOT"},
            "region": {"startLine": line, "startColumn": max(col, 1)},
        }
    }
    if message:
        loc["message"] = {"text": message}
    return loc


def _related_locations(finding: Finding) -> List[Dict]:
    out: List[Dict] = []
    for hop in finding.path_trace:
        m = _HOP_ANCHOR_RE.search(hop)
        if m:
            # full hop text as the message: the qual/narrative part is
            # the context a trace panel should show next to the jump
            out.append(
                _location(m.group("path"), int(m.group("line")), message=hop)
            )
        else:
            # narrative hop — no physical anchor, message only (legal
            # SARIF: every field of `location` is optional)
            out.append({"message": {"text": hop}})
    return out


def _rule_descriptors(rule_docs: Dict[str, Dict[str, str]]) -> List[Dict]:
    rules = []
    for rule_id in sorted(rule_docs):
        doc = rule_docs[rule_id]
        rules.append(
            {
                "id": rule_id,
                "name": doc.get("name", rule_id),
                "shortDescription": {"text": doc.get("summary", rule_id)},
                "helpUri": "docs/STATIC_ANALYSIS.md",
                "defaultConfiguration": {
                    "level": doc.get("severity", "warning")
                },
            }
        )
    return rules


def to_sarif(
    findings: Iterable[Finding],
    rule_docs: Dict[str, Dict[str, str]],
    root: str = "",
) -> Dict:
    """The SARIF 2.1.0 document (as a dict) for ``findings``."""
    results = []
    for f in findings:
        message = f.message if not f.hint else f"{f.message}  hint: {f.hint}"
        result: Dict = {
            "ruleId": f.rule,
            "level": f.severity if f.severity in ("error", "warning") else "warning",
            "message": {"text": message},
            "locations": [_location(f.path, f.line, f.col)],
        }
        related = _related_locations(f)
        if related:
            result["relatedLocations"] = related
        results.append(result)
    run: Dict = {
        "tool": {
            "driver": {
                "name": "svoclint",
                "informationUri": "docs/STATIC_ANALYSIS.md",
                "rules": _rule_descriptors(rule_docs),
            }
        },
        "results": results,
    }
    if root:
        # forward slashes + trailing slash per the SARIF uri grammar
        uri = "file:///" + root.replace("\\", "/").strip("/") + "/"
        run["originalUriBaseIds"] = {"SRCROOT": {"uri": uri}}
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [run],
    }


def write_sarif(
    path: str,
    findings: Iterable[Finding],
    rule_docs: Dict[str, Dict[str, str]],
    root: str = "",
) -> None:
    doc = to_sarif(findings, rule_docs, root=root)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")
