"""Cross-replica hop-chain trace propagation.

Mirrors :mod:`svoc_tpu.obsplane.hopchain` (``hopchain.py:1-178``):
``HOP_REASONS``, :class:`HopContext`, :func:`join_hop_chains` and
:func:`chain_stats`, line for line (pure Python, no device work).

A request that enters the fleet through :meth:`ClusterRouter.submit`
leaves half its story on the router (redirect/shed/forward decisions)
and half on the owning replica (admission, serving, completion).  The
hop chain stitches the halves back together: every routing decision
mints a :class:`HopContext` carrying a fleet-unique ``chain`` id, and
the fleet plane records one ``"hop"`` observation on EACH side of the
hop — a ``send`` record on the origin's observation sidecar before the
transport call, a ``recv`` record on the destination's sidecar after
it lands, and a terminal ``end`` record on the origin for every typed
refusal (redirect, reconfig-defer, shed, quarantine).

The records ride the ``obs`` channel ONLY (the third line shape —
:class:`~svoc_torch.obsplane.timeline.ObservationLog`), never the
fingerprinted journal ring: hop telemetry must not shift journal seqs,
or the fleet-plane ON/OFF byte-identity the fleet-obs smoke
(:mod:`svoc_torch.tools.fleet_obs_smoke`) certifies would break.  That one-sidedness is also what makes the join
diagnostic: a ``send`` with no matching ``recv`` and no terminal is a
request that **died mid-hop** (the transport call was cut down between
the two records — an injected fault, a replica death mid-call), which
is precisely the evidence a journal-only view cannot show, because the
dead side never journaled anything.

:func:`join_hop_chains` is the offline join — the smoke builds
per-chain causal timelines from the per-source sidecar files with it.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

#: The routing decisions a hop chain can carry.
HOP_REASONS = (
    "forward",
    "redirect",
    "migrate",
    "failover",
    "reconfig-defer",
)

#: Record ordering inside one chain: each attempt's ``send`` precedes
#: its ``recv``; a terminal ``end`` sorts last at its hop.
_SIDE_ORDER = {"send": 0, "recv": 1, "end": 2}


class HopContext:
    """One routed request's hop state: the fleet-unique chain id, the
    claim lineage it joins under, the endpoints, the typed reason, and
    a monotone hop (attempt) sequence — ``hop`` increments per
    transport attempt, so a retried forward leaves attempt 1's
    unanswered ``send`` as evidence while attempt 2 completes."""

    __slots__ = ("chain", "claim", "lineage", "origin", "target", "reason", "hop")

    def __init__(
        self,
        chain: str,
        claim: str,
        lineage: str,
        origin: str,
        target: Optional[str],
        reason: str,
    ):
        if reason not in HOP_REASONS:
            raise ValueError(f"unknown hop reason {reason!r}")
        self.chain = chain
        self.claim = claim
        self.lineage = lineage
        self.origin = origin
        self.target = target
        self.reason = reason
        self.hop = 0

    def as_data(self) -> Dict[str, object]:
        """The invariant half of every record this chain emits."""
        return {
            "chain": self.chain,
            "claim": self.claim,
            "src": self.origin,
            "dst": self.target,
            "reason": self.reason,
        }


def join_hop_chains(records: Iterable[dict]) -> Dict[str, Dict[str, object]]:
    """Join ``"hop"`` observation records (from ANY number of per-source
    sidecar files) into per-chain causal timelines.

    Returns ``{chain_id: chain}`` where each chain carries its claim,
    lineage, reason, endpoints, the records sorted into causal order,
    the per-attempt fate, and a three-way classification:

    - ``complete`` — a ``recv`` landed on the destination: the request
      (or migration slice) arrived.  Earlier unanswered ``send``
      attempts are listed in ``dead_attempts`` (a retried transport
      fault).
    - ``terminal`` — no ``recv``, but a typed ``end`` record closed the
      chain (redirect, reconfig-defer, shed, quarantine); ``outcome``
      carries the type.
    - ``died_mid_hop`` — a ``send`` with neither a ``recv`` nor a
      terminal: the request was cut down between the two sides of the
      hop and no surviving process accounted for it.
    """
    chains: Dict[str, Dict[str, object]] = {}
    for rec in records:
        if rec.get("obs") != "hop":
            continue
        data = rec.get("data", {})
        chain_id = data.get("chain")
        if not chain_id:
            continue
        chain = chains.setdefault(
            chain_id,
            {
                "chain": chain_id,
                "claim": data.get("claim"),
                "lineage": rec.get("lineage"),
                "reason": data.get("reason"),
                "src": data.get("src"),
                "dst": data.get("dst"),
                "records": [],
            },
        )
        chain["records"].append(rec)
    for chain in chains.values():
        recs: List[dict] = chain["records"]
        recs.sort(
            key=lambda r: (
                r["data"].get("hop", 0),
                _SIDE_ORDER.get(r["data"].get("side"), 3),
            )
        )
        sends = {
            r["data"]["hop"] for r in recs if r["data"].get("side") == "send"
        }
        recvs = {
            r["data"]["hop"] for r in recs if r["data"].get("side") == "recv"
        }
        ends = [r for r in recs if r["data"].get("side") == "end"]
        chain["attempts"] = len(sends)
        chain["dead_attempts"] = sorted(sends - recvs)
        if recvs:
            chain["classification"] = "complete"
            chain["outcome"] = "delivered"
        elif ends:
            chain["classification"] = "terminal"
            chain["outcome"] = ends[-1]["data"].get("outcome", "unknown")
        else:
            chain["classification"] = "died_mid_hop"
            chain["outcome"] = "lost"
    return chains


def chain_stats(chains: Dict[str, Dict[str, object]]) -> Dict[str, object]:
    """Roll-up for the smoke gate and ``obs_query --fleet``'s footer:
    classification counts, per-reason counts, and the total number of
    unanswered send attempts (retried transport faults + mid-hop
    deaths — both are evidence, not noise)."""
    by_class: Dict[str, int] = {}
    by_reason: Dict[str, int] = {}
    dead_attempts = 0
    for chain in chains.values():
        by_class[chain["classification"]] = (
            by_class.get(chain["classification"], 0) + 1
        )
        reason = chain.get("reason") or "unknown"
        by_reason[reason] = by_reason.get(reason, 0) + 1
        dead_attempts += len(chain["dead_attempts"])
    return {
        "chains": len(chains),
        "by_classification": dict(sorted(by_class.items())),
        "by_reason": dict(sorted(by_reason.items())),
        "dead_attempts": dead_attempts,
    }
