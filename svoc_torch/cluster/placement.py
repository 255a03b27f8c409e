"""Claim placement directory: the deterministic claim→replica map.

Mirrors :mod:`svoc_tpu.cluster.placement` (``placement.py:1-209``):
:class:`PlacementDirectory` and :class:`PlacementError`, line for line —
crc32 rendezvous hashing (``:44``), epoch bumps, the atomic
``placement.json`` and :meth:`PlacementDirectory.fingerprint` (pure
Python, no device work).

The cluster's routing plane is a pure function of three inputs — the
replica roster, the explicit assignment table, and the claim id — so
that every router instance (and every seeded replay) resolves the same
owner for the same claim without any coordination traffic:

- **explicit roster** — operator/migration assignments win outright
  (``assign``); this is how a migrated claim's new owner becomes
  authoritative.
- **rendezvous-hash fallback** — an unlisted claim maps to the replica
  maximizing ``crc32(f"{claim}|{replica}")`` (highest-random-weight
  hashing): adding or removing one replica moves only the claims that
  hashed to it, never reshuffles the fleet.  crc32 — not Python's
  salted ``hash()`` — keeps the map identical across processes and
  replays (the :func:`svoc_torch.sim.generators.claim_seed` discipline).

Every mutation bumps the monotone ``placement_epoch``.  Routers stamp
responses with the epoch they resolved under; a caller presenting a
stale epoch gets a typed redirect instead of a silent re-route
(the epoch/redirect protocol of :meth:`ClusterRouter.submit
<svoc_torch.cluster.router.ClusterRouter.submit>`).  The directory snapshot-persists as
atomic JSON and is fingerprint-relevant: the fleet fingerprint folds
:meth:`fingerprint` in, so a replay that made even one different
placement decision cannot produce an identical digest.

SVOC011 discipline: the roster, the explicit table, and the persistence
path are pinned at construction — nothing in the resolution path reads
the environment or re-derives configuration mid-run.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Any, Dict, List, Optional


class PlacementError(KeyError):
    """No replica can own the claim (empty roster, unknown replica)."""


def _hrw_score(claim_id: str, replica_id: str) -> int:
    """Highest-random-weight score — crc32 over the joined pair, the
    repo-wide deterministic keying primitive (never ``hash()``)."""
    return zlib.crc32(f"{claim_id}|{replica_id}".encode())


class PlacementDirectory:
    """The versioned claim→replica map (one per cluster)."""

    def __init__(
        self,
        replicas: List[str],
        *,
        explicit: Optional[Dict[str, str]] = None,
        epoch: int = 0,
        path: Optional[str] = None,
    ):
        self._lock = threading.Lock()
        self._replicas: List[str] = sorted(set(replicas))
        self._explicit: Dict[str, str] = dict(explicit or {})
        for claim, replica in self._explicit.items():
            if replica not in self._replicas:
                raise PlacementError(
                    f"explicit assignment {claim!r} -> {replica!r} names a "
                    f"replica outside the roster {self._replicas}"
                )
        self._epoch = int(epoch)
        #: Persistence target, pinned at construction (SVOC011) — every
        #: epoch bump re-persists so a restarted router resumes from
        #: the last decided placement, not from the hash defaults.
        self._path = path
        if self._path is not None and not os.path.exists(self._path):
            self.save()

    # -- resolution ----------------------------------------------------------

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def replicas(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def assignments(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._explicit)

    def owner(self, claim_id: str) -> str:
        """The replica that owns ``claim_id`` under the current epoch."""
        with self._lock:
            if not self._replicas:
                raise PlacementError("placement roster is empty")
            explicit = self._explicit.get(claim_id)
            if explicit is not None:
                return explicit
            # max() over the sorted roster: the (score, id) tie-break is
            # itself deterministic, so two routers can never disagree.
            return max(
                self._replicas, key=lambda rid: (_hrw_score(claim_id, rid), rid)
            )

    # -- mutation (every path bumps the epoch exactly once) ------------------

    def assign(self, claim_id: str, replica_id: str) -> int:
        """Pin ``claim_id`` to ``replica_id`` (the migration commit
        point); returns the new epoch."""
        with self._lock:
            if replica_id not in self._replicas:
                raise PlacementError(
                    f"cannot assign {claim_id!r} to unknown replica "
                    f"{replica_id!r}"
                )
            self._explicit[claim_id] = replica_id
            return self._bump_locked()

    def add_replica(self, replica_id: str) -> int:
        with self._lock:
            if replica_id in self._replicas:
                return self._epoch
            self._replicas = sorted(self._replicas + [replica_id])
            return self._bump_locked()

    def remove_replica(self, replica_id: str) -> int:
        """Drop a replica from the roster.  Explicit assignments that
        pointed at it are deleted — those claims fall back to the
        rendezvous hash over the survivors (the failover path assigns
        them explicitly BEFORE removing, so this fallback only decides
        for claims nobody migrated)."""
        with self._lock:
            if replica_id not in self._replicas:
                raise PlacementError(f"unknown replica {replica_id!r}")
            self._replicas = [r for r in self._replicas if r != replica_id]
            self._explicit = {
                c: r for c, r in self._explicit.items() if r != replica_id
            }
            return self._bump_locked()

    def _bump_locked(self) -> int:
        self._epoch += 1
        epoch = self._epoch
        if self._path is not None:
            self._save_locked()
        return epoch

    # -- persistence / identity ----------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "version": 1,
                "epoch": self._epoch,
                "replicas": list(self._replicas),
                "explicit": dict(sorted(self._explicit.items())),
            }

    @classmethod
    def from_dict(
        cls, payload: Dict[str, Any], *, path: Optional[str] = None
    ) -> "PlacementDirectory":
        return cls(
            list(payload.get("replicas", [])),
            explicit=dict(payload.get("explicit", {})),
            epoch=int(payload.get("epoch", 0)),
            path=path,
        )

    def save(self) -> None:
        with self._lock:
            self._save_locked()

    def _save_locked(self) -> None:
        if self._path is None:
            return
        payload = {
            "version": 1,
            "epoch": self._epoch,
            "replicas": list(self._replicas),
            "explicit": dict(sorted(self._explicit.items())),
        }
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)

    @classmethod
    def load(cls, path: str) -> "PlacementDirectory":
        with open(path) as f:
            payload = json.load(f)
        return cls.from_dict(payload, path=path)

    def fingerprint(self) -> str:
        """crc32 digest of the canonical placement content — folded
        into the fleet fingerprint, so two replays agree on it iff they
        made identical placement decisions in an identical order."""
        canonical = json.dumps(self.to_dict(), sort_keys=True)
        return f"{zlib.crc32(canonical.encode()):08x}"

    def snapshot(self) -> Dict[str, Any]:
        """The ``/api/state`` view."""
        payload = self.to_dict()
        payload["fingerprint"] = self.fingerprint()
        return payload
