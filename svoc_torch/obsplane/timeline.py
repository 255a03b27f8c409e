"""Per-request latency decomposition and the observation channel.

Mirrors :mod:`svoc_tpu.obsplane.timeline` (``timeline.py:1-252``), the
whole module, over the port's shared event writer
(:mod:`svoc_torch.utils.events`).

- :class:`ObservationLog` is the **observation channel**: ``"obs"``-keyed
  JSONL lines in the same flight-recorder file as the spans (keyed
  ``"name"``) and the journal's events (keyed ``"event"``), plus a
  bounded in-memory ring.  Observation records never enter the
  :class:`~svoc_torch.utils.events.EventJournal`: its fingerprint digests
  every record with its seq, so a timeline record there would shift the
  seqs and break the identity of seeded runs with the cost plane on and
  off.  ``read_trace_events`` keeps only ``"event"`` lines, so recovery
  never sees this channel either.
- :class:`RequestTimeline` holds ordered marks on ONE clock (the serving
  tier's: virtual in seeded scenarios, monotonic live) along a request's
  path: admitted → assembled → vectorized → h2d → dispatched → synced →
  committed → completed.  A stage is the difference of consecutive
  present marks, so the stages sum exactly to the end-to-end latency.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from svoc_torch.utils.events import release_writer, shared_writer

#: Canonical mark order.  A timeline may skip marks (a deferred claim has
#: no commit that step); the stage between two present neighbours is
#: named after the later mark.
MARKS = (
    "admitted",
    "assembled",
    "vectorized",
    "h2d",
    "dispatched",
    "synced",
    "committed",
    "completed",
)

#: mark → the stage that ENDS at it; ``admitted`` starts the clock.
STAGE_OF_MARK = {
    "assembled": "queue_wait",
    "vectorized": "vectorize",
    "h2d": "h2d",
    "dispatched": "dispatch",
    "synced": "sync",
    "committed": "commit",
    "completed": "respond",
}

_MARK_ORDER = {name: i for i, name in enumerate(MARKS)}


class RequestTimeline:
    """Marks along one serving request's path, all on one clock."""

    __slots__ = ("lineage", "claim", "marks")

    def __init__(self, lineage: str, claim: str, t_submit: float):
        self.lineage = lineage
        self.claim = claim
        self.marks: List[Tuple[str, float]] = [("admitted", t_submit)]

    def mark(self, name: str, t: float) -> None:
        """Record one mark; a second mark of the same name is ignored
        (the first crossing wins)."""
        if name not in _MARK_ORDER:
            raise ValueError(f"unknown timeline mark {name!r}")
        if any(existing == name for existing, _ in self.marks):
            return
        self.marks.append((name, t))

    def extend(self, marks) -> None:
        """Merge ``(name, t)`` marks collected elsewhere (the router's
        per-claim dispatch marks)."""
        for name, t in marks:
            self.mark(name, t)

    def _ordered(self) -> List[Tuple[str, float]]:
        return sorted(self.marks, key=lambda m: _MARK_ORDER[m[0]])

    def stages(self) -> Dict[str, float]:
        """Stage durations between consecutive present marks, in mark
        order, never negative (a claim mark taken before this request's
        own mark on a live clock clamps to 0)."""
        ordered = self._ordered()
        return {
            STAGE_OF_MARK[name]: max(0.0, t - t_prev)
            for (_prev, t_prev), (name, t) in zip(ordered, ordered[1:])
        }

    def e2e_s(self) -> float:
        ordered = self._ordered()
        return max(0.0, ordered[-1][1] - ordered[0][1])


class ObservationLog:
    """Bounded ring plus an ``"obs"``-keyed JSONL sidecar for derived
    telemetry (timelines, cost samples).  Its seq counter is its own:
    observation seqs never interleave with the journal's.  A write error
    latches (no error per record after the first), counts
    ``trace_write_errors`` and, with an ``owner``, every record it
    silences under ``obs_lines_dropped{replica=owner}``."""

    def __init__(
        self,
        *,
        max_records: int = 4096,
        trace_path: Optional[str] = None,
        metrics=None,
        owner: Optional[str] = None,
    ):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max_records)
        self._seq = 0
        self._writer = None
        self._trace_path: Optional[str] = None
        self._write_error_latched = False
        self._metrics = metrics
        self._owner = owner
        self._dropped = 0
        if trace_path:
            self.set_trace_file(trace_path)

    def set_trace_file(self, path: Optional[str]) -> None:
        with self._lock:
            old = self._trace_path
            self._trace_path = path
            self._writer = shared_writer(path) if path else None
            self._write_error_latched = False
        if old and old != path:
            release_writer(old)

    def record(self, kind: str, *, lineage: Optional[str] = None, **data) -> dict:
        """Append one observation; the JSONL write happens outside the
        lock."""
        with self._lock:
            self._seq += 1
            rec = {"obs": kind, "seq": self._seq, "lineage": lineage, "data": data}
            self._ring.append(rec)
            writer = self._writer
            latched = self._write_error_latched
        if writer is not None and not latched:
            try:
                writer.write_line(json.dumps(rec, sort_keys=True))
            except OSError:
                from svoc_torch.utils.metrics import registry as _metrics

                _metrics.counter("trace_write_errors").add(1)
                with self._lock:
                    self._write_error_latched = True
                self._count_dropped()
        elif writer is not None:
            self._count_dropped()
        return rec

    def _count_dropped(self) -> None:
        with self._lock:
            self._dropped += 1
        if self._owner is not None and self._metrics is not None:
            self._metrics.counter("obs_lines_dropped", labels={"replica": self._owner}).add(1)

    def last_seq(self) -> int:
        """The newest observation seq (a sidecar whose tail lags it was
        cut short)."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        """Records that never reached the sidecar (the write-error latch)."""
        with self._lock:
            return self._dropped

    @property
    def write_error_latched(self) -> bool:
        with self._lock:
            return self._write_error_latched

    def recent(
        self, n: int = 50, *, kind: Optional[str] = None, lineage: Optional[str] = None
    ) -> List[dict]:
        with self._lock:
            records = list(self._ring)
        if kind is not None:
            records = [r for r in records if r["obs"] == kind]
        if lineage is not None:
            records = [r for r in records if r["lineage"] == lineage]
        return records[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def read_observations(path: str, keep: Optional[int] = None) -> List[dict]:
    """Every ``"obs"``-keyed line across the rotated segment chain of
    ``path`` (``keep`` segments, 8 when None), oldest first, tolerating a
    torn final line."""
    keep = keep if keep is not None else 8
    out: List[dict] = []
    for segment in [f"{path}.{i}" for i in range(keep, 0, -1)] + [path]:
        if not os.path.exists(segment):
            continue
        with open(segment, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # the torn tail of a crashed writer
                if isinstance(rec, dict) and "obs" in rec:
                    out.append(rec)
    return out
