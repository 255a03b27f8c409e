"""Shape-keyed dispatch-cost ledger.

Mirrors :mod:`svoc_tpu.obsplane.ledger` (``ledger.py:1-238``), the
whole module.  The router keys every claim-cube dispatch by a
:class:`~svoc_torch.compile.universe.CompileKey` (its warmth
accounting); the ledger folds the measured host cost of each dispatch
into an EMA per ``(key, warmth)`` cell, so a scheduler can ask what a
warm ``sanitized:c4n7m6`` dispatch costs on this machine.

The cell id appends the impl and a crc32 of ``repr(cfg)`` to
``CompileKey.label()``::

    sanitized:c4n7m6|cuda|cfg#9d3a

Samples are ``time.perf_counter`` windows from the router: real host
seconds, independent of a scenario's virtual clock.  They reach no
fingerprint: the ledger lives outside the journal, and its
``cost.sample`` records ride the observation channel.  The EMA fold is
order-deterministic: replaying the same samples through
:meth:`CostLedger.observe_key_str` reproduces the cells exactly.

:class:`CostModel` is the read API: ``estimate(key)`` answers for every
key, falling back from the exact cell to the ``(n_oracles, dimension)``
group average to the global average, with the source named.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, Optional

#: EMA smoothing of the cost folds.
DEFAULT_ALPHA = 0.2

WARMTHS = ("cold", "prewarmed", "warm")


def ledger_key(key) -> str:
    """The ledger cell id of a CompileKey: ``label()`` plus the impl and
    a crc32 signature of the config it omits."""
    cfg_sig = zlib.crc32(repr(key.cfg).encode()) & 0xFFFF
    return f"{key.label()}|{key.impl}|cfg#{cfg_sig:04x}"


def group_key(key) -> str:
    """The fallback pool: keys that share (N, M)."""
    return f"n{key.n_oracles}m{key.dimension}"


class CostLedger:
    """EMA cost cells keyed ``ledger_key × warmth``; thread-safe."""

    def __init__(self, *, alpha: float = DEFAULT_ALPHA):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self._lock = threading.Lock()
        #: {key_str: {"group": str, "warmth": {w: {"ema_s", "samples"}}}}
        self._entries: Dict[str, dict] = {}

    def observe_key_str(self, key_str: str, group: str, warmth: str, seconds: float) -> None:
        """Fold one measured dispatch into its cell, by cell id (the
        offline reconstruction's path, from JSONL records)."""
        seconds = float(seconds)
        with self._lock:
            entry = self._entries.setdefault(key_str, {"group": group, "warmth": {}})
            cell = entry["warmth"].get(warmth)
            if cell is None:
                entry["warmth"][warmth] = {"ema_s": seconds, "samples": 1}
            else:
                cell["ema_s"] += self.alpha * (seconds - cell["ema_s"])
                cell["samples"] += 1

    def observe(self, key, warmth: str, seconds: float) -> str:
        """Fold one dispatch measured against its CompileKey; returns the
        cell id."""
        key_str = ledger_key(key)
        self.observe_key_str(key_str, group_key(key), warmth, seconds)
        return key_str

    def _copy_entries(self) -> Dict[str, dict]:
        with self._lock:
            return {
                k: {"group": e["group"], "warmth": {w: dict(c) for w, c in e["warmth"].items()}}
                for k, e in self._entries.items()
            }

    def to_dict(self) -> dict:
        """JSON-safe state."""
        return {"version": 1, "alpha": self.alpha, "entries": self._copy_entries()}

    def restore(self, payload: dict) -> int:
        """Load persisted cells; returns the count of cells held.  A
        payload without entries, or an entry without well-formed cells,
        is skipped, never raised on: the ledger is derived telemetry."""
        entries = (payload or {}).get("entries")
        if not isinstance(entries, dict):
            return 0
        cleaned: Dict[str, dict] = {}
        for key_str, entry in entries.items():
            warmth = entry.get("warmth") if isinstance(entry, dict) else None
            if not isinstance(warmth, dict):
                continue
            cells = {
                w: {"ema_s": float(c["ema_s"]), "samples": int(c["samples"])}
                for w, c in warmth.items()
                if isinstance(c, dict) and "ema_s" in c and "samples" in c
            }
            if cells:
                cleaned[key_str] = {"group": str(entry.get("group", "")), "warmth": cells}
        with self._lock:
            self._entries.update(cleaned)
            return len(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def summary(self) -> dict:
        with self._lock:
            samples = sum(c["samples"] for e in self._entries.values() for c in e["warmth"].values())
            return {"keys": len(self._entries), "samples": samples, "alpha": self.alpha}


class CostModel:
    """The read API over a :class:`CostLedger`.  An estimate names its
    source: ``exact`` (this key's cell), ``group`` (the (N, M) average),
    ``global`` (every cell's average), or None (nothing measured)."""

    def __init__(self, ledger: CostLedger):
        self.ledger = ledger

    @staticmethod
    def _warm_cold(cells: Dict[str, dict]) -> Dict[str, Optional[dict]]:
        """Warmth cells → the two regimes: warm (``prewarmed`` counts)
        and cold (first touch)."""
        return {"warm": cells.get("warm") or cells.get("prewarmed"), "cold": cells.get("cold")}

    def estimate(self, key) -> dict:
        """Warm and cold cost estimates for one CompileKey, each falling
        back on its own: exact cell → group average → global average."""
        key_str = ledger_key(key)
        group = group_key(key)
        entries = self.ledger._copy_entries()
        none = {"warm": None, "cold": None}
        exact = self._warm_cold(entries[key_str]["warmth"]) if key_str in entries else none

        def pool_average(pool) -> Dict[str, Optional[dict]]:
            sums = {"warm": [0.0, 0], "cold": [0.0, 0]}
            for entry in pool:
                for regime, cell in self._warm_cold(entry["warmth"]).items():
                    if cell is not None:
                        sums[regime][0] += cell["ema_s"]
                        sums[regime][1] += 1
            return {
                regime: ({"ema_s": total / n, "samples": n} if n else None)
                for regime, (total, n) in sums.items()
            }

        group_avg = pool_average(e for e in entries.values() if e["group"] == group)
        global_avg = pool_average(entries.values())
        out = {"key": key_str, "group": group}
        for regime in ("warm", "cold"):
            out[regime] = None
            for source, cell in (("exact", exact[regime]), ("group", group_avg[regime]),
                                 ("global", global_avg[regime])):
                if cell is not None:
                    out[regime] = {"seconds": cell["ema_s"], "source": source,
                                   "samples": cell["samples"]}
                    break
        return out
