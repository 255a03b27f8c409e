"""Crash-consistent durability: the guarantees of the resilience layer,
held across process death.

Mirrors :mod:`svoc_tpu.durability` (``durability/__init__.py:1-68``) and
exports what it exports:

- :mod:`~svoc_torch.durability.faultspace` — the named fault points and
  the armed controller the crash harness drives;
- :mod:`~svoc_torch.durability.wal` — the commit-intent write-ahead log
  (fsynced per-tx intent/landed records; exactly-once chain semantics);
- :mod:`~svoc_torch.durability.reconcile` — the restart reconciler that
  joins WAL intents against on-chain state and resumes only stranded
  slots;
- :mod:`~svoc_torch.durability.chainlog` — a crash-surviving tx log for
  the local chain simulator (the external-chain stand-in the
  kill/restart harness needs);
- :mod:`~svoc_torch.durability.recovery` — snapshot + journal-replay
  recovery manager and the SIGTERM graceful-drain handler;
- :mod:`~svoc_torch.durability.scenario` — the seeded kill/restart
  scenario behind :mod:`svoc_torch.tools.crash_smoke`;
- :mod:`~svoc_torch.durability.fuzz` — the seed-driven fault-space
  fuzzer behind :mod:`svoc_torch.tools.chaos_fuzz`.

The multi-replica fleet that fires the cluster and reconfiguration
points is :mod:`svoc_torch.cluster`.
"""

from svoc_torch.durability.chainlog import (
    DurableLocalBackend,
    duplicate_predictions,
    read_chain_log,
    replay_chain_log,
)
from svoc_torch.durability.faultspace import (
    FaultController,
    FaultEvent,
    declare,
    fault_point,
)
from svoc_torch.durability.reconcile import (
    ReconcileReport,
    reconcile_wal,
    wal_cycles,
)
from svoc_torch.durability.recovery import (
    GracefulDrain,
    RecoveryError,
    RecoveryManager,
)
from svoc_torch.durability.wal import (
    CommitIntentWAL,
    WALCycle,
    payload_digest,
    read_wal,
)

__all__ = [
    "CommitIntentWAL",
    "DurableLocalBackend",
    "FaultController",
    "FaultEvent",
    "declare",
    "fault_point",
    "GracefulDrain",
    "ReconcileReport",
    "RecoveryError",
    "RecoveryManager",
    "WALCycle",
    "duplicate_predictions",
    "payload_digest",
    "read_chain_log",
    "read_wal",
    "reconcile_wal",
    "replay_chain_log",
    "wal_cycles",
]
