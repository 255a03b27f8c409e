"""Multi-replica serving fleet.

Mirrors :mod:`svoc_tpu.cluster` (``cluster/__init__.py:1-33``): a thin
placement/routing plane over N independent single-process serving
stacks — :mod:`placement` maps claims to replicas deterministically,
:mod:`replica` packages one MultiSession/ServingTier per durable base
dir, :mod:`router` forwards, migrates, and fails over, and
:mod:`scenario` is the seeded kill/failover workload behind
:mod:`svoc_torch.tools.cluster_smoke`, :mod:`reconfig` re-pins a running
fleet transactionally and :mod:`reconfig_scenario` is the seeded workload
behind :mod:`svoc_torch.tools.reconfig_smoke`.  It exports what the
reference exports.
"""

from svoc_torch.cluster.placement import PlacementDirectory, PlacementError
from svoc_torch.cluster.reconfig import ReconfigController, ReconfigError, ReconfigPlan
from svoc_torch.cluster.replica import Replica, ReplicaDeadError
from svoc_torch.cluster.router import ClusterRouter, MigrationContinuityError

__all__ = [
    "PlacementDirectory",
    "PlacementError",
    "Replica",
    "ReplicaDeadError",
    "ClusterRouter",
    "MigrationContinuityError",
    "ReconfigController",
    "ReconfigError",
    "ReconfigPlan",
]
