"""Observability planes (the port's counterpart of
:mod:`svoc_tpu.obsplane`, ``obsplane/__init__.py:1-73``, with the same
exports): the cost-attribution plane (per-request latency
decomposition, the shape-keyed dispatch-cost ledger, the observation
channel, the on-demand profiler :class:`ProfileCapture`) and the fleet
plane (cross-replica hop-chain tracing, merged fleet telemetry + SLOs,
seeded anomaly detection)."""

from svoc_torch.obsplane.anomaly import (
    DEFAULT_ANOMALY_FAMILIES,
    AnomalyConfig,
    AnomalyDetector,
)
from svoc_torch.obsplane.fleet import (
    ACCOUNTING_FAMILIES,
    FleetAggregator,
    FleetPlane,
    resolve_fleet_plane_enabled,
)
from svoc_torch.obsplane.hopchain import (
    HOP_REASONS,
    HopContext,
    chain_stats,
    join_hop_chains,
)
from svoc_torch.obsplane.ledger import CostLedger, CostModel, group_key, ledger_key
from svoc_torch.obsplane.plane import (
    REQUEST_STAGE_HISTOGRAM,
    CostPlane,
    resolve_cost_plane,
    resolve_cost_plane_enabled,
)
from svoc_torch.obsplane.profiler import ProfileCapture
from svoc_torch.obsplane.timeline import (
    MARKS,
    STAGE_OF_MARK,
    ObservationLog,
    RequestTimeline,
    read_observations,
)

__all__ = [
    "ACCOUNTING_FAMILIES",
    "AnomalyConfig",
    "AnomalyDetector",
    "CostLedger",
    "CostModel",
    "CostPlane",
    "DEFAULT_ANOMALY_FAMILIES",
    "FleetAggregator",
    "FleetPlane",
    "HOP_REASONS",
    "HopContext",
    "MARKS",
    "ObservationLog",
    "ProfileCapture",
    "REQUEST_STAGE_HISTOGRAM",
    "RequestTimeline",
    "STAGE_OF_MARK",
    "chain_stats",
    "group_key",
    "join_hop_chains",
    "ledger_key",
    "read_observations",
    "resolve_cost_plane",
    "resolve_cost_plane_enabled",
    "resolve_fleet_plane_enabled",
]
