"""The cost-attribution plane (the port's counterpart of
:mod:`svoc_tpu.obsplane`): per-request latency decomposition, the
shape-keyed dispatch-cost ledger, the observation channel and the
on-demand profiler (:class:`ProfileCapture`).  The fleet plane
(``fleet``, ``hopchain``, ``anomaly``) waits for ROADMAP A11b."""

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
    "CostLedger",
    "CostModel",
    "CostPlane",
    "MARKS",
    "ObservationLog",
    "ProfileCapture",
    "REQUEST_STAGE_HISTOGRAM",
    "RequestTimeline",
    "STAGE_OF_MARK",
    "group_key",
    "ledger_key",
    "read_observations",
    "resolve_cost_plane",
    "resolve_cost_plane_enabled",
]
