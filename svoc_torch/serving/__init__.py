"""The serving tier (the port's counterpart of :mod:`svoc_tpu.serving`):
admission and bounded queues (:mod:`~svoc_torch.serving.frontend`), the
cross-claim micro-batch (:mod:`~svoc_torch.serving.batcher`), the dedup
cache (:mod:`~svoc_torch.serving.cache`), the
:class:`~svoc_torch.serving.tier.ServingTier` facade with the device
half of a multi-claim step, and the seeded virtual-time scenario
(:mod:`~svoc_torch.serving.scenario`)."""

from svoc_torch.serving.batcher import MicroBatcher
from svoc_torch.serving.cache import ResultCache, content_key, content_key_from_digest, text_digest
from svoc_torch.serving.frontend import (
    AdmissionConfig,
    AdmissionController,
    AdmissionDecision,
    ServingFrontend,
    ServingRequest,
)
from svoc_torch.serving.tier import ServingTier

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "AdmissionDecision",
    "MicroBatcher",
    "ResultCache",
    "ServingFrontend",
    "ServingRequest",
    "ServingTier",
    "content_key",
    "content_key_from_digest",
    "text_digest",
]
