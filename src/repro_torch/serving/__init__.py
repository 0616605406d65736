"""Coded serving engines: continuous-batching inference over resident
``CodedPipeline``s (multi-model scheduler + engine loop + per-request
metrics) and continuous token batching over a ``CodedDecoderPipeline``."""
from .engine import CodedServer
from .frontend import ServingFrontend
from .lm_engine import CodedLMServer, pack_request, unpack_request
from .metrics import (
    MetricsCollector,
    OverlapStats,
    RequestRecord,
    ServingStats,
    percentile,
)
from .scheduler import (
    MultiScheduler,
    Request,
    RequestHandle,
    RequestQueue,
    ScheduledBatch,
    Scheduler,
)

__all__ = [
    "CodedServer",
    "ServingFrontend",
    "CodedLMServer",
    "pack_request",
    "unpack_request",
    "MetricsCollector",
    "OverlapStats",
    "RequestRecord",
    "ServingStats",
    "percentile",
    "MultiScheduler",
    "Request",
    "RequestHandle",
    "RequestQueue",
    "ScheduledBatch",
    "Scheduler",
]
