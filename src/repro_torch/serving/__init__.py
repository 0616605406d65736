"""Coded serving engine: continuous-batching inference over resident
``CodedPipeline``s — multi-model scheduler + engine loop + per-request
metrics."""
from .engine import CodedServer
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
