"""Master/worker runtime: the coded cluster and its worker pool."""
from .cluster import FcdccCluster, LayerTiming, PendingRound
from .devicepool import (
    ClusterDegraded,
    PendingBatch,
    StragglerModel,
    ThreadWorkerPool,
    make_pool,
    resolve_pool,
)
