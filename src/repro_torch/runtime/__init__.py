"""Master/worker runtime: the coded cluster and its worker pools."""
from .cluster import FcdccCluster, LayerTiming, PendingRound, run_layer_elastic
from .devicepool import (
    ClusterDegraded,
    DeviceWorkerPool,
    PendingBatch,
    StragglerModel,
    ThreadWorkerPool,
    make_pool,
    resolve_pool,
)
