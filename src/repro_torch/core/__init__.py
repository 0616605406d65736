"""FCDCC core: CRME codes, NSCTC encode/decode, APCP/KCCP, cost model,
the coded layer and the multi-layer pipeline."""
from .cost import CostWeights, cost_breakdown, optimal_partition
from .crme import (
    CrmeAxisCode,
    condition_number,
    joint_columns,
    make_axis_codes,
    next_odd,
    recovery_matrix,
    rotation_matrix,
)
from .fcdcc import CodedConv2d, FcdccPlan
from .partition import ConvGeometry, apcp_partition, kccp_partition, merge_output
from .pipeline import (
    CodedLayerSpec,
    CodedPipeline,
    build_cnn_pipeline,
    plan_layers,
)
