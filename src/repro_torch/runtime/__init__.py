"""Port of ``repro.runtime``: heartbeats and stragglers, fault injection,
elastic re-planning, slice scheduling and the multi-process cluster layer
(``runtime.cluster``)."""

from repro_torch.runtime.monitor import StepMonitor, StragglerPolicy, percentiles
from repro_torch.runtime.elastic import ElasticPlan, plan_remesh
from repro_torch.runtime.scheduler import (
    ShardAssignment,
    SliceScheduler,
    assign_slices,
    mesh_num_shards,
)

__all__ = [
    "StepMonitor", "StragglerPolicy", "percentiles", "ElasticPlan",
    "plan_remesh", "ShardAssignment", "SliceScheduler", "assign_slices",
    "mesh_num_shards",
]
