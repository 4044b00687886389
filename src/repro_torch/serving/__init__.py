"""Serving substrate of the port (counterpart of ``repro/serving``):
workloads, the instance catalog (and ``H100_CELLS``, the cell catalog
searched by ``serving.cells``), the FCFS pool simulator (cold, warm,
routed and telemetry lanes), pool evaluation, routing policies, the
telemetry plane, the autoscaler, fault handling (``serving.fault``), the
capacity tiers (``serving.tiers``), the streaming simulator and the live
serving plane (``serving.engine``: ``ClusterEngine`` over cells of any of
the paper's five models)."""

from .autoscaler import LoadMonitor, ScaleEvent, rescale
from .engine import DEFAULT_CELLS, CellType, ClusterEngine, ServingCell
from .fault import (fail_instances, recover_from_capacity_change,
                    recover_from_failure, reprice)
from .handoff import from_fields
from .cells import LLM_PROFILE, CellSearch, search_cells
from .instance import (AWS_INSTANCES, H100_CELLS, MODEL_PROFILES,
                       PAPER_POOLS, InstanceType, ModelProfile, measured_throughputs,
                       service_table_for, service_time_lut,
                       service_time_table)
from .pool import (BUCKET_DIST_MIXES, DEFAULT_BOUNDS, DEFAULT_RATES,
                   PoolEvaluator, best_homogeneous, cost_effectiveness,
                   make_paper_setup, paper_bucketed_spec, paper_spec,
                   paper_workload)
from .routing import NAMED_POLICIES, RoutingPolicy, named_policy
from .simulator import (PoolSimulator, PoolState, QosResult, SegmentResult,
                        SimResult, StreamingSimulator, StreamResult)
from .telemetry import BUCKET_EDGES, N_BUCKETS, Telemetry
from .tiers import (TIER_NAMES, TIERED_POOLS, TIERS, CapacityTier,
                    SpotPriceProcess, TierCatalog, TierHazard, tiered_pool,
                    tiered_variant)
from .workload import (BucketedWorkloadSpec, RequestBucket, Workload,
                       WorkloadSpec, gaussian_batches, generate_workload,
                       lognormal_batches)

__all__ = [
    "AWS_INSTANCES", "H100_CELLS", "MODEL_PROFILES", "PAPER_POOLS",
    "LLM_PROFILE", "CellSearch", "search_cells",
    "InstanceType", "ModelProfile", "service_time_table", "service_time_lut",
    "service_table_for", "measured_throughputs",
    "PoolEvaluator", "best_homogeneous", "cost_effectiveness",
    "make_paper_setup", "paper_workload", "paper_spec", "paper_bucketed_spec",
    "BUCKET_DIST_MIXES", "DEFAULT_RATES", "DEFAULT_BOUNDS",
    "PoolSimulator", "PoolState", "SegmentResult", "SimResult", "QosResult",
    "StreamingSimulator", "StreamResult",
    "Telemetry", "BUCKET_EDGES", "N_BUCKETS",
    "RoutingPolicy", "NAMED_POLICIES", "named_policy",
    "LoadMonitor", "ScaleEvent", "rescale", "from_fields",
    "CellType", "ClusterEngine", "ServingCell", "DEFAULT_CELLS",
    "fail_instances", "recover_from_capacity_change",
    "recover_from_failure", "reprice",
    "CapacityTier", "TIERS", "TIER_NAMES", "TierHazard", "SpotPriceProcess",
    "TierCatalog", "TIERED_POOLS", "tiered_variant", "tiered_pool",
    "Workload", "WorkloadSpec", "BucketedWorkloadSpec", "RequestBucket",
    "generate_workload", "lognormal_batches", "gaussian_batches",
]
