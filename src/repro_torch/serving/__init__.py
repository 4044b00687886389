"""Serving substrate of the port (counterpart of ``repro/serving``):
workloads, the instance catalog, the FCFS pool simulator (cold, warm,
routed and telemetry lanes), pool evaluation, routing policies, the
telemetry plane, the autoscaler and the live serving plane
(``serving.engine``)."""

from .autoscaler import LoadMonitor, ScaleEvent, rescale
from .handoff import from_fields
from .instance import (AWS_INSTANCES, MODEL_PROFILES, PAPER_POOLS,
                       InstanceType, ModelProfile, measured_throughputs,
                       service_table_for, service_time_lut,
                       service_time_table)
from .pool import (BUCKET_DIST_MIXES, DEFAULT_BOUNDS, DEFAULT_RATES,
                   PoolEvaluator, best_homogeneous, cost_effectiveness,
                   make_paper_setup, paper_bucketed_spec, paper_spec,
                   paper_workload)
from .routing import NAMED_POLICIES, RoutingPolicy, named_policy
from .simulator import (PoolSimulator, PoolState, QosResult, SegmentResult,
                        SimResult, StreamingSimulator)
from .telemetry import BUCKET_EDGES, N_BUCKETS, Telemetry
from .workload import (BucketedWorkloadSpec, RequestBucket, Workload,
                       WorkloadSpec, gaussian_batches, generate_workload,
                       lognormal_batches)

__all__ = [
    "AWS_INSTANCES", "MODEL_PROFILES", "PAPER_POOLS",
    "InstanceType", "ModelProfile", "service_time_table", "service_time_lut",
    "service_table_for", "measured_throughputs",
    "PoolEvaluator", "best_homogeneous", "cost_effectiveness",
    "make_paper_setup", "paper_workload", "paper_spec", "paper_bucketed_spec",
    "BUCKET_DIST_MIXES", "DEFAULT_RATES", "DEFAULT_BOUNDS",
    "PoolSimulator", "PoolState", "SegmentResult", "SimResult", "QosResult",
    "StreamingSimulator",
    "Telemetry", "BUCKET_EDGES", "N_BUCKETS",
    "RoutingPolicy", "NAMED_POLICIES", "named_policy",
    "LoadMonitor", "ScaleEvent", "rescale", "from_fields",
    "Workload", "WorkloadSpec", "BucketedWorkloadSpec", "RequestBucket",
    "generate_workload", "lognormal_batches", "gaussian_batches",
]
