"""Serving substrate of the port (counterpart of ``repro/serving``):
workloads, the instance catalog, the FCFS pool simulator, pool evaluation
and the live serving plane (``serving.engine``)."""

from .instance import (AWS_INSTANCES, MODEL_PROFILES, PAPER_POOLS,
                       InstanceType, ModelProfile, measured_throughputs,
                       service_table_for, service_time_lut,
                       service_time_table)
from .pool import (BUCKET_DIST_MIXES, DEFAULT_BOUNDS, DEFAULT_RATES,
                   PoolEvaluator, best_homogeneous, cost_effectiveness,
                   make_paper_setup, paper_bucketed_spec, paper_spec,
                   paper_workload)
from .simulator import (PoolSimulator, QosResult, SimResult,
                        StreamingSimulator)
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
    "PoolSimulator", "SimResult", "QosResult", "StreamingSimulator",
    "Workload", "WorkloadSpec", "BucketedWorkloadSpec", "RequestBucket",
    "generate_workload", "lognormal_batches", "gaussian_batches",
]
