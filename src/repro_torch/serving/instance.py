"""Instance-type catalog and analytical latency models (numpy only).

A copy of ``repro/serving/instance.py``: the port imports nothing of the
JAX package.  The paper profiles real AWS EC2 instances; the raw profiles
are not public, so each instance type is a roofline-style latency model

    latency(model, b) = overhead + max( b * flops_per_sample / (F * eff),
                                        (weight_bytes + b * act_bytes) / B )

with per-type effective compute rate ``F`` (FLOP/s), effective memory
bandwidth ``B`` (B/s), fixed dispatch overhead, and a per-(model, instance)
efficiency multiplier ``eff``.  Prices are real on-demand us-east-1 prices
(2021, $/hour) for the sizes in paper Table 2.  The constants, calibrated
in the reference so that the relationships of paper Fig. 3 and Table 3
hold, are copied unchanged.

The reference's ``TPU_CELLS`` catalog is not copied: its rates are a TPU
chip's, and nothing of the port reads them.  ``_DENSE_EFF`` keeps its
cell entries so that the model profiles equal the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np


@dataclass(frozen=True)
class ModelProfile:
    """Analytical per-query resource profile of a served model."""

    name: str
    flops_per_sample: float
    act_bytes_per_sample: float   # gathered embeddings / activations per sample
    weight_bytes: float           # weights streamed per query batch
    qos_latency: float            # paper §5.1 tail-latency target (seconds)
    max_batch: int = 256          # workload batch-size cap for this model
    median_batch: float = 24.0    # lognormal median for this model's stream
    efficiency: dict = field(default_factory=dict)   # per-instance F multiplier

    def eff(self, instance_name: str) -> float:
        if instance_name in self.efficiency:
            return self.efficiency[instance_name]
        # Tier variants ("g4dn:spot") inherit their base hardware's entry.
        return self.efficiency.get(instance_name.partition(":")[0], 1.0)


@dataclass(frozen=True)
class InstanceType:
    name: str
    price: float          # $ / hour
    flops: float          # effective FLOP/s (base; model efficiency multiplies)
    mem_bw: float         # effective bytes/s
    overhead: float       # fixed per-query dispatch seconds
    chips: int = 0        # >0 for accelerator cell types
    tier: str = "on_demand"   # capacity tier (serving/tiers.py)

    def latency(self, profile: ModelProfile, batch) -> np.ndarray:
        b = np.asarray(batch, dtype=np.float64)
        f_eff = self.flops * profile.eff(self.name)
        compute = b * profile.flops_per_sample / f_eff
        memory = (profile.weight_bytes + b * profile.act_bytes_per_sample) / self.mem_bw
        return self.overhead + np.maximum(compute, memory)


# --------------------------------------------------------------------------
# AWS catalog (paper Table 2 sizes; real on-demand prices).
# Base F is the recsys-effective rate; other model families scale via eff.
# --------------------------------------------------------------------------
AWS_INSTANCES: dict[str, InstanceType] = {
    # general purpose
    "t3":   InstanceType("t3",   price=0.1664, flops=1.15e10, mem_bw=1.8e10, overhead=1.2e-3),
    "m5":   InstanceType("m5",   price=0.192,  flops=1.50e10, mem_bw=1.9e10, overhead=1.0e-3),
    "m5n":  InstanceType("m5n",  price=0.238,  flops=1.60e10, mem_bw=2.0e10, overhead=1.0e-3),
    # compute optimized
    "c5":   InstanceType("c5",   price=0.34,   flops=1.90e10, mem_bw=2.4e10, overhead=0.8e-3),
    "c5a":  InstanceType("c5a",  price=0.308,  flops=1.80e10, mem_bw=2.2e10, overhead=0.8e-3),
    # memory optimized
    "r5":   InstanceType("r5",   price=0.126,  flops=1.20e10, mem_bw=2.4e10, overhead=1.1e-3),
    "r5n":  InstanceType("r5n",  price=0.149,  flops=1.35e10, mem_bw=2.6e10, overhead=1.1e-3),
    # GPU accelerator
    "g4dn": InstanceType("g4dn", price=0.526,  flops=9.0e11,  mem_bw=1.6e11, overhead=4.2e-3),
}


# Efficiency of the dense/conv science models per instance family: conv/GEMM
# vectorizes well on AVX-512 server cores (c5/c5a best, m5 good, t3 throttled
# burstable, r5 fewer cores), and these fp32 single-stream models underutilize
# the T4 (PCIe + launch bound).
_DENSE_EFF = {"t3": 1.8, "m5": 2.5, "m5n": 2.5, "c5": 3.8, "c5a": 4.0,
              "r5": 2.0, "r5n": 2.0, "g4dn": 0.12,
              "cell1": 1.0, "cell4": 1.0, "cell8": 1.0}

# --------------------------------------------------------------------------
# Model profiles (paper Table 1).  QoS targets from paper §5.1: MT-WND 20 ms,
# DIEN 30 ms, CANDLE 40 ms, ResNet50 400 ms, VGG19 800 ms.
# Recsys models: small dense compute + embedding-gather traffic → the GPU is
# the only type serving large batches within QoS.  CANDLE/ResNet/VGG: FLOP
# dominated → compute-optimized CPUs are the cost-optimal QoS anchors.
# --------------------------------------------------------------------------
MODEL_PROFILES: dict[str, ModelProfile] = {
    "mtwnd":    ModelProfile("mtwnd",    flops_per_sample=3.0e6,
                             act_bytes_per_sample=4.0e5, weight_bytes=2.4e7,
                             qos_latency=0.020, max_batch=256, median_batch=24),
    "dien":     ModelProfile("dien",     flops_per_sample=3.5e6,
                             act_bytes_per_sample=6.0e5, weight_bytes=3.0e7,
                             qos_latency=0.030, max_batch=256, median_batch=24),
    "candle":   ModelProfile("candle",   flops_per_sample=1.2e7,
                             act_bytes_per_sample=6.0e4, weight_bytes=8.0e7,
                             qos_latency=0.040, max_batch=128, median_batch=24,
                             efficiency=_DENSE_EFF),
    "resnet50": ModelProfile("resnet50", flops_per_sample=1.1e8,
                             act_bytes_per_sample=2.0e5, weight_bytes=1.0e8,
                             qos_latency=0.400, max_batch=64, median_batch=8,
                             efficiency=_DENSE_EFF),
    "vgg19":    ModelProfile("vgg19",    flops_per_sample=5.0e8,
                             act_bytes_per_sample=2.5e5, weight_bytes=5.6e8,
                             qos_latency=0.800, max_batch=64, median_batch=8,
                             efficiency=_DENSE_EFF),
}

# Paper Table 3: homogeneous base type and diverse pool per model.
PAPER_POOLS: dict[str, dict] = {
    "candle":   {"homogeneous": "c5a",  "diverse": ("c5a", "m5", "t3")},
    "resnet50": {"homogeneous": "c5a",  "diverse": ("c5a", "m5", "t3")},
    "vgg19":    {"homogeneous": "c5a",  "diverse": ("c5a", "m5", "t3")},
    "mtwnd":    {"homogeneous": "g4dn", "diverse": ("g4dn", "c5", "r5n")},
    "dien":     {"homogeneous": "g4dn", "diverse": ("g4dn", "c5", "r5n")},
}


# Memoized service tables: constructing several PoolSimulators over the same
# (model, pool, batch stream) — e.g. one per load level in bench_load_change,
# where scaling compresses arrivals but keeps batches — must not recompute the
# (n_types, n_queries) matrix.  Keyed on value (not identity) so equal toy
# profiles built in tests also hit.  Bounded FIFO to keep memory flat.
_SERVICE_TABLE_CACHE: dict[tuple, np.ndarray] = {}
_SERVICE_TABLE_CACHE_MAX = 64


def _profile_key(model: ModelProfile) -> tuple:
    return (model.name, model.flops_per_sample, model.act_bytes_per_sample,
            model.weight_bytes, tuple(sorted(model.efficiency.items())))


def service_time_table(model: ModelProfile, types: list[InstanceType],
                       batches: np.ndarray) -> np.ndarray:
    """(n_types, n_queries) service time matrix for a query stream.

    Cached per (model, types, batches); the returned array is read-only —
    copy before mutating.
    """
    batches = np.asarray(batches)
    key = (_profile_key(model), tuple(types), batches.shape, batches.tobytes())
    table = _SERVICE_TABLE_CACHE.get(key)
    if table is None:
        table = np.stack([t.latency(model, batches) for t in types], axis=0)
        table.setflags(write=False)
        if len(_SERVICE_TABLE_CACHE) >= _SERVICE_TABLE_CACHE_MAX:
            _SERVICE_TABLE_CACHE.pop(next(iter(_SERVICE_TABLE_CACHE)))
        _SERVICE_TABLE_CACHE[key] = table
    return table


def service_time_lut(model: ModelProfile, types: list[InstanceType],
                     max_batch: int) -> np.ndarray:
    """(n_types, max_batch + 1) service times indexed by batch size.

    The streaming lane generates batch sizes on device, so per-query service
    columns cannot be precomputed host-side; instead the kernel gathers from
    this lookup table (``lut[:, batch]``).  Entry ``[t, b]`` equals
    ``types[t].latency(model, b)`` bit for bit, which is exactly the value
    the host-built ``service_time_table`` column holds for a query of batch
    ``b`` — so the streamed scan reproduces the monolithic arithmetic.
    Rides the same memo cache (``batches`` = ``arange(max_batch + 1)``).
    """
    return service_time_table(model, types,
                              np.arange(int(max_batch) + 1, dtype=np.int64))


def bucket_profile(model: ModelProfile, bucket) -> ModelProfile:
    """The model profile as seen by one request-size bucket: the bucket's
    output scale multiplies ``flops_per_sample`` and its input scale
    multiplies ``act_bytes_per_sample`` (workload.RequestBucket semantics).
    The unit bucket returns a value-equal profile (float multiplies by 1.0
    are exact), so its tables hit the same memo entries bit for bit."""
    return replace(model,
                   flops_per_sample=model.flops_per_sample
                   * float(bucket.flops_scale),
                   act_bytes_per_sample=model.act_bytes_per_sample
                   * float(bucket.bytes_scale))


def bucketed_service_time_table(model: ModelProfile,
                                types: list[InstanceType],
                                batches: np.ndarray,
                                bucket_of: np.ndarray,
                                buckets) -> np.ndarray:
    """(n_types, n_queries) service times of a bucket-annotated stream:
    column ``q`` holds the latency of batch ``batches[q]`` under query
    ``q``'s bucket-scaled profile.  Built from one memoized
    ``service_time_table`` per bucket (the per-bucket profiles key the same
    cache), columns selected by ``bucket_of`` — with a single unit bucket
    this *is* the legacy table, bit for bit and cache-entry for
    cache-entry."""
    per_bucket = [service_time_table(bucket_profile(model, bk), types,
                                     batches) for bk in buckets]
    if len(per_bucket) == 1:
        return per_bucket[0]
    bucket_of = np.asarray(bucket_of)
    out = per_bucket[0].copy()
    for k in range(1, len(per_bucket)):
        sel = bucket_of == k
        out[:, sel] = per_bucket[k][:, sel]
    out.setflags(write=False)
    return out


def bucketed_service_time_lut(model: ModelProfile,
                              types: list[InstanceType], max_batch: int,
                              buckets) -> np.ndarray:
    """(n_types, n_buckets * (max_batch + 1)) lookup table for streamed
    bucketed specs: bucket ``k``'s block is that bucket-scaled profile's
    ``service_time_lut``, gathered by the flat index
    ``k * (max_batch + 1) + batch`` — so with one unit bucket the flat
    index degenerates to the batch size over the legacy table."""
    return np.concatenate(
        [service_time_lut(bucket_profile(model, bk), types, max_batch)
         for bk in buckets], axis=1)


def service_table_for(model: ModelProfile, types: list[InstanceType],
                      workload) -> np.ndarray:
    """The per-query service table of a :class:`~.workload.Workload` —
    bucket-aware when the stream carries bucket annotations, the legacy
    scalar table otherwise.  Every simulator lane binds its stream through
    this selector, which is what makes bucketed traffic ride cold, warm,
    grid and routed dispatches without kernel changes."""
    bucket_of = getattr(workload, "bucket_of", None)
    if bucket_of is None:
        return service_time_table(model, types, workload.batches)
    return bucketed_service_time_table(model, types, workload.batches,
                                       bucket_of, workload.buckets)


def measured_throughputs(model: ModelProfile, types: list[InstanceType],
                         workload) -> np.ndarray:
    """Per-(instance type x bucket) sustained throughput profiled from a
    stream's service times (Mélange's ``tputs`` matrix): entry ``[t, k]``
    is the query rate one type-``t`` instance sustains serving bucket
    ``k``'s realized queries back to back — ``n_k / sum(service times)``.
    Un-bucketed streams profile as a single column."""
    table = service_table_for(model, types, workload)
    bucket_of = getattr(workload, "bucket_of", None)
    if bucket_of is None:
        bucket_of = np.zeros(workload.n_queries, dtype=np.int64)
        n_buckets = 1
    else:
        n_buckets = len(workload.buckets)
    out = np.zeros((len(types), n_buckets), dtype=np.float64)
    for k in range(n_buckets):
        sel = np.asarray(bucket_of) == k
        if sel.any():
            out[:, k] = sel.sum() / table[:, sel].sum(axis=1)
    return out
