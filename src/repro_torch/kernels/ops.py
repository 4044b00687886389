"""Public entry points of the port's kernels.

Each function checks its inputs once, then takes the kernel's plain
version for tensors on the CPU and launches the CUDA kernel for tensors on
a card; there is no fallback from one to the other.  Meta tensors are
taken only inside an op walk (``roofline.op_walk``), which counts the call
by the kernel's formula and gets empty meta outputs of its shapes; outside
one they raise.  Counterpart of
``repro/kernels/ops.py``.  Unlike the reference wrappers, these move no
axes and pad nothing (not the head dim to 128 lanes, not S or T to
blocks): the kernels read the public layouts through their strides.
"""

from __future__ import annotations

import sys

import torch

from . import decode_attention as _decode
from . import embedding_bag as _bag
from . import fcfs_scan as _fcfs
from . import flash_attention as _flash
from . import ssd_scan as _ssd
from ..roofline import op_walk
from .ref import (decode_attention_ref, embedding_bag_ref, fcfs_scan_ref,
                  fcfs_stream_ref, flash_attention_ref, ssd_scan_ref)


def _local_only(name: str, *tensors) -> None:
    """Raise on a DTensor: a kernel launches on its inputs' raw pointers,
    so it takes each rank's local shard (``sharding.local_call``), never
    a distributed tensor, and never runs its plain version for one (no
    DTensor exists until ``torch.distributed.tensor`` is imported)."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and any(isinstance(t, dtensor.DTensor)
                                   for t in tensors):
        raise TypeError(f"{name} takes local tensors, got a DTensor: call it "
                        "through launch.sharding.local_call")


def _route(name: str, device: torch.device) -> str:
    """"cuda" (launch the kernel), "cpu" (its plain version) or, only inside
    an op walk, "meta" (count it by its formula)."""
    if device.type == "meta" and op_walk.active() is not None:
        return "meta"
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    return device.type


def embedding_bag(indices: torch.Tensor, table: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """indices (n_bags, bag) int32; table (V, D) → (n_bags, D).  Or every
    table of a model in one launch: indices (n_bags, T, bag) int32; tables
    stacked (T, V, D) → (n_bags, T·D), table t pooled by indices[:, t]."""
    _local_only("embedding_bag", indices, table, weights)
    _bag.check_inputs(indices, table, weights)
    route = _route("embedding_bag", table.device)
    if route == "meta":
        out = torch.empty((indices.shape[0], table.shape[0] * table.shape[-1]
                           if table.dim() == 3 else table.shape[-1]),
                          dtype=table.dtype, device=table.device)
        op_walk.kernel_call("embedding_bag", (indices, table, weights), out)
        return out
    if route == "cuda":
        return _bag.embedding_bag_cuda(indices, table, weights)
    return embedding_bag_ref(indices, table, weights)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, KH, D) → (B, S, H, D).  GQA: query head
    h reads KV head h // (H // KH).  Masks come from indices (query i, key
    j), causal and/or a sliding window of ``window`` keys; ``scale``
    defaults to D ** -0.5."""
    _local_only("flash_attention", q, k, v)
    _flash.check_inputs(q, k, v, window=window)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    route = _route("flash_attention", q.device)
    if route == "meta":
        out = torch.empty_like(q)
        op_walk.kernel_call("flash_attention", (q, k, v), out, causal=causal,
                            window=window)
        return out
    if route == "cuda":
        return _flash.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, scale=scale)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """q (B, 1, H, D); k, v (B, T, KH, D), a cache layer; pos (T,) int32,
    the ring's position table (slot j counts iff pos[j] >= 0) →
    (B, 1, H, D).  ``scale`` defaults to D ** -0.5."""
    _local_only("decode_attention", q, k, v, pos)
    _decode.check_inputs(q, k, v, pos)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    route = _route("decode_attention", q.device)
    if route == "meta":
        out = torch.empty_like(q)
        op_walk.kernel_call("decode_attention", (q, k, v, pos), out)
        return out
    if route == "cuda":
        return _decode.decode_attention_cuda(q, k, v, pos, scale=scale)
    return decode_attention_ref(q, k, v, pos, scale=scale)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor):
    """Mamba-2 SSD scan.  x (B, L, H, P); dt (B, L, H) float32 after
    softplus; a_log (H,) float32 (A = -exp(a_log)); b, c (B, L, G, N), head
    h reading group h // (H // G) → y (B, L, H, P) in x's type and the
    final state (B, H, P, N) float32.  Any L; x, b and c may be strided
    views (last dim contiguous)."""
    _local_only("ssd_scan", x, dt, a_log, b, c)
    _ssd.check_inputs(x, dt, a_log, b, c)
    route = _route("ssd_scan", x.device)
    if route == "meta":
        bb, _, h, p = x.shape
        out = (torch.empty(x.shape, dtype=x.dtype, device=x.device),
               torch.empty((bb, h, p, b.shape[-1]), dtype=torch.float32,
                           device=x.device))
        op_walk.kernel_call("ssd_scan", (x, dt, a_log, b, c), out)
        return out
    if route == "cuda":
        return _ssd.ssd_scan_cuda(x, dt, a_log, b, c)
    return ssd_scan_ref(x, dt, a_log, b, c)


def fcfs_scan(arrivals: torch.Tensor, service: torch.Tensor,
              type_of_slot: torch.Tensor, priority: torch.Tensor,
              free0: torch.Tensor, qos_t: float, *, policy=None,
              n_active: torch.Tensor | None = None, want_lat: bool = False,
              want_start: bool = False,
              want_slot: bool = False) -> _fcfs.ScanResult:
    """FCFS dispatch of W query streams over L slot layouts in one call:
    arrivals (W, nq) f32; service (W or 1, n_types, nq) f32; type_of_slot
    (L, S) i32; priority (S,) f32; free0 (L, S) f32, the initial next-free
    time of each slot (a huge value for an absent slot), or (W, L, S), one
    carry per workload row → counts of queries within ``qos_t`` (W, L) i32,
    latencies and start times (W, L, nq) f32 when asked, and the final
    next-free times (W, L, S) f32.  ``policy`` = (pref_slot (L, S),
    affinity (L,), hedge (L,)) f32 routes the dispatch; ``n_active`` (L,)
    i32 asks for the telemetry counters, ``want_slot`` for the winning slot
    of every query (see ``kernels.fcfs_scan``)."""
    _local_only("fcfs_scan", arrivals, service, type_of_slot, priority,
                free0, n_active, *(policy or ()))
    _fcfs.check_inputs(arrivals, service, type_of_slot, priority, free0,
                       policy, n_active)
    kw = dict(policy=policy, n_active=n_active, want_lat=want_lat,
              want_start=want_start, want_slot=want_slot)
    route = _route("fcfs_scan", arrivals.device)
    if route == "meta":
        out = _fcfs.result_buffers(arrivals, service, type_of_slot,
                                   n_active=n_active, want_lat=want_lat,
                                   want_start=want_start, want_slot=want_slot)
        op_walk.kernel_call("fcfs_scan", (arrivals, service, type_of_slot,
                                          priority, free0, policy, n_active),
                            out)
        return out
    if route == "cuda":
        return _fcfs.fcfs_scan_cuda(arrivals, service, type_of_slot,
                                    priority, free0, qos_t, **kw)
    return _fcfs.ScanResult(*fcfs_scan_ref(
        arrivals, service, type_of_slot, priority, free0, qos_t, _fcfs.BIG,
        **kw))


def fcfs_stream(arrivals: torch.Tensor, batches: torch.Tensor,
                lut: torch.Tensor, type_of_slot: torch.Tensor,
                priority: torch.Tensor, free: torch.Tensor,
                count: torch.Tensor, shift: float, qos_t: float) -> None:
    """One chunk of a streamed episode through the FCFS scan, in place:
    arrivals (W, nq) f32; batches (W, nq) i32, each query's row of the
    service lookup table lut (n_lut, n_types) f32; type_of_slot (L, S) i32;
    priority (S,) f32; the carries free (W, L, S) f32, rebased by ``shift``
    before the chunk and overwritten with its final next-free times, and
    count (W, L) i32, to which the chunk's count of queries within
    ``qos_t`` is added (see ``kernels.fcfs_scan``)."""
    _fcfs.check_stream_inputs(arrivals, batches, lut, type_of_slot, priority,
                              free, count)
    route = _route("fcfs_stream", arrivals.device)
    if route == "meta":
        op_walk.kernel_call("fcfs_stream", (arrivals, batches, lut,
                                            type_of_slot, priority, free,
                                            count), (free, count))
        return
    if route == "cuda":
        _fcfs.fcfs_stream_cuda(arrivals, batches, lut, type_of_slot,
                               priority, free, count, shift, qos_t)
        return
    new_count, new_free = fcfs_stream_ref(arrivals, batches, lut,
                                          type_of_slot, priority, free,
                                          count, shift, qos_t, _fcfs.BIG)
    count.copy_(new_count)
    free.copy_(new_free)
