"""FCFS dispatch scan on the card: the wrapper of ``csrc/fcfs_scan.cu``.

A kernel of the port with no Pallas counterpart: it replaces XLA's
``lax.scan`` over the query stream in ``repro/serving/simulator.py``
(``_simulate_scan`` and its vmaps, the fused QoS counter
``_grid_lane_qos_counts``, the routed scans ``_simulate_scan_policy`` and
``_grid_lane_qos_counts_policy``, the in-carry telemetry counters
``_grid_lane_qos_counts_tel`` / ``..._policy_tel``, and the streamed chunk
``_stream_chunk``).  One warp per lane
(workload row, slot layout) with the slots' next-free times in registers.
A query's slot is picked by one ``redux.min`` over an order-preserving
unsigned image of each slot's key and equality ballots (the lowest set bit
of the first nonzero ballot is the first index of the minimum); the owner
updates its register and records the query in shared memory with
predicated stores, and the latencies, QoS counts, outputs and telemetry
counters are computed once a chunk of queries, 32 at a time.  When a
chunk's arrivals are all >= 0, a busy slot's image there is its next-free
time's bits (one instruction).  The next query's arrival, service times
and routed idle keys are read or built a step ahead; each warp stages its
own arrivals and service rows in shared memory.  Bound by the serial chain
of nq dependent picks; the bytes are a few hundred KB.  Bit-exact against
the plain version (``ref.fcfs_scan_ref``), since every step is one IEEE
operation in float32 (the routed keys one fused multiply-add each, on both
sides) and the pick is the first index of the minimum.

One launch takes any mix of these, each a template flag of the kernel:

* a routing policy (``pref_slot`` (L, S), ``affinity`` and ``hedge`` (L,));
* the telemetry counters (``n_active`` (L,) given): per lane served, QoS
  misses and busy milliseconds per type, the latency and wait histograms
  and the queue depth's sum and peak, in a (W, L, ``tel_width(n_types)``)
  int32 output (``split_tel`` names its parts);
* the dispatch trace: the winning slot of each query, (W, L, nq) int32.

``free0`` is (L, S), shared by every workload row, or (W, L, S), one carry
per row.

The stream flavour (``fcfs_stream_cuda``, the reference's ``_stream_chunk``)
scans one chunk of a streamed episode in place: the service rows are
gathered from a lookup table by each query's batch index as the chunk is
staged, the carried next-free times (W, L, S) are rebased by ``shift`` at
load and overwritten with the final ones, and the chunk's QoS count is
added to a count (W, L) carried on the device.

``fcfs_scan_cuda.launches`` counts the launches of every flavour and
``fcfs_scan_cuda.launches_by_flavour`` each flavour's ("cold": none of the
others; "policy", "telemetry", "trace": every launch that has it;
"stream": every streamed chunk), so a run can show which lanes went through
the kernel.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import torch

from . import _build

# Offset that ranks an idle slot below every busy one: the key of an idle
# slot is ``priority - BIG`` (the reference's ``_BIG``).
BIG = 1e6
# Rank-band separator of the routed idle key, and the key of the slots a
# routed step leaves out of one of its two minima (the reference's ``_TIE``
# and ``_INF``).
TIE = 65536.0
INF = 1e30
N_BUCKETS = 32         # telemetry histogram buckets (31 edges + overflow)
# float32 bits of the first histogram edge, 1e-4; edge k adds k to the
# exponent (the reference's ``BUCKET_EDGES = 1e-4 * 2**k``).
EDGE0_BITS = struct.unpack("<i", struct.pack("<f", 1e-4))[0]
MAX_SLOTS = 1024       # slots per layout: 32 a thread of one warp
MAX_TYPES = 32         # service rows staged in shared memory; one a thread
MAX_ROWS = 65535       # workload rows: the grid's y dimension
FLAVOURS = ("cold", "policy", "telemetry", "trace", "stream")

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 11)
_STREAM_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                    + [ctypes.c_float] * 3 + [ctypes.c_void_p])


class ScanResult(NamedTuple):
    """counts (W, L) i32; latencies and start times (W, L, nq) f32 when
    asked, else None; final next-free times (W, L, S) f32; winning slots
    (W, L, nq) i32 when asked; telemetry counters (W, L,
    ``tel_width(n_types)``) i32 when asked."""
    counts: torch.Tensor
    lat: torch.Tensor | None
    start: torch.Tensor | None
    free: torch.Tensor
    slot: torch.Tensor | None = None
    tel: torch.Tensor | None = None


def tel_width(n_types: int) -> int:
    """Counters per lane: served, misses, busy ms per type; two histograms;
    depth sum and peak."""
    return 3 * n_types + 2 * N_BUCKETS + 2


def split_tel(tel: torch.Tensor, n_types: int) -> tuple:
    """(served, miss, busy_ms, lat_hist, wait_hist, depth_sum, depth_peak)
    views of a (..., ``tel_width(n_types)``) counter tensor."""
    t, k = n_types, N_BUCKETS
    return (tel[..., :t], tel[..., t:2 * t], tel[..., 2 * t:3 * t],
            tel[..., 3 * t:3 * t + k], tel[..., 3 * t + k:3 * t + 2 * k],
            tel[..., 3 * t + 2 * k], tel[..., 3 * t + 2 * k + 1])


def check_inputs(arrivals: torch.Tensor, service: torch.Tensor,
                 type_of_slot: torch.Tensor, priority: torch.Tensor,
                 free0: torch.Tensor, policy=None,
                 n_active: torch.Tensor | None = None) -> None:
    """Raise on anything the kernel does not take: arrivals (W, nq) f32;
    service (W or 1, n_types, nq) f32 with 1 <= n_types <= MAX_TYPES;
    type_of_slot (L, S) i32 with 1 <= S <= MAX_SLOTS; priority (S,) f32;
    free0 (L, S) or (W, L, S) f32; policy None or (pref_slot (L, S),
    affinity (L,), hedge (L,)) f32; n_active None or (L,) i32; W <=
    MAX_ROWS; all contiguous and on one device.  Slot types are not read
    here: the kernel clamps them, as jnp does."""
    named = [("arrivals", arrivals, torch.float32),
             ("service", service, torch.float32),
             ("type_of_slot", type_of_slot, torch.int32),
             ("priority", priority, torch.float32),
             ("free0", free0, torch.float32)]
    if policy is not None:
        if len(policy) != 3:
            raise ValueError("fcfs_scan: policy must be (pref_slot, "
                             "affinity, hedge)")
        named += [(n, t, torch.float32) for n, t in
                  zip(("pref_slot", "affinity", "hedge"), policy)]
    if n_active is not None:
        named.append(("n_active", n_active, torch.int32))
    tensors = [t for _, t, _ in named]
    if any(t.device != arrivals.device for t in tensors):
        raise ValueError("fcfs_scan: inputs must be on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"fcfs_scan: {name} must be {dtype}, got {t.dtype}")
    if arrivals.dim() != 2 or service.dim() != 3 or type_of_slot.dim() != 2:
        raise ValueError("fcfs_scan: arrivals must be (W, nq), service "
                         "(W or 1, n_types, nq) and type_of_slot (L, S), got "
                         f"{tuple(arrivals.shape)}, {tuple(service.shape)}, "
                         f"{tuple(type_of_slot.shape)}")
    n_w, nq = arrivals.shape
    n_b, n_s = type_of_slot.shape
    if service.shape[0] not in (1, n_w) or service.shape[2] != nq:
        raise ValueError(f"fcfs_scan: service {tuple(service.shape)} does not "
                         f"fit arrivals {tuple(arrivals.shape)}")
    if not 1 <= service.shape[1] <= MAX_TYPES:
        raise ValueError(f"fcfs_scan: 1 to {MAX_TYPES} instance types, got "
                         f"{service.shape[1]}")
    if not 1 <= n_s <= MAX_SLOTS:
        raise ValueError(f"fcfs_scan: 1 to {MAX_SLOTS} slots, got {n_s}")
    if priority.shape != (n_s,) or free0.shape not in ((n_b, n_s),
                                                       (n_w, n_b, n_s)):
        raise ValueError(f"fcfs_scan: priority must be ({n_s},) and free0 "
                         f"({n_b}, {n_s}) or ({n_w}, {n_b}, {n_s}), got "
                         f"{tuple(priority.shape)} and {tuple(free0.shape)}")
    if policy is not None and (policy[0].shape != (n_b, n_s) or any(
            t.shape != (n_b,) for t in policy[1:])):
        raise ValueError(f"fcfs_scan: pref_slot must be ({n_b}, {n_s}) and "
                         f"affinity, hedge ({n_b},), got "
                         f"{[tuple(t.shape) for t in policy]}")
    if n_active is not None and n_active.shape != (n_b,):
        raise ValueError(f"fcfs_scan: n_active must be ({n_b},), got "
                         f"{tuple(n_active.shape)}")
    if n_w > MAX_ROWS:
        raise ValueError(f"fcfs_scan: at most {MAX_ROWS} workload rows, "
                         f"got {n_w}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fcfs_scan: inputs must be contiguous")
    if max(nq, n_b) >= 2 ** 31:
        raise ValueError("fcfs_scan: nq and L must fit in int32")


def check_stream_inputs(arrivals: torch.Tensor, batches: torch.Tensor,
                        lut: torch.Tensor, type_of_slot: torch.Tensor,
                        priority: torch.Tensor, free: torch.Tensor,
                        count: torch.Tensor) -> None:
    """Raise on anything the stream flavour does not take: arrivals (W, nq)
    f32; batches (W, nq) i32; lut (n_lut, n_types) f32 with n_lut >= 1 and
    1 <= n_types <= MAX_TYPES; type_of_slot (L, S) i32 with 1 <= S <=
    MAX_SLOTS; priority (S,) f32; the carries free (W, L, S) f32 and count
    (W, L) i32; W <= MAX_ROWS; all contiguous and on one device.  Batch
    indices are not read here: the kernel clamps them to [0, n_lut), as jnp's
    gather clamps."""
    named = [("arrivals", arrivals, torch.float32),
             ("batches", batches, torch.int32), ("lut", lut, torch.float32),
             ("type_of_slot", type_of_slot, torch.int32),
             ("priority", priority, torch.float32),
             ("free", free, torch.float32), ("count", count, torch.int32)]
    tensors = [t for _, t, _ in named]
    if any(t.device != arrivals.device for t in tensors):
        raise ValueError("fcfs_stream: inputs must be on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"fcfs_stream: {name} must be {dtype}, got "
                            f"{t.dtype}")
    if arrivals.dim() != 2 or lut.dim() != 2 or type_of_slot.dim() != 2:
        raise ValueError("fcfs_stream: arrivals must be (W, nq), lut (n_lut, "
                         "n_types) and type_of_slot (L, S), got "
                         f"{tuple(arrivals.shape)}, {tuple(lut.shape)}, "
                         f"{tuple(type_of_slot.shape)}")
    n_w, nq = arrivals.shape
    n_b, n_s = type_of_slot.shape
    if batches.shape != (n_w, nq):
        raise ValueError(f"fcfs_stream: batches must be ({n_w}, {nq}), got "
                         f"{tuple(batches.shape)}")
    if lut.shape[0] < 1 or not 1 <= lut.shape[1] <= MAX_TYPES:
        raise ValueError(f"fcfs_stream: lut must be (n_lut >= 1, 1 to "
                         f"{MAX_TYPES} types), got {tuple(lut.shape)}")
    if not 1 <= n_s <= MAX_SLOTS:
        raise ValueError(f"fcfs_stream: 1 to {MAX_SLOTS} slots, got {n_s}")
    if (priority.shape != (n_s,) or free.shape != (n_w, n_b, n_s)
            or count.shape != (n_w, n_b)):
        raise ValueError(f"fcfs_stream: priority must be ({n_s},), free "
                         f"({n_w}, {n_b}, {n_s}) and count ({n_w}, {n_b}), "
                         f"got {tuple(priority.shape)}, {tuple(free.shape)} "
                         f"and {tuple(count.shape)}")
    if n_w > MAX_ROWS:
        raise ValueError(f"fcfs_stream: at most {MAX_ROWS} workload rows, "
                         f"got {n_w}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fcfs_stream: inputs must be contiguous")
    if max(nq, n_b, lut.shape[0]) >= 2 ** 31:
        raise ValueError("fcfs_stream: nq, L and n_lut must fit in int32")


def fcfs_stream_cuda(arrivals: torch.Tensor, batches: torch.Tensor,
                     lut: torch.Tensor, type_of_slot: torch.Tensor,
                     priority: torch.Tensor, free: torch.Tensor,
                     count: torch.Tensor, shift: float, qos_t: float) -> None:
    """Launch the stream flavour on the current stream (inputs already
    checked by ``check_stream_inputs``, on a CUDA device): ``free`` and
    ``count`` are updated in place.  Raises if the launch fails."""
    if arrivals.device.type != "cuda":
        raise ValueError(f"fcfs_stream_cuda needs CUDA tensors, got "
                         f"{arrivals.device}")
    n_w, nq = arrivals.shape
    n_b, n_s = type_of_slot.shape
    if n_w == 0 or n_b == 0:
        return
    fn = _build.function("fcfs_scan", "fcfs_stream_forward", _STREAM_ARGTYPES)
    dev = arrivals.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(arrivals.data_ptr(), batches.data_ptr(), lut.data_ptr(),
                lut.shape[0], type_of_slot.data_ptr(), priority.data_ptr(),
                free.data_ptr(), count.data_ptr(), n_w, n_b, n_s,
                lut.shape[1], nq, BIG, shift, qos_t, stream)
    if rc != 0:
        raise RuntimeError(f"fcfs_stream kernel launch failed: cudaError_t "
                           f"{rc}")
    fcfs_scan_cuda.launches += 1
    fcfs_scan_cuda.launches_by_flavour["stream"] += 1


def result_buffers(arrivals: torch.Tensor, service: torch.Tensor,
                   type_of_slot: torch.Tensor, *, n_active=None,
                   want_lat: bool = False, want_start: bool = False,
                   want_slot: bool = False) -> ScanResult:
    """The kernel's outputs, empty, on the arrivals' device."""
    n_w, nq = arrivals.shape
    n_b, n_s = type_of_slot.shape

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=arrivals.device)

    return ScanResult(
        empty(n_w, n_b, dtype=torch.int32),
        empty(n_w, n_b, nq) if want_lat else None,
        empty(n_w, n_b, nq) if want_start else None,
        empty(n_w, n_b, n_s),
        empty(n_w, n_b, nq, dtype=torch.int32) if want_slot else None,
        empty(n_w, n_b, tel_width(service.shape[1]), dtype=torch.int32)
        if n_active is not None else None)


def fcfs_scan_cuda(arrivals: torch.Tensor, service: torch.Tensor,
                   type_of_slot: torch.Tensor, priority: torch.Tensor,
                   free0: torch.Tensor, qos_t: float, *, policy=None,
                   n_active: torch.Tensor | None = None,
                   want_lat: bool = False, want_start: bool = False,
                   want_slot: bool = False) -> ScanResult:
    """Launch the CUDA kernel on the current stream (inputs already checked
    by ``check_inputs``, on a CUDA device).  Raises if the launch fails."""
    if arrivals.device.type != "cuda":
        raise ValueError(f"fcfs_scan_cuda needs CUDA tensors, got {arrivals.device}")
    n_w, nq = arrivals.shape
    n_b, n_s = type_of_slot.shape
    n_types = service.shape[1]
    dev = arrivals.device
    result = result_buffers(arrivals, service, type_of_slot,
                            n_active=n_active, want_lat=want_lat,
                            want_start=want_start, want_slot=want_slot)
    counts, lat, start, free, slot, tel = result
    if n_w == 0 or n_b == 0:
        return result
    pref, aff, hedge = (None, None, None) if policy is None else policy

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.function("fcfs_scan", "fcfs_scan_forward", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(arrivals.data_ptr(), service.data_ptr(), service.shape[0],
                type_of_slot.data_ptr(), priority.data_ptr(),
                free0.data_ptr(), 1 if free0.dim() == 2 else n_w, n_w, n_b,
                n_s, n_types, nq, BIG, qos_t, ptr(pref), ptr(aff),
                ptr(hedge), ptr(n_active), counts.data_ptr(), ptr(lat),
                ptr(start), free.data_ptr(), ptr(slot), ptr(tel), stream)
    if rc != 0:
        raise RuntimeError(f"fcfs_scan kernel launch failed: cudaError_t {rc}")
    fcfs_scan_cuda.launches += 1
    flags = {"policy": policy is not None, "telemetry": n_active is not None,
             "trace": want_slot}
    for flavour, on in flags.items():
        fcfs_scan_cuda.launches_by_flavour[flavour] += on
    fcfs_scan_cuda.launches_by_flavour["cold"] += not any(flags.values())
    return result


fcfs_scan_cuda.launches = 0
fcfs_scan_cuda.launches_by_flavour = dict.fromkeys(FLAVOURS, 0)
