"""FCFS dispatch scan on the card: the wrapper of ``csrc/fcfs_scan.cu``.

A kernel of the port with no Pallas counterpart: it replaces XLA's
``lax.scan`` over the query stream in ``repro/serving/simulator.py``
(``_simulate_scan`` and its vmaps, and the fused QoS counter
``_grid_lane_qos_counts``).  One warp per lane (workload row, slot
layout) with the slots' next-free times in registers, a shuffle argmin on
(key, slot index) per query, arrivals and service tiles of a workload row
shared through shared memory.  Bound by the serial chain of nq dependent
shuffle reductions; the bytes are a few hundred KB.  Bit-exact against the
plain version (``ref.fcfs_scan_ref``), since every step is one IEEE
operation in float32.

``fcfs_scan_cuda.launches`` counts the launches, so a run can show that
its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

# Offset that ranks an idle slot below every busy one: the key of an idle
# slot is ``priority - BIG`` (the reference's ``_BIG``).
BIG = 1e6
MAX_SLOTS = 1024       # slots per layout: 32 a thread of one warp
MAX_TYPES = 32         # service rows staged in shared memory
MAX_ROWS = 65535       # workload rows: the grid's y dimension

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 5)


class ScanResult(NamedTuple):
    """counts (W, B) i32; latencies and start times (W, B, nq) f32 when
    asked, else None; final next-free times (W, B, S) f32."""
    counts: torch.Tensor
    lat: torch.Tensor | None
    start: torch.Tensor | None
    free: torch.Tensor


def check_inputs(arrivals: torch.Tensor, service: torch.Tensor,
                 type_of_slot: torch.Tensor, priority: torch.Tensor,
                 free0: torch.Tensor) -> None:
    """Raise on anything the kernel does not take: arrivals (W, nq) f32;
    service (W or 1, n_types, nq) f32 with 1 <= n_types <= MAX_TYPES;
    type_of_slot (B, S) i32 with 1 <= S <= MAX_SLOTS; priority (S,) f32;
    free0 (B, S) f32; W <= MAX_ROWS; all contiguous and on one device.
    Slot types are not read here: the kernel clamps them, as jnp does."""
    tensors = (arrivals, service, type_of_slot, priority, free0)
    if any(t.device != arrivals.device for t in tensors):
        raise ValueError("fcfs_scan: inputs must be on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    for name, t, dtype in (("arrivals", arrivals, torch.float32),
                           ("service", service, torch.float32),
                           ("type_of_slot", type_of_slot, torch.int32),
                           ("priority", priority, torch.float32),
                           ("free0", free0, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"fcfs_scan: {name} must be {dtype}, got {t.dtype}")
    if arrivals.dim() != 2 or service.dim() != 3 or type_of_slot.dim() != 2:
        raise ValueError("fcfs_scan: arrivals must be (W, nq), service "
                         "(W or 1, n_types, nq) and type_of_slot (B, S), got "
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
    if priority.shape != (n_s,) or free0.shape != (n_b, n_s):
        raise ValueError(f"fcfs_scan: priority must be ({n_s},) and free0 "
                         f"({n_b}, {n_s}), got {tuple(priority.shape)} and "
                         f"{tuple(free0.shape)}")
    if n_w > MAX_ROWS:
        raise ValueError(f"fcfs_scan: at most {MAX_ROWS} workload rows, "
                         f"got {n_w}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fcfs_scan: inputs must be contiguous")
    if max(nq, n_b) >= 2 ** 31:
        raise ValueError("fcfs_scan: nq and B must fit in int32")


def fcfs_scan_cuda(arrivals: torch.Tensor, service: torch.Tensor,
                   type_of_slot: torch.Tensor, priority: torch.Tensor,
                   free0: torch.Tensor, qos_t: float, *,
                   want_lat: bool = False,
                   want_start: bool = False) -> ScanResult:
    """Launch the CUDA kernel on the current stream (inputs already checked
    by ``check_inputs``, on a CUDA device).  Raises if the launch fails."""
    if arrivals.device.type != "cuda":
        raise ValueError(f"fcfs_scan_cuda needs CUDA tensors, got {arrivals.device}")
    n_w, nq = arrivals.shape
    n_b, n_s = type_of_slot.shape
    dev = arrivals.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    counts = empty(n_w, n_b, dtype=torch.int32)
    lat = empty(n_w, n_b, nq) if want_lat else None
    start = empty(n_w, n_b, nq) if want_start else None
    free = empty(n_w, n_b, n_s)
    if n_w == 0 or n_b == 0:
        return ScanResult(counts, lat, start, free)
    fn = _build.function("fcfs_scan", "fcfs_scan_forward", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(arrivals.data_ptr(), service.data_ptr(), service.shape[0],
                type_of_slot.data_ptr(), priority.data_ptr(),
                free0.data_ptr(), n_w, n_b, n_s, service.shape[1], nq, BIG,
                qos_t, counts.data_ptr(),
                None if lat is None else lat.data_ptr(),
                None if start is None else start.data_ptr(),
                free.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fcfs_scan kernel launch failed: cudaError_t {rc}")
    fcfs_scan_cuda.launches += 1
    return ScanResult(counts, lat, start, free)


fcfs_scan_cuda.launches = 0
