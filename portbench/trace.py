"""A profiled slice of the window, and what the per-layer readers get from it.

``Slice`` runs ``torch.profiler`` (CUPTI) over a fixed number of the
window's requests or decode steps, never the whole window: a decode
window launches about a million kernels.  The slice the readers get
records the device's operations alone, since recording every host
operation slows a host-paced decode step by half (76 against 52 ms at
olmoe-1b-7b's B 64): a ``Reading`` holds kernel time by kind and the busy
union.  A shorter slice after it records the host's operations too, on
the thread that drives the window, and labels each idle gap with what
that thread was doing when the gap began (``breakdown``'s "idle_gaps").
No trace is written to disk.

Kernels are told apart by name.  The lists are the benchmark's, frozen
here: the port's own kernels by their ``__global__`` names in
``src/repro_torch/csrc``, and the library matrix products by the
fragments cuBLAS and CUTLASS put in theirs.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import torch

PORT_KERNELS = {
    "flash": ("flash_mma_kernel",),
    "decode_attention": ("decode_bf16_kernel", "decode_kernel",
                         "combine_kernel"),
    "ssd_scan": ("ssd_mma_kernel",),
    "other": ("scalar_kernel", "embedding_bag_kernel", "fcfs_scan_kernel"),
}
GEMM_FRAGMENTS = ("gemm", "nvjet", "cutlass", "xmma", "cublas", "splitk")
COPIES = ("memcpy", "memset")
SPAN = "pb."


def _port_match(name: str, kernel: str) -> bool:
    return re.search(rf"(^|[\s:*&]){kernel}\s*[<(]", name) is not None


def kind_of(name: str) -> str:
    """"flash", "decode_attention", "ssd_scan", "port" (another kernel of
    the port), "gemm", "copy" or "glue" (every other kernel)."""
    low = name.lower()
    for kind, kernels in PORT_KERNELS.items():
        if any(_port_match(name, k) for k in kernels):
            return "port" if kind == "other" else kind
    if any(f in low for f in COPIES):
        return "copy"
    if any(f in low for f in GEMM_FRAGMENTS):
        return "gemm"
    return "glue"


@dataclass
class Reading:
    """What a traced slice gives the per-layer readers."""
    cfg: dict                       # the configuration's "arch"
    units: list                     # ("prefill", b, s) or ("decode", b, n_valid)
    window_s: float                 # length of the traced slice, host clock
    kernel_s: dict                  # kind -> device seconds
    busy_s: float                   # union of the device's operations
    top_ops: list                   # [[name, seconds]] by device time
    host_issue_ms: list = field(default_factory=list)    # untraced steps
    host_prefill_ms: list = field(default_factory=list)  # and prefills

    def prefills(self) -> list:
        return [(b, s) for kind, b, s in self.units if kind == "prefill"]

    def decodes(self) -> list:
        return [(b, n) for kind, b, n in self.units if kind == "decode"]


def _events(prof):
    """(device ops [(name, start_ns, end_ns)], host ops [(name, start_ns,
    end_ns, thread)]) from the profiler's raw events."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            # a record_function span is mirrored on the device's timeline
            # as an annotation: no operation ran there
            if not (e.is_user_annotation() or e.name().startswith(SPAN)):
                dev.append((e.name(), start, end))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), start, end, e.start_thread_id()))
    return dev, host


def _union(ops):
    """Merged busy intervals [(start, end)] of ops sorted by start."""
    merged = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _gap_labels(gaps, host):
    """For each gap (start, end), what the host thread that drives the
    window was doing when it began: its innermost ``pb.`` span and its
    innermost operation there."""
    spans = [h for h in host if h[0].startswith(SPAN)]
    if not spans:
        return ["host: unknown"] * len(gaps)
    thread = spans[0][3]
    ops = sorted((h for h in host if h[3] == thread), key=lambda h: h[1])
    labels, stack, i = [], [], 0
    for start, _ in gaps:
        while i < len(ops) and ops[i][1] <= start:
            while stack and stack[-1][2] <= ops[i][1]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][2] <= start:
            stack.pop()
        span = next((o[0] for o in reversed(stack) if o[0].startswith(SPAN)),
                    "outside spans")
        inner = stack[-1][0] if stack else "idle host"
        labels.append(span if inner == span else f"{span} / {inner}")
    return labels


class Slice:
    """Profile from ``start()`` to ``stop()``; both wait for the device.
    ``host`` records the host's operations as well as the device's."""

    def __init__(self, host: bool = False):
        self.host = host
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA]
        if self.host:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def reading(self, cfg: dict, units: list, top: int = 10) -> Reading:
        dev, _ = _events(self.prof)
        kernel_s: dict[str, float] = {}
        by_name: dict[str, float] = {}
        for name, s, e in dev:
            sec = (e - s) * 1e-9
            kind = kind_of(name)
            kernel_s[kind] = kernel_s.get(kind, 0.0) + sec
            by_name[name] = by_name.get(name, 0.0) + sec
        busy = sum(e - s for s, e in _union(dev)) * 1e-9
        rank = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return Reading(cfg, units, self.t1 - self.t0, kernel_s, busy,
                       [[n[:160], s] for n, s in rank])

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host did, seconds]]: the idle time between the
        device's operations, summed by what the host thread was doing when
        each gap began, the largest first."""
        dev, host = _events(self.prof)
        merged = _union(dev)
        gaps = [(merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)]
        idle: dict[str, float] = {}
        for (s, e), label in zip(gaps, _gap_labels(gaps, host)):
            idle[label] = idle.get(label, 0.0) + (e - s) * 1e-9
        ranked = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], s] for n, s in ranked]
