"""The span slice: the port's own spans and counters, on the device's clock.

The port marks its layers with spans and counters that are off unless a
caller turns them on (``repro_torch.tracing``: ``rt.prefill``, ``rt.moe``
and its ``.dispatch``, ``.experts`` and ``.combine``, ``rt.mamba`` and its
``.conv`` and ``.gate``; counters ``moe.pairs_routed`` and
``moe.pairs_kept``).  The window never turns them on.  The span slice
replays the window's first ``trace.units`` requests (the same indices,
lengths and prompts: the work the first profiled slice measured) once the
window has closed and the peak memory has been read, with the port's
tracing on.  Its requests are no request of the window: they are in no
record, no count of requests and no sample of the check.

The profiler records the device's operations and, on the host, the
user-annotated spans alone (``record_function``'s scope; not every
operator, which would slow the host's issue three- to fourfold).  CUPTI
mirrors each span instance on the device's timeline over the operations
launched directly inside it (not inside a span within it), under the host
span's correlation id.  A span's device interval is the hull of its
mirror and of the intervals of the spans the host nested inside it; each
device operation goes to the innermost span whose interval holds it, and
each gap in the device's busy union to the innermost span whose interval
holds the gap.  So every number is on the device's clock, and the host's
timestamps only say which span holds which.  ``rt.count`` holds the
counters' own kernels, so a layer is never charged with them.

The readers of ``metrics/`` get the first slice's ``trace.Reading``
alone, from ``harness.run``; a reader of a span metric calls ``of(reading)``,
which on its first call of a run finds that run's loop in the frame of
``harness.run`` that called the reader (and empties the frame's snapshot
of its locals, which would keep the port alive into the check), replays
the slice and keeps the result for the run's other readers.  A program
without ``repro_torch.tracing`` gives nothing to read: ``of`` returns None.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import torch

from .trace import _union

RT = "rt."
COUNT = "rt.count"


@dataclass
class SpanReading:
    """The span slice: for each path of spans (outermost first; () is
    outside every span) its device operations, their device seconds and
    the device's idle seconds; the counters; the slice's wall time."""
    requests: int
    paths: dict = field(default_factory=dict)   # path -> [ops, busy s, idle s]
    counters: dict = field(default_factory=dict)
    seconds: float = 0.0

    def has(self, name: str) -> bool:
        return any(name in p for p in self.paths)

    def _sum(self, keep, col: int) -> float:
        return sum(v[col] for p, v in self.paths.items() if keep(p))

    def device_ms(self, name: str) -> float | None:
        """Device ms a request in operations whose innermost span is
        ``name``."""
        if not self.has(name):
            return None
        return 1e3 * self._sum(lambda p: p and p[-1] == name, 1) / \
            self.requests

    def idle_ms(self, name: str) -> float | None:
        """Device idle ms a request inside ``name``'s device intervals."""
        if not self.has(name):
            return None
        return 1e3 * self._sum(lambda p: name in p, 2) / self.requests

    def ops(self, name: str) -> float | None:
        """Device operations a request under ``name``, the counters' own
        left out."""
        if not self.has(name):
            return None
        return self._sum(lambda p: name in p and p[-1] != COUNT, 0) / \
            self.requests


def nested_stacks(queries, intervals):
    """For each query (start, end), in the order given (sorted by start,
    each ending no earlier than the one before), the ids of the intervals
    (start, end, id) that hold it, outermost first.  Intervals nest: two
    either hold one another or do not meet; of two equal ones, the one
    given first holds the other."""
    order = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    stack, out, i = [], [], 0
    for qs, qe in queries:
        while i < len(order) and order[i][0] <= qs:
            while stack and stack[-1][1] < order[i][1]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] < qe:
            stack.pop()
        out.append(tuple(iv[2] for iv in stack))
    return out


def _join(a, b):
    return b if a is None else (min(a[0], b[0]), max(a[1], b[1]))


def attribute(ops, spans, mirrors) -> dict:
    """{path of span names: [ops, device seconds, idle seconds]} from the
    device's operations (name, start_ns, end_ns), the host's ``rt.`` spans
    (name, start_ns, end_ns, thread, id) and the device's mirrors of them
    {id: (start_ns, end_ns)}."""
    path, hull = {}, {}
    for thread in {s[3] for s in spans}:
        order = sorted((s for s in spans if s[3] == thread),
                       key=lambda s: (s[1], -s[2]))
        stack, parent = [], {}
        for s in order:
            while stack and stack[-1][2] < s[2]:
                stack.pop()
            parent[s[4]] = stack[-1][4] if stack else None
            path[s[4]] = (path[parent[s[4]]] if stack else ()) + (s[0],)
            stack.append(s)
        for s in reversed(order):          # each span after those it holds
            k, up = s[4], parent[s[4]]
            if k in mirrors:
                hull[k] = _join(hull.get(k), mirrors[k])
            if k in hull and up is not None:
                hull[up] = _join(hull.get(up), hull[k])
    intervals = sorted(((lo, hi, k) for k, (lo, hi) in hull.items()),
                       key=lambda iv: len(path[iv[2]]))
    ops = sorted(ops, key=lambda o: o[1])
    merged = _union(ops)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    out: dict = {}
    for (_, s, e), ids in zip(ops, nested_stacks([(o[1], o[2])
                                                  for o in ops], intervals)):
        row = out.setdefault(path[ids[-1]] if ids else (), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (e - s) * 1e-9
    for (s, e), ids in zip(gaps, nested_stacks(gaps, intervals)):
        row = out.setdefault(path[ids[-1]] if ids else (), [0, 0.0, 0.0])
        row[2] += (e - s) * 1e-9
    return out


def events(results):
    """(device operations, ``rt.`` spans, mirrors) of a profile's events,
    as ``attribute`` takes them."""
    from torch.autograd import DeviceType
    ops, spans, mirrors = [], [], {}
    for e in results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(RT):
                spans.append((name, e.start_ns(), e.end_ns(),
                              e.start_thread_id(), e.correlation_id()))
        elif name.startswith(RT):
            mirrors[e.correlation_id()] = (e.start_ns(), e.end_ns())
        elif not e.is_user_annotation():
            ops.append((name, e.start_ns(), e.end_ns()))
    return ops, spans, mirrors


class UserSpans:
    """Profile the device's operations and the host's user-annotated spans
    (no operator), from ``start()`` to ``stop()``, which returns the
    profiler's events."""

    def __init__(self, device):
        from torch.autograd import profiler
        cuda = torch.device(device).type == "cuda"
        self.kind = profiler.profile(use_device="cuda" if cuda else None,
                                     use_kineto=True)
        self.config = self.kind.config(create_trace_id=True)

    def start(self) -> None:
        from torch._C import _autograd
        from torch._C._profiler import RecordScope
        acts = self.kind.kineto_activities
        _autograd._prepare_profiler(self.config, acts)
        _autograd._enable_profiler(self.config, acts,
                                   {RecordScope.USER_SCOPE})

    def stop(self):
        from torch._C import _autograd
        return _autograd._disable_profiler()


def replay(loop, units: int) -> SpanReading | None:
    """Prefill the first ``units`` requests of ``loop``'s window again with
    the port's tracing on, under the profiler; None where the port has no
    tracing.  The tracing module is the one the harness loaded with the
    port: like the rest of the benchmark but the harness, this file
    imports nothing of the port."""
    tracing = sys.modules.get("repro_torch.tracing")
    if tracing is None:
        return None
    from .harness import _sync, request_prompts
    todo = [(r.index, r.prompt_len) for r in loop.records
            if r.in_window][:units]
    if not todo:
        return None
    t0 = time.perf_counter()
    gen = torch.Generator(device=loop.device)
    port, batch = loop.port, loop.traffic.batch
    prof = UserSpans(loop.device)
    tracing.read_counters()
    _sync(loop.device)
    prof.start()
    tracing.enable()
    try:
        for index, length in todo:
            tokens = request_prompts(loop.config, batch, length, loop.seed,
                                     index, loop.device, gen)
            cache, logits = port.prefill[length](port.params,
                                                 {"tokens": tokens})
            torch.argmax(logits[:, -1], dim=-1).cpu()
            del cache, logits
        _sync(loop.device)
    finally:
        tracing.disable()
        results = prof.stop()
    got = SpanReading(len(todo), attribute(*events(results)),
                      tracing.read_counters(), time.perf_counter() - t0)
    print(f"portbench: span slice: {len(todo)} requests, "
          f"{got.seconds:.3f} s", file=sys.stderr, flush=True)
    return got


_last: list = [None, None]          # the reading asked about, its answer


def of(reading) -> SpanReading | None:
    """The span slice of the run whose first slice gave ``reading``: made
    on the first call, kept for the rest of the run's readers."""
    if _last[0] is reading:
        return _last[1]
    from . import harness
    frame = sys._getframe(1)
    while frame is not None and frame.f_code is not harness.run.__code__:
        frame = frame.f_back
    got = None
    if frame is not None:
        run = frame.f_locals
        try:
            loop = run["loop"]
            units = int(run["cell"].spec["trace"]["units"])
        finally:
            # before Python 3.13 ``f_locals`` is a dict kept on the frame:
            # left full, it would keep the port alive past the run's
            # ``del port, loop, slices``, into the check
            if isinstance(run, dict):
                run.clear()
            del run, frame
        got = replay(loop, units)
    _last[:] = [reading, got]
    return got
