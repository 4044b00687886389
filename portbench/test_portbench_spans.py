"""The span slice (``spans.py``) and the readers of its metrics.

``attribute`` is held to hand-made event lists: nested and sibling spans,
gaps inside and between them, a counter's own operation, a span with no
operation of its own, spans on another thread and an operation that
starts before the one before it ends.  Each
reader is held to a hand-made reading.  A traced run on the CPU, with the
profiled slices stubbed and a window of a fixed number of requests, keeps
its records, ``attempted`` and the requests its check samples as they are
without the span metrics, and frees the port before its check.
"""

from __future__ import annotations

import json
import time
import weakref
from pathlib import Path

import pytest

from portbench import harness, spans, trace
from portbench.test_portbench_run import PREFILL, SEED, TINY, tiny_cell

ROOT = Path(__file__).resolve().parents[1]
P, M = "rt.prefill", "rt.moe"
D, E, C = "rt.moe.dispatch", "rt.moe.experts", "rt.moe.combine"

# host spans (name, start, end, thread, id): a prefill on thread 1 holding
# two MoE layers, the first with its three parts and a counter's kernel,
# the second with a counter of a host int (no kernel, no mirror); a
# prefill on thread 2
SPANS = [(P, 0, 100, 1, 1), (M, 10, 60, 1, 2), (D, 10, 30, 1, 3),
         (spans.COUNT, 20, 25, 1, 4), (E, 30, 45, 1, 5), (C, 45, 60, 1, 6),
         (M, 60, 90, 1, 7), (D, 60, 90, 1, 8), (spans.COUNT, 70, 71, 1, 9),
         (P, 0, 1000, 2, 10)]
# device operations (name, start, end); "norm" starts before "gather" ends,
# as a kernel launched for programmatic dependent launch may
OPS = [("embed", 1000, 1100), ("route", 1100, 1300), ("sum", 1300, 1320),
       ("route", 1320, 1330), ("bmm", 1400, 1500), ("bmm", 1550, 1600),
       ("gather", 1600, 1700), ("norm", 1690, 1750), ("route", 1800, 1900),
       ("logits", 1900, 2000), ("argmax", 3000, 3100),
       ("other", 3100, 3200), ("late", 3300, 3400)]
# the device's mirror of each span over the operations launched directly
# in it (the second MoE layer launches none itself)
MIRRORS = {1: (1000, 2000), 3: (1100, 1330), 4: (1300, 1320),
           5: (1400, 1600), 6: (1600, 1700), 8: (1800, 1900),
           10: (3100, 3200)}
WANT = {(P,): [4, 360e-9, 50e-9],                 # embed, norm, logits, other
        (P, M): [0, 0.0, 70e-9],                  # 1330-1400
        (P, M, D): [3, 310e-9, 0.0],
        (P, M, D, spans.COUNT): [1, 20e-9, 0.0],
        (P, M, E): [2, 150e-9, 50e-9],            # 1500-1550
        (P, M, C): [1, 100e-9, 0.0],
        (): [2, 200e-9, 1100e-9]}                 # 2000-3000, 3200-3300


def test_attribute_by_hand():
    got = spans.attribute(OPS, SPANS, MIRRORS)
    assert got.keys() == WANT.keys()
    for path, (n, busy, idle) in WANT.items():
        assert got[path][0] == n, path
        assert got[path][1:] == pytest.approx([busy, idle], abs=1e-15), path


def test_a_reading_by_hand():
    r = spans.SpanReading(2, spans.attribute(OPS, SPANS, MIRRORS))
    assert r.device_ms(D) == pytest.approx(1e3 * 310e-9 / 2)
    assert r.device_ms(M) == 0.0
    assert r.idle_ms(M) == pytest.approx(1e3 * 120e-9 / 2)
    assert r.idle_ms(P) == pytest.approx(1e3 * 170e-9 / 2)
    assert r.ops(P) == 5.0                        # 10 operations, no count
    assert r.device_ms("rt.mamba") is None and r.ops("rt.mamba") is None


def test_nested_stacks_outermost_first():
    ivs = [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 9, "d"),
           (20, 30, "e"), (20, 30, "f")]
    queries = [(1, 1), (3, 4), (4, 6), (7, 8), (10, 20), (25, 25), (31, 31)]
    assert spans.nested_stacks(queries, ivs) == [
        ("a",), ("a", "b", "c"), ("a",), ("a", "d"), (), ("e", "f"), ()]


READING = spans.SpanReading(
    2, {(P,): [10, 0.002, 0.0004],
        (P, M, D): [6, 0.010, 0.0],
        (P, M, D, spans.COUNT): [4, 0.001, 0.0],
        (P, M): [0, 0.0, 0.003],
        (P, M, E): [2, 0.008, 0.001],
        (P, M, C): [4, 0.006, 0.0],
        (P, "rt.mamba"): [8, 0.004, 0.002],
        (P, "rt.mamba", "rt.mamba.conv"): [6, 0.012, 0.0],
        (P, "rt.mamba", "rt.mamba.gate"): [4, 0.010, 0.0005]},
    {"moe.pairs_routed": 800, "moe.pairs_kept": 700})


@pytest.mark.parametrize("metric,want", [
    ("launches.prefill", 20.0),
    ("moe_dispatch_ms.prefill", 5.0),
    ("moe_experts_ms.prefill", 4.0),
    ("moe_combine_ms.prefill", 3.0),
    ("moe_idle_ms.prefill", 2.0),
    ("moe_kept_share", 87.5),
    ("mamba_conv_ms.prefill", 6.0),
    ("mamba_gate_ms.prefill", 5.0),
    ("mamba_idle_ms.prefill", 1.25),
])
def test_each_reader_by_hand(metric, want):
    reading = trace.Reading({}, [("prefill", 2, 16)], 1.0, {}, 0.5, [])
    spans._last[:] = [reading, READING]
    try:
        assert harness.metric_reader(metric, ROOT)(reading) == \
            pytest.approx(want)
    finally:
        spans._last[:] = [None, None]


class _StubSlice:
    """A profiled slice that profiles nothing (the CPU has no CUPTI)."""

    def reading(self, cfg, units):
        return trace.Reading(cfg, units, 1.0, {}, 0.5, [])

    def idle_gaps(self):
        return []


def _fixed_window(n: int):
    """``harness.window`` over exactly n requests, the first slice stubbed
    over all of them."""
    def window(loop, seconds, slice_units):
        t0 = time.perf_counter()
        loop.tracing = 1
        for _ in range(n):
            loop.next_unit()
        loop.tracing = 0
        last = max(a for r in loop.records for a in r.arrivals)
        return t0, last, [_StubSlice()]
    return window


def test_the_span_slice_leaves_the_window_s_requests_as_they_were(
        monkeypatch):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = tiny_cell("olmoe-1b-7b", "olmoe-prefill-b4", PREFILL,
                     TINY["decoder"], 3)
    cell.spec["trace"]["units"] = 3
    new = [m for m in bench["per_layer"]
           if m["source"] in ("program_span", "program_counter")]
    monkeypatch.setattr(harness, "window", _fixed_window(5))
    seen = {}
    real_sample, real_replay = harness.sample, spans.replay

    def sample(loop, n, seed):
        seen["records"] = [(r.index, r.prompt_len, len(r.arrivals),
                            r.in_window) for r in loop.records]
        seen["host_prefill"] = len(loop.host_prefill)
        chosen = real_sample(loop, n, seed)
        seen["chosen"] = [r.index for r in chosen]
        return chosen

    def replay(loop, units):
        seen["replayed"] = units
        return real_replay(loop, units)
    monkeypatch.setattr(harness, "sample", sample)
    monkeypatch.setattr(spans, "replay", replay)
    runs = []
    for per_layer in ([], new):
        cell.per_layer = per_layer
        seen.clear()
        spans._last[:] = [None, None]
        result, compared = harness.run(cell, SEED, 0.0, True, "cpu",
                                       time.perf_counter())
        assert result["correct"], json.dumps(compared)
        runs.append((result["attempted"], dict(seen), result["metrics"],
                     spans._last[1]))
    (att0, seen0, metrics0, none), (att1, seen1, metrics1, got) = runs
    assert none is None and "replayed" not in seen0
    assert seen1.pop("replayed") == 3
    assert att1 == att0 and seen1 == seen0
    assert got.requests == 3
    tiny = TINY["decoder"]
    assert got.counters["moe.pairs_routed"] == \
        PREFILL.batch * tiny["n_layers"] * tiny["top_k"] * sum(
            r[1] for r in seen0["records"][:3])
    assert set(metrics1) == {"moe_kept_share"}    # no device operation
    assert 0.0 < metrics1["moe_kept_share"]["value"] <= 100.0
    assert metrics0 == {}


def test_the_span_slice_frees_the_port_before_the_check(monkeypatch):
    """The span readers find the run's loop in ``harness.run``'s frame; the
    port and its loop are still freed before the check, as in a run
    without them."""
    cell = tiny_cell("olmoe-1b-7b", "olmoe-prefill-b4", PREFILL,
                     TINY["decoder"], 3)
    cell.spec["trace"]["units"] = 3
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell.per_layer = [m for m in bench["per_layer"]
                      if m["source"] in ("program_span", "program_counter")]
    monkeypatch.setattr(harness, "window", _fixed_window(5))
    made, alive = [], []
    real_port, real_judge = harness.Port, harness.judge

    def port(*args):
        p = real_port(*args)
        made.append(weakref.ref(p))
        return p

    def judge(*args):
        alive.extend(r() is not None for r in made)
        return real_judge(*args)
    monkeypatch.setattr(harness, "Port", port)
    monkeypatch.setattr(harness, "judge", judge)
    spans._last[:] = [None, None]
    try:
        result, _ = harness.run(cell, SEED, 0.0, True, "cpu",
                                time.perf_counter())
        assert spans._last[1] is not None and "moe_kept_share" in \
            result["metrics"]
    finally:
        spans._last[:] = [None, None]
    assert alive == [False]
