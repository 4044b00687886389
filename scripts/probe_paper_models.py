#!/usr/bin/env python
"""Where the time of a paper model's forward goes, on one CUDA card.

    python scripts/probe_paper_models.py [--models dien candle ...]
                                         [--buckets 1 8 32]

For each model at full width (fp32, TF32 off, random weights from seed 0)
and each batch bucket: the eager forward timed three ways, each the median
of single runs (CUDA events around the call, as ``chip_smoke.py`` phase
4b; the host clock between two synchronisations, as
``ServingCell.execute`` times a served query), the device-only time
(replays of a CUDA graph), and a ``torch.profiler`` trace of five eager
forwards: the kernels launched per forward, the device's busy time and
idle share, and the top kernels by device time.  Then the eager timing
again right after a forward on the CPU at bucket 2 (as phase 4b runs one),
to see whether that CPU work slows the launches after it.  Prints the
card's name and power limit.  No gate: a measurement.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.models import paper_models as pm  # noqa: E402


def events_ms(fn, runs: int) -> float:
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, runs: int) -> float:
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def graph_ms(fn, calls: int, replays: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def trace(fn, reps: int = 5):
    """(kernels per forward, device busy ms per forward, wall ms per
    forward, top kernels by device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    by_name = defaultdict(lambda: [0, 0.0])
    n = 0
    busy = 0.0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        n += 1
        busy += us
        by_name[evt.name][0] += 1
        by_name[evt.name][1] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    return n / reps, busy / 1e3 / reps, wall, [
        (name[:60], cnt // reps, us / 1e3 / reps) for name, (cnt, us) in top]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+",
                    default=["candle", "resnet50", "vgg19", "dien"])
    ap.add_argument("--buckets", nargs="+", type=int, default=[1, 8, 32])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for name in args.models:
        spec = pm.PAPER_MODELS[name]
        model = spec.init(torch.Generator(device="cuda").manual_seed(0),
                          "full", "cuda")
        for b in args.buckets:
            batch = pm.make_random_batch(name, "full", b, device="cuda")

            def fn():
                return spec.apply(model, batch)

            for _ in range(3):
                fn()
            once = events_ms(fn, 3)
            runs = int(min(30, max(5, 300.0 / max(once, 1e-3))))
            ev = events_ms(fn, runs)
            host = host_ms(fn, runs)
            dev = graph_ms(fn, calls=int(min(20, max(2, 100.0 / once))))
            n, busy, wall, top = trace(fn)
            print(f"[probe] {name} bucket {b}: eager {ev:.4f} ms (events) / "
                  f"{host:.4f} ms (host clock), median of {runs}; "
                  f"device-only {dev:.4f} ms (CUDA graph); profiled: "
                  f"{n:.0f} kernels a forward, device busy {busy:.4f} of "
                  f"{wall:.4f} ms (idle {100 * (1 - busy / wall):.1f} %); "
                  "top: " + "; ".join(f"{k} x{c} {ms:.4f} ms"
                                      for k, c, ms in top)
                  + f"; on {smi}", flush=True)
        batch = pm.make_random_batch(name, "full", 2, device="cuda")
        cpu_model = spec.init(torch.Generator().manual_seed(0), "full",
                              "cpu")
        spec.apply(cpu_model, {k: v.cpu() for k, v in batch.items()})
        ev = events_ms(lambda: spec.apply(model, batch), 10)
        host = host_ms(lambda: spec.apply(model, batch), 10)
        print(f"[probe] {name} bucket 2 right after a CPU forward: eager "
              f"{ev:.4f} ms (events) / {host:.4f} ms (host clock); on {smi}",
              flush=True)
        del model, cpu_model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
