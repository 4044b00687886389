"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) at full MT-WND width, in phases that
each print a line and raise on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every CUDA kernel from ``src/repro_torch/csrc`` (nvcc,
   sm_90a);
3. embedding_bag kernel against its plain PyTorch version at the live
   path's shapes (V 200,000, D 64, bag 8, n_bags 1..256), fp32 and bf16,
   weighted and unweighted, indices over the whole vocabulary, over
   [0, 100) and repeated;
4. MT-WND full-width forward, kernel path against plain path, per batch
   bucket 1..32, with forward times: eager (CUDA events, median of 30) and
   device-only (replayed from a CUDA graph, so without the host's launch
   cost);
5. live serving: ClusterEngine over three full-width cell types serves 80
   requests; prints the QoS rate and service percentiles;
6. RIBBON's ask/tell loop over the live pool (up to 16 rounds), and its GP
   posterior on the card against the same fit on the CPU.

Launch counts are set to 0 just before phase 5 and read after phase 6:
every kernel of the path must have launched, 8 embedding-bag launches per
MT-WND forward.  Then one JSON line gives each kernel's launches, error
against its plain version and times at the live path's shape: kernel,
plain version and library call device-only (CUDA graph) and eager, and the
bound (bytes over the card's memory rate).  The last line is
``{"ok": true, "device": {...}}``.  Float32 matrix products run in full
float32 (TF32 off), as the JAX reference computes.  Exits non-zero, with no
result line, without a card or outside the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import RibbonOptimizer, SearchSpace  # noqa: E402
from repro_torch.core.gp import gp_posterior  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag_cuda  # noqa: E402
from repro_torch.kernels.ref import embedding_bag_ref  # noqa: E402
from repro_torch.models.paper_models import (MTWND_PRESETS,  # noqa: E402
                                             make_random_batch, mtwnd_apply,
                                             mtwnd_init)
from repro_torch.serving.engine import DEFAULT_CELLS, ClusterEngine  # noqa: E402
from repro_torch.serving.workload import WorkloadSpec  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
# Kernel vs plain version: both add the same float32 values in the same
# order with separate roundings, so they are expected to agree exactly;
# the gates allow one float32 rounding at these magnitudes and one bf16
# rounding of the output.
TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
FORWARD_TOL = 1e-5             # MT-WND kernel path vs plain path
GP_TOL = (1e-5, 1e-4)          # GP mean, std: card vs CPU (float32 Cholesky)
BUCKETS = (1, 2, 4, 8, 16, 32)
CFG = MTWND_PRESETS["full"]


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def event_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back runs,
    after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Device milliseconds per call of ``fn``, with the host's launch cost
    taken out: ``calls`` calls are captured in one CUDA graph, which is
    replayed ``replays`` times between two events."""
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


def median_event_ms(fn, runs: int) -> float:
    """Median device milliseconds of single runs of ``fn``."""
    for _ in range(3):
        fn()
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


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke run needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    phase("device", f"{name}, torch {torch.__version__}, CUDA "
                    f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    print(smi.splitlines()[0], flush=True)
    return name


def build_phase() -> None:
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", f"{name}.cu: " + " | ".join(usage))
    phase("build", f"{len(logs)} kernel source(s) built in {secs:.2f} s")


def kernel_phase() -> float:
    """embedding_bag against its plain version; returns the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    v, d, bag = CFG["vocab"], CFG["emb"], CFG["bag"]
    table32 = torch.randn(v, d, generator=gen, device="cuda")
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        table = table32.to(dtype)
        for n_bags in (1, 8, 32, 256):
            for hi, label in ((v, "full"), (100, "[0,100)"), (v, "repeat")):
                idx = torch.randint(0, hi, (n_bags, bag), generator=gen,
                                    device="cuda", dtype=torch.int32)
                if label == "repeat":
                    idx[:, bag // 2:] = idx[:, :1]
                w = torch.rand(n_bags, bag, generator=gen, device="cuda")
                for weights in (None, w):
                    got = ops.embedding_bag(idx, table, weights)
                    want = embedding_bag_ref(idx, table, weights)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    scale = max(1.0, want.float().abs().max().item())
                    if not err <= TOL[dtype] * scale:
                        raise AssertionError(
                            f"embedding_bag {dtype} n_bags={n_bags} "
                            f"idx={label} weighted={weights is not None}: "
                            f"max |diff| {err} > {TOL[dtype] * scale}")
                    worst = max(worst, err)
    phase("kernel", f"embedding_bag vs plain: 48 cases agree, max |diff| "
                    f"{worst} (gates {TOL[torch.float32]} fp32, "
                    f"{TOL[torch.bfloat16]} bf16, relative to max(1, |sum|))")
    return worst


def forward_phase() -> None:
    """MT-WND full width, kernel path vs plain path per bucket."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = mtwnd_init(gen, "full", device="cuda")
    for b in BUCKETS:
        batch = make_random_batch("mtwnd", "full", b, device="cuda")
        kern = mtwnd_apply(model, batch)
        plain = mtwnd_apply(model, batch, use_kernel=False)
        diff = (kern - plain).abs().max().item()
        if kern.shape != (b, CFG["tasks"]) or not torch.isfinite(kern).all():
            raise AssertionError(f"MT-WND bucket {b}: bad output "
                                 f"{tuple(kern.shape)}")
        if not ((kern >= 0) & (kern <= 1)).all() or diff > FORWARD_TOL:
            raise AssertionError(f"MT-WND bucket {b}: max |diff| {diff}")
        k_ms = median_event_ms(lambda: mtwnd_apply(model, batch), 30)
        p_ms = median_event_ms(
            lambda: mtwnd_apply(model, batch, use_kernel=False), 30)
        k_dev = graph_ms(lambda: mtwnd_apply(model, batch), calls=20)
        phase("forward", f"bucket {b:2d}: max |diff| {diff:.3g}, forward "
                         f"{k_ms:.4f} ms (kernel path) / {p_ms:.4f} ms "
                         f"(plain path), eager median of 30; kernel path "
                         f"device-only {k_dev:.4f} ms (CUDA graph)")
    del model


def serve_phase(engine: ClusterEngine, wl) -> int:
    engine.configure((1, 1, 1))
    rate = engine.serve(wl, qos_latency=0.03)
    lat, waits = engine.served_arrays()
    svc = (lat - waits) * 1e3
    if not 0.0 <= rate <= 1.0 or len(lat) != wl.n_queries:
        raise AssertionError(f"serve: rate {rate}, {len(lat)} records")
    phase("serve", f"pool (1, 1, 1), {wl.n_queries} requests at 150 qps: "
                   f"QoS {rate:.4f} within 30 ms; service p50 "
                   f"{np.percentile(svc, 50):.4f} ms, p99 "
                   f"{np.percentile(svc, 99):.4f} ms; latency p99 "
                   f"{np.percentile(lat * 1e3, 99):.4f} ms")
    return sum(c.n_served for c in engine.cells)


def ribbon_phase(engine: ClusterEngine, wl) -> int:
    space = SearchSpace(bounds=(4, 3, 3),
                        prices=tuple(c.price for c in engine.cell_types))
    opt = RibbonOptimizer(space, qos_target=0.9, patience=6, device="cuda")
    forwards = 0
    for _ in range(16):
        cfg = opt.ask()
        if cfg is None or opt.done:
            break
        engine.configure(cfg)
        rate = engine.serve(wl, qos_latency=0.03)
        forwards += sum(c.n_served for c in engine.cells)
        if not 0.0 <= rate <= 1.0:
            raise AssertionError(f"RIBBON: QoS {rate} for {cfg}")
        opt.tell(cfg, rate)
        phase("ribbon", f"{cfg}: measured QoS {rate:.4f}, "
                        f"${engine.pool_price(cfg):.2f}/h")
    best = opt.trace.best_feasible()
    if best is None:
        raise AssertionError("RIBBON found no feasible pool")
    phase("ribbon", f"best pool {best.config} at ${best.cost:.2f}/h, QoS "
                    f"{best.qos_rate:.4f}, {opt.trace.n_samples} samples")
    # The GP fit on the card against the same fit on the CPU.
    x, y, mask = opt.gp.buffers()
    lattice = torch.tensor(space.enumerate(), dtype=torch.float32,
                           device="cuda")
    mean_d, std_d = gp_posterior(x, y, mask, lattice, opt.gp.denom)
    mean_h, std_h = gp_posterior(x.cpu(), y.cpu(), mask.cpu(), lattice.cpu(),
                                 opt.gp.denom.cpu())
    dm = (mean_d.cpu() - mean_h).abs().max().item()
    ds = (std_d.cpu() - std_h).abs().max().item()
    if dm > GP_TOL[0] or ds > GP_TOL[1]:
        raise AssertionError(f"GP card vs CPU: mean {dm}, std {ds}")
    phase("ribbon", f"GP posterior card vs CPU: max |diff| mean {dm:.3g}, "
                    f"std {ds:.3g} (gates {GP_TOL[0]}, {GP_TOL[1]})")
    return forwards


def kernel_line(launches: int, worst: float) -> dict:
    """embedding_bag at the live path's shape: the 8 tables' lookups of one
    MT-WND forward at batch 32, indices from [0, 100) as the live path
    draws them."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_tables, v, d, bag, n_bags = (CFG["n_tables"], CFG["vocab"], CFG["emb"],
                                   CFG["bag"], 32)
    tables = [torch.randn(v, d, generator=gen, device="cuda")
              for _ in range(n_tables)]
    idx = [torch.randint(0, 100, (n_bags, bag), generator=gen, device="cuda",
                         dtype=torch.int32) for _ in range(n_tables)]
    idx64 = [i.long() for i in idx]
    err = max((ops.embedding_bag(i, t) - embedding_bag_ref(i, t))
              .abs().max().item() for i, t in zip(idx, tables))

    def kernel():
        return [ops.embedding_bag(i, t) for i, t in zip(idx, tables)]

    def plain():
        return [embedding_bag_ref(i, t) for i, t in zip(idx, tables)]

    def library():
        return [F.embedding_bag(i, t, mode="sum") for i, t in zip(idx64, tables)]

    times = {name: (graph_ms(fn), event_ms(fn, 500))
             for name, fn in (("ms", kernel), ("plain_ms", plain),
                              ("library_ms", library))}
    distinct = sum(int(torch.unique(i).numel()) for i in idx)
    nbytes = (n_tables * n_bags * bag * 4 + distinct * d * 4
              + n_tables * n_bags * d * 4)
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag.py:39",
            "launches": launches, "max_abs_err": max(err, worst),
            "ms": times["ms"][0], "plain_ms": times["plain_ms"][0],
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": times["library_ms"][0],
            # one eager call after another: the host's launch cost included
            "eager_ms": times["ms"][1], "eager_plain_ms": times["plain_ms"][1],
            "eager_library_ms": times["library_ms"][1],
            "shape": f"{n_tables} tables x (n_bags {n_bags}, bag {bag}) "
                     f"over ({v}, {d}) fp32, {distinct} distinct rows"}


def main() -> int:
    name = device_phase()
    build_phase()
    worst = kernel_phase()
    forward_phase()

    engine = ClusterEngine("mtwnd", DEFAULT_CELLS, seed=0, device="cuda")
    wl = WorkloadSpec(seed=0, rate_qps=150.0, median_batch=8,
                      max_batch=32).realize(80)
    embedding_bag_cuda.launches = 0
    engine.warmup(max_batch=BUCKETS[-1])
    forwards = len(DEFAULT_CELLS) * len(BUCKETS)
    forwards += serve_phase(engine, wl)
    forwards += ribbon_phase(engine, wl)
    launches = embedding_bag_cuda.launches
    if launches == 0 or launches != CFG["n_tables"] * forwards:
        raise AssertionError(f"embedding_bag launched {launches} times on "
                             f"the main path, expected {CFG['n_tables']} x "
                             f"{forwards} forwards")
    phase("launches", f"embedding_bag: {launches} launches on the main path "
                      f"= {CFG['n_tables']} x {forwards} forwards")

    line = kernel_line(launches, worst)
    phase("kernel", f"embedding_bag at the live shape, 8 tables, device-only "
                    f"(CUDA graph): kernel {line['ms']:.5f} ms, plain "
                    f"{line['plain_ms']:.5f} ms, library "
                    f"{line['library_ms']:.5f} ms, bound "
                    f"{line['bound_ms']:.6f} ms; eager: kernel "
                    f"{line['eager_ms']:.5f} ms, plain "
                    f"{line['eager_plain_ms']:.5f} ms, library "
                    f"{line['eager_library_ms']:.5f} ms")
    print(json.dumps({"kernels": [line]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
