"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) on its two main paths, the MT-WND
serving pool at full width and the qwen2.5-3b decoder LM's serving path at
full width and depth, in phases that each print a line and raise on
failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every CUDA kernel from ``src/repro_torch/csrc`` (nvcc,
   sm_90a, one nvcc per source, all started together);
3. kernels against their plain PyTorch versions: embedding_bag at the live
   path's shapes (V 200,000, D 64, bag 8, n_bags 1..256), fp32 and bf16,
   weighted and unweighted, indices over the whole vocabulary, over
   [0, 100) and repeated; flash_attention at the LM prefill's shape (B 4,
   S 2000, H 16, KH 2, D 128, causal) and window 256, MHA, MQA, D 80, S 1,
   non-causal S 333 and packed q/k/v views; decode_attention at the decode
   step's shape (B 4, T 2048, KH 2, G 8, D 128, the last 48 slots empty)
   and T 1999, MQA with D 80, MHA, empty slots at the front and a cache
   with no valid slot; each in fp32 and bf16;
4. MT-WND full-width forward, kernel path against plain path, per batch
   bucket 1..32, with forward times: eager (CUDA events, median of 30) and
   device-only (replayed from a CUDA graph, so without the host's launch
   cost);
5. live serving: ClusterEngine over three full-width cell types serves 80
   requests; prints the QoS rate and service percentiles;
6. RIBBON's ask/tell loop over the live pool (up to 16 rounds), and its GP
   posterior on the card against the same fit on the CPU;
7. LM serving: qwen2.5-3b at full width and depth (36 layers) with random
   weights from a seed serves 4 requests of 2000 prompt tokens: prefill
   (max_len 2048) then 48 greedy decode steps.  First in fp32, the kernel
   path against the plain path teacher-forced on the kernel path's tokens
   (prefill and every step's logits within 1e-4 x max |logits|, the same
   greedy tokens); then in bf16, the reference's serving type, twice, with
   prefill ms, decode ms per step and tokens/s of the second, and the
   kernel path's agreement with the plain path's greedy tokens (printed);
   then device-only prefill and decode-step times from CUDA graphs.

Launch counts are set to 0 just before phase 5 and read after phase 6
(every MT-WND forward makes 8 embedding-bag launches), and set to 0 again
just before phase 7 and read after its serving runs (one flash-attention
launch per layer per prefill, one decode-attention launch per layer per
decode step).  Then one JSON line gives each kernel's launches, error
against its plain version and times at its path's shape: kernel, plain
version and library call device-only (CUDA graph) and eager, and the bound
(bytes over the card's memory rate or flops over its bf16 tensor rate,
whichever is larger).  The last line is ``{"ok": true, "device": {...}}``.
Float32 matrix products run in full float32 (TF32 off), as the JAX
reference computes.  Exits non-zero, with no result line, without a card
or outside the repository.
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

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import RibbonOptimizer, SearchSpace  # noqa: E402
from repro_torch.core.gp import gp_posterior  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                     embedding_bag_ref, flash_attention_ref)
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models.paper_models import (MTWND_PRESETS,  # noqa: E402
                                             make_random_batch, mtwnd_apply,
                                             mtwnd_init)
from repro_torch.serving.engine import DEFAULT_CELLS, ClusterEngine  # noqa: E402
from repro_torch.models.transformer import get_model  # noqa: E402
from repro_torch.serving.workload import WorkloadSpec  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor rate (data sheet)
# Kernel vs plain version: both add the same float32 values in the same
# order with separate roundings, so they are expected to agree exactly;
# the gates allow one float32 rounding at these magnitudes and one bf16
# rounding of the output.
TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
FORWARD_TOL = 1e-5             # MT-WND kernel path vs plain path
GP_TOL = (1e-5, 1e-4)          # GP mean, std: card vs CPU (float32 Cholesky)
BUCKETS = (1, 2, 4, 8, 16, 32)
CFG = MTWND_PRESETS["full"]
# Attention kernels vs their plain versions at inputs ~ N(0, 0.5^2): fp32
# differs by summation order and expf only; in bf16 the plain version
# rounds the probabilities to bf16 before the p·v product and the kernels
# keep them in fp32 (the bf16 tolerance of tests/test_kernels.py).
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 is also held against the plain version run in fp32 on the same
# inputs ("exact").  The kernel rounds its fp32 result once, to the bf16
# value nearest to a number within the fp32 gap (2.4e-7 at these shapes)
# of exact; the plain version rounds p first, so per element it lies at
# least as far from exact, less twice that gap.  The kernel's max and
# mean distance to exact may exceed the plain version's by BF16_SLACK
# only.  A key tile or split left out moves an output by about
# 0.5·sqrt(64)/T, some 2e-3 at T 2000, and fails the mean gate.
BF16_SLACK = 1e-5
# (label, B, S, H, KH, D, causal, window)
FLASH_CASES = [("prefill", 4, 2000, 16, 2, 128, True, 0),
               ("window 256", 2, 1000, 16, 2, 128, True, 256),
               ("MHA", 2, 512, 8, 8, 64, True, 0),
               ("MQA", 2, 512, 8, 1, 128, True, 0),
               ("D 80", 2, 384, 4, 4, 80, True, 0),
               ("S 1", 4, 1, 16, 2, 128, True, 0),
               ("non-causal S 333", 1, 333, 4, 2, 128, False, 0),
               ("packed qkv views", 2, 257, 8, 2, 128, True, 0)]
# (label, B, T, KH, G, D, empty slots: "tail", "head" or "all", how many)
DECODE_CASES = [("decode", 4, 2048, 2, 8, 128, "tail", 48),
                ("T 1999", 4, 1999, 2, 8, 128, "tail", 48),
                ("MQA D 80", 2, 777, 1, 16, 80, "tail", 5),
                ("MHA", 2, 512, 4, 1, 64, "tail", 0),
                ("T 50, one split", 2, 50, 2, 8, 128, "tail", 3),
                ("ring wrapped", 4, 2048, 2, 8, 128, "head", 100),
                ("no valid slot", 1, 300, 1, 4, 128, "all", 300)]
LM_ARCH = "qwen2.5-3b"
LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_STEPS = 4, 2000, 2048, 48
LM_TOL = 1e-4                  # kernel vs plain path, x max |logits|, fp32


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


def _normal(gen, shape, dtype):
    return (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)


def _flash_inputs(gen, case, dtype):
    label, b, s, h, kh, d, _, _ = case
    if label == "packed qkv views":
        # q, k and v as strided views of one projection, as a fused QKV
        # matmul would leave them.
        qkv = _normal(gen, (b, s, h + 2 * kh, d), dtype)
        return qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    return (_normal(gen, (b, s, h, d), dtype),
            _normal(gen, (b, s, kh, d), dtype),
            _normal(gen, (b, s, kh, d), dtype))


def _decode_inputs(gen, case, dtype):
    _, b, t, kh, g, d, where, n_empty = case
    pos = torch.arange(t, device="cuda", dtype=torch.int32)
    if where == "tail":
        pos[t - n_empty:] = -1
    elif where == "head":
        pos[:n_empty] = -1
    else:
        pos[:] = -1
    return (_normal(gen, (b, 1, kh * g, d), dtype),
            _normal(gen, (b, t, kh, d), dtype),
            _normal(gen, (b, t, kh, d), dtype), pos)


def _gate(name: str, got, want, exact) -> float:
    """Hold a kernel's output ``got`` against its plain version's ``want``
    (max |diff| <= ATTN_TOL), and in bf16 against ``exact``, the plain
    version in fp32 on the same inputs (max and mean |diff| within
    BF16_SLACK of the plain version's own).  Returns max |got - want|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: bad output {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    if not err <= ATTN_TOL[got.dtype]:
        raise AssertionError(f"{name}: max |diff| {err} > {ATTN_TOL[got.dtype]}")
    if got.dtype == torch.bfloat16:
        mine = (got.float() - exact).abs()
        plain = (want.float() - exact).abs()
        for stat in (torch.max, torch.mean):
            a, b = stat(mine).item(), stat(plain).item()
            if not a <= b + BF16_SLACK:
                raise AssertionError(
                    f"{name}: {stat.__name__} |diff| to fp32 {a} > the plain "
                    f"version's {b} + {BF16_SLACK}")
    return err


def attention_phase() -> dict:
    """flash_attention and decode_attention against their plain versions;
    returns each kernel's largest error per type."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"flash_attention": {}, "decode_attention": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            label, causal, window = case[0], case[6], case[7]
            q, k, v = _flash_inputs(gen, case, dtype)
            err = _gate(f"flash_attention {label} {dtype}",
                        ops.flash_attention(q, k, v, causal=causal,
                                            window=window),
                        flash_attention_ref(q, k, v, causal=causal,
                                            window=window),
                        flash_attention_ref(q.float(), k.float(), v.float(),
                                            causal=causal, window=window))
            w = worst["flash_attention"]
            w[dtype] = max(w.get(dtype, 0.0), err)
        for case in DECODE_CASES:
            q, k, v, pos = _decode_inputs(gen, case, dtype)
            err = _gate(f"decode_attention {case[0]} {dtype}",
                        ops.decode_attention(q, k, v, pos),
                        decode_attention_ref(q, k, v, pos),
                        decode_attention_ref(q.float(), k.float(), v.float(),
                                             pos))
            w = worst["decode_attention"]
            w[dtype] = max(w.get(dtype, 0.0), err)
    for name, cases in (("flash_attention", FLASH_CASES),
                        ("decode_attention", DECODE_CASES)):
        w = worst[name]
        phase("kernel", f"{name} vs plain: {2 * len(cases)} cases "
                        f"({', '.join(c[0] for c in cases)}; fp32 and bf16) "
                        f"agree, max |diff| {w[torch.float32]:.3g} fp32, "
                        f"{w[torch.bfloat16]:.3g} bf16 (gates "
                        f"{ATTN_TOL[torch.float32]}, "
                        f"{ATTN_TOL[torch.bfloat16]}; bf16 max and mean "
                        f"|diff| to fp32 within {BF16_SLACK} of the plain "
                        f"version's)")
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


def _greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def _lm_gate(name: str, got, want) -> float:
    """Kernel path's logits against the plain path's: finite, within
    LM_TOL x max |logits|, the same greedy tokens.  Returns the relative
    difference."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"LM {name}: non-finite logits")
    diff = (got - want).abs().max().item()
    top = got.abs().max().item()
    if not diff <= LM_TOL * top:
        raise AssertionError(f"LM {name}: max |diff| {diff} > {LM_TOL} x "
                             f"max |logits| {top}")
    if not torch.equal(_greedy(got), _greedy(want)):
        raise AssertionError(f"LM {name}: greedy tokens differ")
    return diff / top


def lm_fp32(api, params, tokens, prefill_step) -> None:
    """fp32 kernel path against the plain path, teacher-forced on the
    kernel path's tokens."""
    cache_k, logits_k = prefill_step(params, {"tokens": tokens})
    cache_p, logits_p = api.prefill(params, tokens, LM_MAX_LEN,
                                    use_kernel=False)
    if logits_k.shape != (LM_BATCH, 1, api.cfg.vocab_size):
        raise AssertionError(f"LM prefill logits {tuple(logits_k.shape)}")
    worst = _lm_gate("fp32 prefill", logits_k, logits_p)
    tok = _greedy(logits_k)
    for i in range(LM_STEPS):
        logits_k, cache_k = api.decode_step(params, cache_k, tok)
        logits_p, cache_p = api.decode_step(params, cache_p, tok,
                                            use_kernel=False)
        worst = max(worst, _lm_gate(f"fp32 decode step {i}", logits_k,
                                    logits_p))
        tok = _greedy(logits_k)
    phase("lm", f"{LM_ARCH} fp32, {LM_BATCH} x {LM_PROMPT} prompt tokens, "
                f"{LM_STEPS} decode steps: kernel path vs plain path max "
                f"|diff| {worst:.3g} x max |logits| (gate {LM_TOL}), the "
                f"same greedy tokens at all {LM_STEPS + 1} positions")


def lm_serve(params, tokens, prefill_step, serve_step):
    """One bf16 serving run on the kernel path: prefill, then greedy decode
    steps; returns (prefill ms, decode ms per step, tokens (B, 1 + steps))."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = prefill_step(params, {"tokens": tokens})
    tok = _greedy(logits)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(LM_STEPS):
        tok, cache = serve_step(params, cache, tok)
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3 / LM_STEPS, torch.cat(out, 1)


def lm_agreement(api, params, tokens, served) -> float:
    """Share of the served greedy tokens that the plain path, fed the
    same prefixes, also picks."""
    cache, logits = api.prefill(params, tokens, LM_MAX_LEN, use_kernel=False)
    same = [_greedy(logits) == served[:, :1]]
    for i in range(LM_STEPS):
        logits, cache = api.decode_step(params, cache, served[:, i:i + 1],
                                        use_kernel=False)
        same.append(_greedy(logits) == served[:, i + 1:i + 2])
    return torch.cat(same, 1).float().mean().item()


def lm_phase(api, params, tokens) -> dict:
    """The LM serving path: fp32 kernel vs plain, then bf16 serving runs.
    Returns the prefills and decode steps taken on the kernel path and the
    bf16 timings."""
    prefill_step = make_prefill_step(api, LM_MAX_LEN)
    serve_step = make_decode_step(api)
    lm_fp32(api, params, tokens, prefill_step)
    params.to(torch.bfloat16)
    runs = [lm_serve(params, tokens, prefill_step, serve_step)
            for _ in range(2)]
    prefill_ms, step_ms, served = runs[-1]
    if not torch.equal(runs[0][2], served):
        raise AssertionError("LM bf16: two serving runs gave other tokens")
    agree = lm_agreement(api, params, tokens, served)
    phase("lm", f"{LM_ARCH} bf16 serving (second of 2 runs, eager): "
                f"prefill {prefill_ms:.2f} ms for {LM_BATCH} x {LM_PROMPT} "
                f"tokens, decode {step_ms:.3f} ms per step = "
                f"{LM_BATCH * 1e3 / step_ms:.1f} tokens/s; kernel path "
                f"agrees with the plain path on {agree:.4f} of "
                f"{served.numel()} greedy tokens (printed, not gated)")
    # kernel-path runs: the fp32 comparison and the bf16 serving runs
    n_runs = 1 + len(runs)
    return {"prefills": n_runs, "steps": n_runs * LM_STEPS,
            "prefill_ms": prefill_ms, "step_ms": step_ms}


def lm_device_phase(api, params, tokens, lm: dict) -> None:
    """Device-only bf16 prefill and decode-step times (CUDA graph replays,
    launched outside the counted run) against the eager times."""
    cache, logits = api.prefill(params, tokens, LM_MAX_LEN)
    tok = _greedy(logits)
    step_dev = graph_ms(lambda: api.decode_step(params, cache, tok),
                        calls=4, replays=5)
    prefill_dev = graph_ms(lambda: api.prefill(params, tokens, LM_MAX_LEN),
                           calls=1, replays=3)
    phase("lm", f"bf16 device-only (CUDA graph): prefill {prefill_dev:.2f} "
                f"ms, decode step {step_dev:.3f} ms; so the card idles "
                f"{1 - prefill_dev / lm['prefill_ms']:.1%} of an eager "
                f"prefill and {1 - step_dev / lm['step_ms']:.1%} of an "
                f"eager decode step")


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


def _valid_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks let through: the work this input needs."""
    q_pos = torch.arange(s, device="cuda")[:, None]
    k_pos = torch.arange(t, device="cuda")[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device="cuda")
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return int(mask.sum())


def _attention_line(name, launches, worst, fns, graph_calls, eager_iters,
                    flops, nbytes, err, shape) -> dict:
    times = {key: (graph_ms(fn, *graph_calls), event_ms(fn, eager_iters))
             for key, fn in fns.items()}
    by_ops, by_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": {"flash_attention":
                         "src/repro/kernels/flash_attention.py:76",
                         "decode_attention":
                         "src/repro/kernels/decode_attention.py:61"}[name],
            "launches": launches,
            "max_abs_err": max(err, *worst.values()),
            "max_abs_err_fp32": worst[torch.float32],
            "ms": times["ms"][0], "plain_ms": times["plain_ms"][0],
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": times["library_ms"][0],
            "eager_ms": times["ms"][1], "eager_plain_ms": times["plain_ms"][1],
            "eager_library_ms": times["library_ms"][1],
            "flops": flops, "bytes": nbytes, "shape": shape}


def flash_line(launches: int, worst: dict) -> dict:
    """flash_attention at one layer of the LM prefill: B 4, S 2000, H 16,
    KH 2, D 128, causal, bf16.  Library: SDPA with enable_gqa."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    case = FLASH_CASES[0]
    _, b, s, h, kh, d, causal, window = case
    q, k, v = _flash_inputs(gen, case, torch.bfloat16)
    err = _gate("flash_attention line", ops.flash_attention(q, k, v),
                flash_attention_ref(q, k, v),
                flash_attention_ref(q.float(), k.float(), v.float()))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns = {"ms": lambda: ops.flash_attention(q, k, v),
           "plain_ms": lambda: flash_attention_ref(q, k, v),
           "library_ms": lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True)}
    flops = 4 * d * b * h * _valid_pairs(s, s, causal, window)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    return _attention_line("flash_attention", launches, worst, fns, (4, 3),
                           10, flops, nbytes, err,
                           f"B {b}, S {s}, H {h}, KH {kh}, D {d}, causal, "
                           "bf16")


def decode_line(launches: int, worst: dict) -> dict:
    """decode_attention at one layer of an LM decode step: B 4, T 2048,
    KH 2, G 8, D 128, the last 48 slots empty, bf16.  Library: SDPA with
    enable_gqa and a boolean pos >= 0 mask."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    case = DECODE_CASES[0]
    _, b, t, kh, g, d, _, _ = case
    q, k, v, pos = _decode_inputs(gen, case, torch.bfloat16)
    err = _gate("decode_attention line", ops.decode_attention(q, k, v, pos),
                decode_attention_ref(q, k, v, pos),
                decode_attention_ref(q.float(), k.float(), v.float(), pos))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = (pos >= 0).view(1, 1, 1, t)
    fns = {"ms": lambda: ops.decode_attention(q, k, v, pos),
           "plain_ms": lambda: decode_attention_ref(q, k, v, pos),
           "library_ms": lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask, enable_gqa=True)}
    n_valid = int((pos >= 0).sum())
    flops = 4 * d * b * kh * g * n_valid
    nbytes = 2 * (2 * q.numel() + 2 * b * n_valid * kh * d) + 4 * t
    return _attention_line("decode_attention", launches, worst, fns,
                           (50, 20), 500, flops, nbytes, err,
                           f"B {b}, T {t} ({n_valid} valid), KH {kh}, G {g}, "
                           f"D {d}, bf16")


def reset_counts() -> None:
    for fn in (embedding_bag_cuda, flash_attention_cuda,
               decode_attention_cuda):
        fn.launches = 0


def main() -> int:
    name = device_phase()
    build_phase()
    worst = kernel_phase()
    attn_worst = attention_phase()
    forward_phase()

    # Main path 1: the MT-WND serving pool and RIBBON's search over it.
    engine = ClusterEngine("mtwnd", DEFAULT_CELLS, seed=0, device="cuda")
    wl = WorkloadSpec(seed=0, rate_qps=150.0, median_batch=8,
                      max_batch=32).realize(80)
    reset_counts()
    engine.warmup(max_batch=BUCKETS[-1])
    forwards = len(DEFAULT_CELLS) * len(BUCKETS)
    forwards += serve_phase(engine, wl)
    forwards += ribbon_phase(engine, wl)
    bag_launches = embedding_bag_cuda.launches
    if bag_launches == 0 or bag_launches != CFG["n_tables"] * forwards:
        raise AssertionError(f"embedding_bag launched {bag_launches} times "
                             f"on the main path, expected {CFG['n_tables']} "
                             f"x {forwards} forwards")
    phase("launches", f"embedding_bag: {bag_launches} launches on the MT-WND "
                      f"path = {CFG['n_tables']} x {forwards} forwards")
    del engine

    # Main path 2: the decoder LM's serving path at full width and depth.
    api = get_model(get_arch(LM_ARCH))
    n_layers = api.cfg.n_layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init_params(gen, torch.float32, "cuda")
    tokens = torch.randint(0, api.cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    phase("lm", f"{LM_ARCH}: {n_layers} layers, d_model "
                f"{api.cfg.d_model}, {api.cfg.n_heads} heads over "
                f"{api.cfg.n_kv_heads} KV heads, d_ff {api.cfg.d_ff}, vocab "
                f"{api.cfg.vocab_size}; "
                f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
                "parameters, random from seed 0")
    reset_counts()
    lm = lm_phase(api, params, tokens)
    flash_launches = flash_attention_cuda.launches
    decode_launches = decode_attention_cuda.launches
    if flash_launches != n_layers * lm["prefills"] or \
            decode_launches != n_layers * lm["steps"] or \
            embedding_bag_cuda.launches != 0:
        raise AssertionError(
            f"LM path launches: flash_attention {flash_launches}, expected "
            f"{n_layers} x {lm['prefills']} prefills; decode_attention "
            f"{decode_launches}, expected {n_layers} x {lm['steps']} steps")
    phase("launches", f"flash_attention: {flash_launches} launches on the LM "
                      f"path = {n_layers} x {lm['prefills']} prefills; "
                      f"decode_attention: {decode_launches} = {n_layers} x "
                      f"{lm['steps']} decode steps")
    lm_device_phase(api, params, tokens, lm)
    del params
    torch.cuda.empty_cache()

    lines = [kernel_line(bag_launches, worst),
             flash_line(flash_launches, attn_worst["flash_attention"]),
             decode_line(decode_launches, attn_worst["decode_attention"])]
    for line in lines:
        phase("kernel", f"{line['name']} at its path's shape, device-only "
                        f"(CUDA graph): kernel {line['ms']:.5f} ms, plain "
                        f"{line['plain_ms']:.5f} ms, library "
                        f"{line['library_ms']:.5f} ms, bound "
                        f"{line['bound_ms']:.6f} ms ({line['bound_by']}); "
                        f"eager: kernel {line['eager_ms']:.5f} ms, plain "
                        f"{line['eager_plain_ms']:.5f} ms, library "
                        f"{line['eager_library_ms']:.5f} ms")
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
