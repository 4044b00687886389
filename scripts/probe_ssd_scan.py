#!/usr/bin/env python
"""Quick check of the SSD-scan CUDA kernel alone, on one CUDA card.

    python scripts/probe_ssd_scan.py

Builds ``src/repro_torch/csrc/ssd_scan.cu`` (nvcc, sm_90a), prints what
ptxas reports (registers, spills), then at mamba2-130m's and zamba2-2.7b's
prefill shapes (x, b, c as views of one packed conv output), a ragged L,
L 1, G 2 and a small case, in fp32 and bf16, runs the kernel and its plain
version (``kernels.ref.ssd_scan_ref``) on the same inputs and prints y's
and the final state's max |diff| relative to max |want|; in bf16 also each
side's max and mean |diff| to the plain version run in fp32.  At the two
model shapes it prints the kernel's eager time (CUDA events, mean of 10)
and one eager call of the plain version.  It gates nothing: ``chip_smoke.py``
holds the kernel to its gates.  A short first call for work on the kernel
alone, which ``chip_smoke.py`` takes minutes to reach.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_ref  # noqa: E402

# (B, L, H, P, G, N, x/b/c as views of one packed tensor)
CASES = [(4, 2048, 24, 64, 1, 128, True), (4, 2048, 80, 64, 1, 64, True),
         (2, 2000, 8, 64, 1, 128, False), (2, 1, 8, 64, 1, 128, False),
         (2, 300, 8, 64, 2, 64, False), (1, 100, 4, 16, 1, 16, False)]


def inputs(gen, b, l, h, p, g, n, packed, dtype):
    xbc = (torch.randn(b, l, h * p + 2 * g * n, generator=gen, device="cuda")
           * 0.5).to(dtype)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    if not packed:
        x, bm, cm = x.contiguous(), bm.contiguous(), cm.contiguous()
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda"))
    a_log = torch.log(torch.linspace(1, 16, h, device="cuda"))
    return x, dt, a_log, bm, cm


def eager_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    log = _build.build(["ssd_scan"])["ssd_scan"]
    print(f"build {time.perf_counter() - t0:.2f} s")
    print("\n".join(ln for ln in log.splitlines() if "registers" in ln
                    or "spill" in ln))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = inputs(gen, *case, dtype)
            y, s = ops.ssd_scan(*args)
            y_want, s_want = ssd_scan_ref(*args)
            torch.cuda.synchronize()
            top = y_want.float().abs().max().item()
            rel_y = (y.float() - y_want.float()).abs().max().item() / top
            rel_s = ((s - s_want).abs().max() / s_want.abs().max()).item()
            line = (f"{case} {dtype}: y {rel_y:.3g}, state {rel_s:.3g} "
                    f"x max |want| (max |y| {top:.3g})")
            if dtype == torch.bfloat16:
                x, dt, a_log, b, c = args
                exact = ssd_scan_ref(x.float(), dt, a_log, b.float(),
                                     c.float())[0]
                for name, got in (("kernel", y), ("plain", y_want)):
                    e = (got.float() - exact).abs()
                    line += (f"; {name} to fp32: max {e.max().item():.4g}, "
                             f"mean {e.mean().item():.4g}")
            print(line, flush=True)
            if case[1] == 2048:
                ops.ssd_scan(*args)
                print(f"    kernel {eager_ms(lambda: ops.ssd_scan(*args), 10)}"
                      f" ms, plain {eager_ms(lambda: ssd_scan_ref(*args), 1)}"
                      " ms (eager)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
