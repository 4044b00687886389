#!/usr/bin/env python
"""Quick check of the flash- and decode-attention CUDA kernels alone, on
one CUDA card.

    python scripts/probe_attention.py

Builds ``src/repro_torch/csrc/flash_attention.cu`` and
``decode_attention.cu`` (nvcc, sm_90a), prints what ptxas reports
(registers, shared memory, spills), then runs every flash and decode case
of ``chip_smoke.py`` in fp32 and bf16 through ``chip_smoke._gate`` (the
kernel against its plain version, and in bf16 against the plain version in
fp32), printing each case's result instead of stopping at the first
failure.  Then, in bf16 at the shapes the LM paths give the kernels
(qwen2.5-3b's prefill and decode step, zamba2-2.7b's shared block), it
prints the kernel's and SDPA's device-only times (CUDA graph replays) and
the bound.  Exits 1 if any case failed.  A short first call for work on
the attention kernels, which ``chip_smoke.py`` takes minutes to reach.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                     flash_attention_ref)

# (label, case): the kernels at their paths' shapes.
FLASH_TIMED = [("qwen2.5-3b prefill", smoke.FLASH_CASES[0]),
               ("zamba2-2.7b prefill", ("zamba2", 4, 2048, 32, 32, 80, True,
                                        4096, 2048))]
DECODE_TIMED = [("qwen2.5-3b step", smoke.DECODE_CASES[0]),
                ("zamba2-2.7b step", ("zamba2", 4, 2096, 32, 1, 80, "tail",
                                      48))]


def check_cases() -> int:
    gen = torch.Generator(device="cuda").manual_seed(3)
    failed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for case in smoke.FLASH_CASES:
            label, causal, window = case[0], case[6], case[7]
            q, k, v = smoke._flash_inputs(gen, case, dtype)
            failed += report(
                f"flash {label} {dtype}",
                lambda: ops.flash_attention(q, k, v, causal=causal,
                                            window=window),
                lambda: flash_attention_ref(q, k, v, causal=causal,
                                            window=window),
                lambda: flash_attention_ref(q.float(), k.float(), v.float(),
                                            causal=causal, window=window))
        for case in smoke.DECODE_CASES:
            q, k, v, pos = smoke._decode_inputs(gen, case, dtype)
            failed += report(
                f"decode {case[0]} {dtype}",
                lambda: ops.decode_attention(q, k, v, pos),
                lambda: decode_attention_ref(q, k, v, pos),
                lambda: decode_attention_ref(q.float(), k.float(), v.float(),
                                             pos))
    return failed


def report(name, kernel, plain, exact) -> int:
    try:
        got = kernel()
        want, ref = plain(), exact()
        err = smoke._gate(name, got, want, ref)
        mine = (got.float() - ref).abs()
        theirs = (want.float() - ref).abs()
        print(f"ok   {name}: max |diff| {err:.3g}; to fp32 max "
              f"{mine.max().item():.3g} (plain {theirs.max().item():.3g}), "
              f"mean {mine.mean().item():.3g} (plain "
              f"{theirs.mean().item():.3g})", flush=True)
        return 0
    except (AssertionError, RuntimeError, ValueError) as exc:
        print(f"FAIL {name}: {exc}", flush=True)
        return 1


def time_shapes() -> None:
    gen = torch.Generator(device="cuda").manual_seed(4)
    for label, case in FLASH_TIMED:
        _, b, s, h, kh, d, causal, window, _ = case
        q, k, v = smoke._flash_inputs(gen, case, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        flops = 4 * d * b * h * smoke._valid_pairs(s, s, causal, window)
        ms = smoke.graph_ms(lambda: ops.flash_attention(q, k, v,
                                                        window=window), 4, 3)
        lib = smoke.graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 4, 3)
        bound = flops / smoke.BF16_FLOPS_PER_S * 1e3
        print(f"flash {label}: kernel {ms:.5f} ms, SDPA {lib:.5f} ms "
              f"(window ignored), bound {bound:.5f} ms (operations, "
              f"{flops:.4g} flop)", flush=True)
    for label, case in DECODE_TIMED:
        q, k, v, pos = smoke._decode_inputs(gen, case, torch.bfloat16)
        _, b, t, kh, g, d, _, _ = case
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = (pos >= 0).view(1, 1, 1, t)
        n_valid = int((pos >= 0).sum())
        nbytes = 2 * (2 * q.numel() + 2 * b * n_valid * kh * d) + 4 * t
        ms = smoke.graph_ms(lambda: ops.decode_attention(q, k, v, pos))
        lib = smoke.graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        bound = nbytes / smoke.HBM_BYTES_PER_S * 1e3
        print(f"decode {label}: kernel {ms:.5f} ms, SDPA {lib:.5f} ms, bound "
              f"{bound:.6f} ms (bytes, {nbytes / 1e6:.2f} MB)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    logs = _build.build(["flash_attention", "decode_attention"])
    print(f"build {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        print(name + ":\n" + "\n".join(
            ln for ln in log.splitlines() if "registers" in ln
            or "spill" in ln or "Compiling" in ln or "smem" in ln))
    failed = check_cases()
    time_shapes()
    print(f"{failed} case(s) failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
