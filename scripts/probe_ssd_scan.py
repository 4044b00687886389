#!/usr/bin/env python
"""Quick check of the SSD-scan CUDA kernels alone, on one CUDA card.

    python scripts/probe_ssd_scan.py [--variant FILE.cu] [--scalar FILE.cu]

Builds ``src/repro_torch/csrc/ssd_scan.cu`` (nvcc, sm_90a) and prints what
ptxas reports (registers, spills).  Then holds both routes (bf16: the
tensor-core kernel; fp32: the scalar kernel) to ``chip_smoke.py``'s gates
in its 12 SSD cases, printing each case's error, and times them at
mamba2-130m's and zamba2-2.7b's prefill shapes (x, b, c as views of one
packed conv output), device-only from CUDA graphs, beside the plain
version.  Other sources are built with the same flags and timed beside
them on the same bf16 inputs, each held against the plain version:

* ``--variant FILE.cu``: a source with the repository's ``ssd_scan_bf16``
  entry point (an uncommitted form of the kernel);
* ``--scalar FILE.cu``: a source with the older one-entry interface
  ``ssd_scan_forward(..., dtype, stream)``, such as the scalar kernel that
  ran both types before the tensor-core kernel (``git show
  <commit>:src/repro_torch/csrc/ssd_scan.cu``).

A short first call for work on the kernel alone, which ``chip_smoke.py``
takes minutes to reach.  Exits non-zero if a gate fails.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_ref  # noqa: E402

def load(path: Path, symbol: str, argtypes):
    """Build ``path`` as the repository's kernels are built and return its
    ``symbol``."""
    lib, log = _build.build_variants([path])[path.name]
    print(f"{path}: " + " | ".join(
        ln.strip() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln))
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def caller(fn, extra=()):
    """ops.ssd_scan's CUDA call through another library's ``fn``."""
    def run(x, dt, a_log, b, c):
        bsz, slen, h, p = x.shape
        y = torch.empty_like(x, memory_format=torch.contiguous_format)
        state = torch.empty((bsz, h, p, b.shape[3]), device=x.device)
        rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                c.data_ptr(), y.data_ptr(), state.data_ptr(), bsz, slen, h, p,
                b.shape[2], b.shape[3], *x.stride()[:3], *dt.stride(),
                *b.stride()[:3], *c.stride()[:3], *extra,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError_t {rc}")
        return y, state
    return run


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", type=Path, action="append", default=[])
    parser.add_argument("--scalar", type=Path, action="append", default=[])
    args = parser.parse_args()
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
    others = {f"variant {p.name}": caller(load(p, "ssd_scan_bf16",
                                               ssd_mod._ARGTYPES))
              for p in args.variant}
    others.update({f"scalar {p.name}": caller(load(
        p, "ssd_scan_forward", ssd_mod._ARGTYPES[:-1] + [ctypes.c_int,
                                                        ctypes.c_void_p]),
        extra=(1,)) for p in args.scalar})
    gen = torch.Generator(device="cuda").manual_seed(6)
    failed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for case in smoke.SSD_CASES:
            name = f"{case[0]} {str(dtype)[6:]}"
            try:
                err, rel = smoke._ssd_gate(name, smoke._ssd_inputs(gen, case,
                                                                   dtype))
                print(f"{name}: pass, y max |diff| {err:.4g} "
                      f"({rel:.3g} x max |want|)", flush=True)
            except AssertionError as exc:
                failed += 1
                print(f"{name}: FAIL {exc}", flush=True)
    for case in smoke.SSD_CASES[:2]:
        for dtype in (torch.bfloat16, torch.float32):
            inputs = smoke._ssd_inputs(gen, case, dtype)
            fns = {"kernel": lambda: ops.ssd_scan(*inputs),
                   "plain": lambda: ssd_scan_ref(*inputs)}
            if dtype == torch.bfloat16:
                fns.update({k: (lambda f=f: f(*inputs))
                            for k, f in others.items()})
            want = ssd_scan_ref(*inputs)[0].float()
            for key, fn in fns.items():
                err = (fn()[0].float() - want).abs().max().item()
                calls = (1, 2) if key == "plain" else (10, 5)
                print(f"{case[0]} {str(dtype)[6:]} {key}: "
                      f"{smoke.graph_ms(fn, *calls):.5f} ms device-only, "
                      f"y max |diff| to plain {err:.4g}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
