#!/usr/bin/env python
"""Quick check of the FCFS-scan CUDA kernel alone, on one CUDA card.

    python scripts/probe_fcfs_scan.py [--load-change] [--variant FILE.cu]

Builds ``src/repro_torch/csrc/fcfs_scan.cu`` (nvcc, sm_90a) and prints what
ptxas reports for each template instantiation (K slots a thread, and the
policy, telemetry and trace flags): registers, stack frame, spills.  Then
times the chain floor: a microkernel of 1500 (and 15000) dependent warp
steps in three forms, each step's result feeding the next step's compare,
and prints ns a step:

* ``vote``: ``ballot -> redux.min -> fadd``, the kernel's reduction pick;
* ``idle``: ``ballot -> first set bit -> select -> fadd``, a pick from the
  idle ballots alone;
* ``shuffle``: five rounds of two ``__shfl_xor_sync`` and a lexicographic
  compare, the argmin the kernel used before its redesign.

Then holds the kernel to its plain version in ``chip_smoke.py``'s
simulator cases (cold, the routed, warm, traced and telemetry flavours,
and the pick cases), bit for bit, and prints ``chip_smoke.py``'s
``fcfs_scan`` line: each flavour's device-only and eager times at the
search path's batch shape beside its times before the redesign and the
plain version's, its
bound, and one simulator dispatch end to end on the card and on the CPU.
With ``--load-change`` it also runs ``chip_smoke.py``'s paper §5.5 phase
(the load-change adaptation on the card against the CPU).  Each
``--variant FILE.cu`` (a source with ``fcfs_scan_forward``'s C interface,
built with the repository's flags) is checked bit for bit against the
plain version in every flavour at the batch lane's shape and timed there
beside the committed kernel, device-only, in turns (committed, variants,
variants, committed).  Every timing line names the card and its power
limit.  A short first call for work on the kernel alone.  Exits non-zero
if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

CHAIN_SOURCE = r"""
#include <cuda_runtime.h>

namespace {
constexpr unsigned kFull = 0xffffffffu;

// Each form: x is a thread's value, and every step's x depends on the
// previous step's through the whole chain.
__global__ void vote_chain(const float* in, float* out, int steps) {
  const int lane = threadIdx.x & 31;
  float x = in[lane];
  const float d = in[32 + lane];
  for (int i = 0; i < steps; ++i) {
    const unsigned m = __ballot_sync(kFull, x <= 1.0f);
    const unsigned g = __reduce_min_sync(kFull, __float_as_uint(x) + (m & 1u));
    x = __fadd_rn(__uint_as_float(g), d);
  }
  out[lane] = x;
}

__global__ void idle_chain(const float* in, float* out, int steps) {
  const int lane = threadIdx.x & 31;
  float x = in[lane];
  const float d = in[32 + lane];
  for (int i = 0; i < steps; ++i) {
    const unsigned m = __ballot_sync(kFull, x <= 1.0f);
    const int l = __ffs(m | 0x80000000u) - 1;
    x = lane == l ? __fadd_rn(x, d) : x;
  }
  out[lane] = x;
}

__global__ void shuffle_chain(const float* in, float* out, int steps) {
  const int lane = threadIdx.x & 31;
  float x = in[lane];
  const float d = in[32 + lane];
  for (int i = 0; i < steps; ++i) {
    float win = x;
    int slot = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(kFull, win, off);
      const int os = __shfl_xor_sync(kFull, slot, off);
      if (o < win || (o == win && os < slot)) {
        win = o;
        slot = os;
      }
    }
    x = __fadd_rn(win, lane == slot ? d : 0.5f * d);
  }
  out[lane] = x;
}
}  // namespace

extern "C" int chain_floor(int form, const void* in, void* out, int steps,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
  if (form == 0) vote_chain<<<1, 32, 0, s>>>(i, o, steps);
  else if (form == 1) idle_chain<<<1, 32, 0, s>>>(i, o, steps);
  else shuffle_chain<<<1, 32, 0, s>>>(i, o, steps);
  return static_cast<int>(cudaGetLastError());
}
"""
FORMS = ("vote", "idle", "shuffle")

_KERNEL = re.compile(
    r"fcfs_scan_kernelILi(\d+)ELb([01])ELb([01])ELb([01])E")


def instantiation_usage(log: str) -> list[str]:
    """One line per ``fcfs_scan_kernel<K, POLICY, TEL, TRACE>`` from the
    ptxas log: registers, stack frame and spill bytes."""
    rows, name, frame = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = _KERNEL.search(line)
            name = None if m is None else tuple(int(g) for g in m.groups())
        elif name is not None and "stack frame" in line:
            frame = " ".join(line.split())
        elif name is not None and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows[name] = f"{regs} registers, {frame}"
    out = []
    for (k, pol, tel, tr), usage in sorted(rows.items()):
        flags = [f for f, on in (("policy", pol), ("telemetry", tel),
                                 ("trace", tr)) if on] or ["cold"]
        out.append(f"K {k:2d} {'+'.join(flags):25s} {usage}")
    return out


def chain_floor() -> dict:
    """ns a dependent warp step of each form, from the difference of 15000
    and 1500 steps (launch cost out), best of 6; one warp on the card."""
    src = _build.BUILD_DIR / "fcfs_chain_floor.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(CHAIN_SOURCE)
    fn = _build.build_variants([src])[src.name][0].chain_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    gen = torch.Generator().manual_seed(0)
    inp = torch.cat([torch.rand(32, generator=gen) * 0.5,
                     torch.rand(32, generator=gen) * 1e-4 + 1e-5]).cuda()
    out = torch.empty(32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run_ms(form: int, steps: int) -> float:
        best = float("inf")
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if fn(form, inp.data_ptr(), out.data_ptr(), steps, stream) != 0:
                raise RuntimeError("chain_floor launch failed")
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    floor = {}
    for i, name in enumerate(FORMS):
        short, long_ = run_ms(i, 1500), run_ms(i, 15000)
        floor[name] = {"ns_per_step": (long_ - short) * 1e6 / 13500,
                       "ms_1500_steps": short}
    return floor


def variant_times(paths) -> dict:
    """Device-only ms of each flavour (``chip_smoke.fcfs_flavour_calls``)
    at the batch lane's shape for the committed kernel and each variant,
    in turns (committed, variants, variants reversed, committed), each
    checked bit for bit against the plain version before it is timed."""
    _, (arr, svc, tos, prio, free0, qos_t) = smoke._fcfs_cases()[0]
    calls = smoke.fcfs_flavour_calls(tos, free0)
    want = {name: smoke.fcfs_scan_ref(arr, svc, t, prio, free0, qos_t,
                                      smoke.FCFS_BIG, **kw)
            for name, (t, kw) in calls.items()}
    libs = {"committed": ctypes.CDLL(str(_build.library_path("fcfs_scan"))),
            **{name: lib for name, (lib, _) in
               _build.build_variants(paths).items()}}
    times: dict = {}
    for name in list(libs) + list(libs)[::-1]:
        with _build.library_swapped("fcfs_scan", libs[name]):
            for flavour, (t, kw) in calls.items():
                def call(t=t, kw=kw):
                    return smoke.ops.fcfs_scan(arr, svc, t, prio, free0,
                                               qos_t, **kw)
                smoke._fcfs_check(f"{name} {flavour}", call(), want[flavour])
                times.setdefault(name, {}).setdefault(flavour, []).append(
                    smoke.graph_ms(call, 20, 5))
    return times


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--load-change", action="store_true")
    parser.add_argument("--variant", type=Path, action="append", default=[])
    args = parser.parse_args()
    smoke.device_phase()
    log = _build.build(["fcfs_scan"])["fcfs_scan"]
    for line in instantiation_usage(log):
        smoke.phase("ptxas", f"fcfs_scan_kernel {line}")
    floor = chain_floor()
    for name, f in floor.items():
        smoke.phase("floor", f"{name}: {f['ns_per_step']:.2f} ns a dependent "
                             f"step ({f['ms_1500_steps']:.4f} ms for 1500 "
                             f"steps, launch included); on {smoke.CARD['smi']}")
    lanes = smoke.simulator_phase()
    if args.variant:
        for name, flavours in variant_times(args.variant).items():
            smoke.phase("variant", f"{name}: " + "; ".join(
                f"{f} {min(ms):.4f} ms" for f, ms in flavours.items())
                + f" (device-only, best of 2 turns, every flavour bit for "
                  f"bit); on {smoke.CARD['smi']}")
    by_flavour = dict.fromkeys(smoke.FLAVOURS, 0)
    dispatches = 0
    if args.load_change:
        smoke.reset_counts()
        dispatches = smoke.load_change_path()
        by_flavour = dict(smoke.fcfs_scan_cuda.launches_by_flavour)
    line = smoke.fcfs_line(dispatches, lanes, {"load_change": dispatches},
                           by_flavour)
    line["chain_floor"] = floor
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
