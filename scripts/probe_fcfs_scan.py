#!/usr/bin/env python
"""Quick check of the FCFS-scan CUDA kernel alone, on one CUDA card.

    python scripts/probe_fcfs_scan.py

Builds ``src/repro_torch/csrc/fcfs_scan.cu`` (nvcc, sm_90a) and prints what
ptxas reports (registers, spills).  Then holds the kernel to its plain
version in ``chip_smoke.py``'s simulator cases (cold, and the routed, warm,
traced and telemetry flavours), bit for bit, and prints
``chip_smoke.py``'s ``fcfs_scan`` line: each flavour's device-only and
eager times at the search path's batch shape beside the plain version's,
its bound, and one simulator dispatch end to end on the card and on the
CPU.  With ``--load-change`` it also runs ``chip_smoke.py``'s paper §5.5
phase (the load-change adaptation on the card against the CPU).  A short
first call for work on the kernel alone.  Exits non-zero if a check
fails.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main() -> int:
    smoke.device_phase()
    log = _build.build(["fcfs_scan"])["fcfs_scan"]
    print("fcfs_scan.cu: " + " | ".join(
        ln.strip() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln))
    lanes = smoke.simulator_phase()
    by_flavour = dict.fromkeys(smoke.FLAVOURS, 0)
    dispatches = 0
    if "--load-change" in sys.argv[1:]:
        smoke.reset_counts()
        dispatches = smoke.load_change_path()
        by_flavour = dict(smoke.fcfs_scan_cuda.launches_by_flavour)
    print(json.dumps(smoke.fcfs_line(dispatches, lanes,
                                     {"load_change": dispatches},
                                     by_flavour)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
