"""Run one cell of the port's benchmark once and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Needs a CUDA card: without one it exits 2
and prints no result.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit); the numbers compared are also the last lines of standard
error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from portbench import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA card; this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats(0)
    result, compared = harness.run(cell, args.seed, args.seconds,
                                   bool(args.trace), "cuda:0", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    d = result["device"]
    print(f"portbench: {d['kind']}, power limit {d.get('power_limit_w')} W, "
          f"SM clock {d.get('sm_clock_mhz')} MHz, torch {d['torch']}, "
          f"CUDA {d['cuda']}", flush=True)
    result["checks"] = compared
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
