"""The readings a cell's correctness limit is set from, on the card.

    python portbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...]

For each seed, one run of the cell as ``run.py`` makes it (a window of
``--seconds``, long enough to finish the mix's longest request), then the
plain reference over the sample a run checks: each number compared (the
served tokens' logit gaps, the error of the port's logits rows), the
lower readings.  For each control seed the same, plus the control, the
reference computed with fp8 e4m3 inputs to every linear layer (the
precision below the configurations' bf16) in the port's place: the same
numbers of the tokens it puts first and of its logits rows, the upper
readings, and ``control_correct``, the control held to the cell's limits
as ``correct`` holds the port.  One process for all seeds, so set-up is
paid once for imports.  Prints one JSON line a seed; not run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    runs = [(s, False) for s in args.seeds] + \
        [(s, True) for s in args.control_seeds]
    for seed, control in runs:
        t = time.perf_counter()
        result, compared = harness.run(cell, seed, args.seconds, False,
                                       "cuda:0", t, control=control)
        line = {"cell": args.workload, "seed": seed, "control": control,
                "correct": result["correct"],
                "control_correct": compared.get("control_correct",
                                                {}).get("value"),
                "readings": {k: v["value"] for k, v in compared.items()},
                "seconds": time.perf_counter() - t,
                "metrics": {k: v["value"] for k, v in
                            result["metrics"].items()}}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
