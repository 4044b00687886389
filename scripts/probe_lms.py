#!/usr/bin/env python
"""Where the time of an LM's bf16 prefill and decode step goes, on one
CUDA card.

    python scripts/probe_lms.py [--runs olmoe-1b-7b minicpm3-4b ...]

For each of ``chip_smoke.py``'s LM runs named by label (all by default):
the model at full width and depth with bf16 random weights from seed 0
(MoE routers float32), its prompt and extra rows as ``chip_smoke.py``
draws them; the prefill and one decode step device-only (replays of a
CUDA graph) and eager (CUDA events, median of 3), and a ``torch.profiler``
trace of each (two prefills, five decode steps): kernels a call, the
device's busy time and idle share, and the top kernels by device time.
Prints the card's name and power limit.  No gate: a measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as smoke  # noqa: E402
from probe_paper_models import events_ms, graph_ms, trace  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.transformer import get_model  # noqa: E402


def _line(label, what, dev, eager, traced, smi) -> str:
    n, busy, wall, top = traced
    return (f"[probe] {label} {what}: device-only {dev:.4f} ms (CUDA graph), "
            f"eager {eager:.4f} ms (events); profiled: {n:.0f} kernels, "
            f"device busy {busy:.4f} of {wall:.4f} ms (idle "
            f"{100 * (1 - busy / wall):.1f} %); top: "
            + "; ".join(f"{k} x{c} {ms:.4f} ms" for k, c, ms in top)
            + f"; on {smi}")


def main() -> int:
    runs = {r.label: r for r in smoke.LM_RUNS}
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", default=list(runs),
                    choices=list(runs))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for label in args.runs:
        run = runs[label]
        api = get_model(dataclasses.replace(get_arch(run.arch),
                                            **dict(run.changes)))
        cfg = api.cfg
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = api.init_params(gen, torch.bfloat16, "cuda")
        tokens = torch.randint(0, cfg.vocab_size, (run.batch, run.prompt),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        extra = None
        if run.extra:
            extra = torch.randn((run.batch, run.extra, cfg.d_model),
                                generator=gen, device="cuda") * 0.02

        def prefill():
            return api.prefill(params, tokens, run.max_len, extra)

        cache, logits = prefill()
        tok = smoke._greedy(logits)

        def step():
            return api.decode_step(params, cache, tok)

        for what, fn, calls, reps in (("prefill", prefill, 1, 2),
                                      ("decode step", step, 4, 5)):
            fn()
            dev = graph_ms(fn, calls=calls, replays=3)
            eager = events_ms(fn, 3)
            print(_line(label, what, dev, eager, trace(fn, reps), smi),
                  flush=True)
        del params, cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
