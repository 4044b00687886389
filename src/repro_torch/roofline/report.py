"""Roofline report of every (arch, shape) cell on one H100, walked on meta,
or on the production meshes from the dry run's records.

    PYTHONPATH=src python -m repro_torch.roofline.report [--arch A] [--shape S]
    PYTHONPATH=src python -m repro_torch.roofline.report --mesh single|multi

Counterpart of ``repro/roofline/report.py``, whose records come from the
reference's compiled dry runs (``launch/dryrun.py``, XLA only).  Here each
applicable cell of ``configs.SHAPES`` is walked by ``op_walk`` with the
model at full size on the meta device, so nothing is allocated and no card
is needed (the walk runs no kernel, so the CLI takes no device): a train
cell is one ``make_train_step`` (forward, remat's recompute, backward and
the AdamW update over ``specs.n_microbatches`` microbatches, bf16
parameters), a prefill cell one ``make_prefill_step``, a decode cell one
``make_decode_step`` against a cache of the shape's length.  The terms are
one card's (``chips`` 1, mesh "single-card"); the tables print as
markdown.  The same table functions as the reference's, over these
records.  ``--mesh single`` or ``multi`` loads the records that
``launch.dryrun`` wrote for that mesh (``load``, the reference's, its
variants left out) from ``dryrun.OUT_DIR`` (``--out`` another folder) and
prints the same tables.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from ..configs import ARCHS, SHAPES, cell_is_applicable, get_arch
from ..launch import specs
from ..launch.dryrun import OUT_DIR
from ..launch.steps import (make_decode_step, make_prefill_step,
                            make_train_step)
from ..models.transformer import get_model, make_trainable
from .analysis import (HBM_BW, LINK_BW, PEAK_FLOPS, RooflineTerms,
                       collective_bytes, count_params, model_flops)
from .op_walk import analyze

MESH = "single-card"


def walk_cell(arch: str, shape: str) -> dict:
    """One cell's record: the walk's counts, its roofline terms on one card
    and MODEL_FLOPS over the walk's flops; ``skipped`` for a cell that does
    not apply."""
    cfg = get_arch(arch)
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": MESH, "skipped": why}
    api = get_model(cfg)
    seq, gbatch, kind = SHAPES[shape]
    t0 = time.perf_counter()
    params = specs.param_specs(api)
    batch = specs.input_specs(arch, shape)
    if kind == "train":
        make_trainable(params)
        opt = specs.opt_specs(params)
        step = make_train_step(api, specs.n_microbatches(cfg, shape),
                               param_dtype=specs.PARAM_DTYPE)
        acc = analyze(step, params, opt, batch)
    elif kind == "prefill":
        acc = analyze(make_prefill_step(api, seq), params, batch)
    else:
        cache = specs.cache_specs(api, arch, shape)
        acc = analyze(make_decode_step(api), params, cache, batch["tokens"])
    walk_s = time.perf_counter() - t0
    terms = RooflineTerms(flops_per_device=acc.flops,
                          bytes_per_device=acc.hbm_bytes,
                          collective_per_device=acc.collective_wire_bytes,
                          n_chips=1)
    mflops = model_flops(cfg, kind, gbatch * (seq if kind != "decode" else 1))
    return {
        "arch": arch, "shape": shape, "mesh": MESH, "chips": 1,
        "kind": kind, "seq": seq, "global_batch": gbatch,
        "walk_s": round(walk_s, 1),
        "flops_per_device": acc.flops,
        "bytes_per_device": acc.hbm_bytes,
        "collective_bytes_per_device": acc.collective_wire_bytes,
        "collectives": collective_bytes(acc),
        "collective_counts": acc.collective_counts,
        "n_ops": acc.n_ops,
        "flops_by_dtype": acc.flops_by_dtype,
        "kernels": acc.kernels,
        "roofline": terms.to_dict(),
        "model_flops": mflops,
        "model_params_active": count_params(cfg, active_only=True),
        "useful_flops_fraction": mflops / acc.flops if acc.flops else 0.0,
    }


def load(mesh: str = "single", out_dir=None) -> list[dict]:
    """The dry run's records of ``mesh`` ("single" or "multi"), skips and
    errors included, variants left out."""
    recs = []
    for p in sorted((Path(out_dir) if out_dir else OUT_DIR).glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("mesh") == mesh and not r.get("variant"):
            recs.append(r)
    return recs


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}µs"


def _fix_hint(rec) -> str:
    """One sentence on what would move the dominant term down."""
    r = rec.get("roofline", {})
    dom = r.get("dominant")
    kind = rec.get("kind")
    if dom == "collective":
        coll = rec.get("collectives", {})
        top = max(coll, key=lambda k: coll[k]) if coll else "?"
        if kind == "train":
            return (f"{top} dominates — reduce-scatter/sequence-parallel the "
                    "TP activation reductions over NVLink; defer DP grad "
                    "all-reduce across microbatches")
        return (f"{top} dominates — reshard so decode attention stays on its "
                "card (head-aligned KV sharding) or widen batch per card")
    if dom == "memory":
        if kind == "decode":
            return ("KV/state streaming bound — quantize cache to int8 or "
                    "shrink the window; fuse the decode step (CUDA graph, "
                    "one kernel per layer)")
        if kind == "train":
            return ("activation traffic bound — fuse elementwise chains, "
                    "reduce remat recompute width, keep residuals bf16")
        return ("prefill activation traffic — fuse the elementwise chains "
                "between GEMMs; flash attention already avoids scores")
    return ("tensor-core-bound — raise per-card utilization (bigger "
            "per-card batch/microbatch, avoid padding waste)")


def roofline_table(recs: list[dict]) -> str:
    lines = ["| arch | shape | compute | memory | collective | dominant | "
             "MODEL/HLO flops | bound time |",
             "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if "roofline" not in r:
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(rf['compute_s'])} | "
            f"{_fmt_s(rf['memory_s'])} | {_fmt_s(rf['collective_s'])} | "
            f"**{rf['dominant']}** | {r['useful_flops_fraction']:.3f} | "
            f"{_fmt_s(max(rf['compute_s'], rf['memory_s'], rf['collective_s']))} |")
    return "\n".join(lines)


def dryrun_table(recs: list[dict]) -> str:
    """The reference's dry-run table; its compile column is the walk's
    seconds here."""
    lines = ["| arch | shape | walk | flops/dev | HBM bytes/dev | "
             "coll bytes/dev | AR/AG/RS/A2A/CP counts |",
             "|---|---|---|---|---|---|---|"]
    for r in recs:
        if "roofline" not in r:
            continue
        c = r.get("collective_counts", {})
        counts = "/".join(str(int(c.get(k, 0))) for k in
                          ("all-reduce", "all-gather", "reduce-scatter",
                           "all-to-all", "collective-permute"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['walk_s']}s | "
            f"{r['flops_per_device']:.3g} | {r['bytes_per_device']:.3g} | "
            f"{r['collective_bytes_per_device']:.3g} | {counts} |")
    return "\n".join(lines)


def skipped_table(recs: list[dict]) -> str:
    lines = ["| arch | shape | reason |", "|---|---|---|"]
    for r in recs:
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['skipped']} |")
    return "\n".join(lines)


def pick_hillclimb_candidates(recs: list[dict]) -> dict:
    """worst roofline fraction / most collective-bound / most representative
    of the paper's technique (a decode cell — the serving hot path); a
    candidate without a record to pick from is left out."""
    ok = [r for r in recs if "roofline" in r]
    out = {}
    if ok:
        out["worst_fraction"] = min(
            ok, key=lambda r: r["roofline"]["roofline_fraction"])
        out["most_collective_bound"] = max(
            ok, key=lambda r: (r["roofline"]["collective_s"]
                               / max(r["roofline"]["compute_s"], 1e-12)))
    decodes = [r for r in ok if r["kind"] == "decode"]
    if decodes:
        out["paper_representative_decode"] = max(
            decodes, key=lambda r: r["roofline"]["memory_s"])
    return out


def hints_table(recs: list[dict]) -> str:
    lines = ["| arch | shape | dominant | what would move it down |",
             "|---|---|---|---|"]
    for r in recs:
        if "roofline" not in r:
            continue
        lines.append(f"| {r['arch']} | {r['shape']} | "
                     f"{r['roofline']['dominant']} | {_fix_hint(r)} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS))
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", default=MESH, choices=[MESH, "single", "multi"])
    ap.add_argument("--out", default=None,
                    help="the dry run's records (default dryrun.OUT_DIR)")
    args = ap.parse_args(argv)
    if args.mesh == MESH:
        recs = [walk_cell(arch, shape)
                for arch in ([args.arch] if args.arch else ARCHS)
                for shape in ([args.shape] if args.shape else SHAPES)]
        where = "One NVIDIA H100 SXM5 80GB"
        counted = "counts from a walk on the meta device"
    else:
        recs = [r for r in load(args.mesh, args.out)
                if args.arch in (None, r["arch"])
                and args.shape in (None, r["shape"])]
        chips = {r["chips"] for r in recs if "chips" in r}
        where = (f"{'/'.join(map(str, sorted(chips))) or 'No'} NVIDIA H100 "
                 f"SXM5 80GB ({args.mesh})")
        counted = ("one rank's counts from the dry run's walks on the meta "
                   "device (launch.dryrun); the collective term at NVLink's "
                   "rate on every axis")
    print(f"{where} (data sheet, 700 W): "
          f"{PEAK_FLOPS / 1e12:.1f} TFLOP/s bf16, {HBM_BW / 1e12:.2f} TB/s "
          f"HBM3, NVLink {LINK_BW / 1e9:.0f} GB/s a direction; {counted}")
    print("\n### Walk table\n")
    print(dryrun_table(recs))
    print("\n### Roofline table\n")
    print(roofline_table(recs))
    print("\n### Skips\n")
    print(skipped_table(recs))
    print("\n### Hillclimb candidates")
    for k, r in pick_hillclimb_candidates(recs).items():
        print(f"- {k}: {r['arch']} × {r['shape']} "
              f"(fraction {r['roofline']['roofline_fraction']:.4f}, "
              f"dominant {r['roofline']['dominant']})")
    print("\n### What would move each cell down\n")
    print(hints_table(recs))


if __name__ == "__main__":
    main()
