"""Multi-pod dry run: every (architecture x input-shape x mesh) cell walked
on the meta device under the production layout, over torch's ``fake``
process group, one JSON record a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --skip-done

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell's step on 512 forced host devices and reads XLA's HLO.  Here each
mesh kind runs in a ``fake`` group of its own world
(``torch.testing._internal.distributed.fake_pg``; the CLI builds it, so
importing this module starts none): 256 ranks for "single", a (16, 16)
("data", "model") mesh, and 512 for "multi", (2, 16, 16) ("pod", "data",
"model").  Rank 0's view is walked: nothing is allocated, no collective
moves data and no card is needed.  A cell (``build_walk``, the
reference's ``build_lowered``) places the parameters by
``sharding.param_shardings`` (a train cell's AdamW state placed alike),
the inputs by ``data_sharding`` and a decode cache by
``cache_shardings``, then ``roofline.op_walk.analyze`` counts one call of
``make_train_step`` (bf16 parameters, ``grad_shardings``),
``make_prefill_step`` or ``make_decode_step`` at full size and depth
under ``sharding.activate(mesh)``: what one rank runs, the collectives
DTensor issues included (the mesh is of the cards' device type, so
DTensor takes the paths it takes on cards).

The record keeps the reference's keys where they mean the same:
``flops_per_device``, ``bytes_per_device``, ``collective_bytes_per_device``
(wire bytes), ``collectives`` (operand bytes by kind),
``collective_counts``, ``roofline`` (``RooflineTerms`` on 256 or 512
chips), ``model_flops``, ``model_params_active`` and
``useful_flops_fraction`` (MODEL_FLOPS over per-device flops times
chips).  ``walk_s`` stands for ``lower_s`` and ``compile_s``.  The
``cost_analysis_*`` keys are left out: they are XLA's own estimate of a
compiled module, and no compiler runs here.  ``memory_analysis`` holds
one rank's ``argument_size_in_bytes`` (its parts beside it: parameters,
AdamW state, inputs, cache), ``output_size_in_bytes`` and
``alias_size_in_bytes`` (the decode cache, which the reference donates);
``temp_size_in_bytes`` and ``generated_code_size_in_bytes`` are None,
since without a compiler there is no buffer assignment and no code.
``split`` names the mesh axes that split the batch, the projections and
MLP, the experts, and the attention cores and SSD scans.  The collective
term takes NVLink's rate (``analysis.LINK_BW``) on every axis; an H100
node holds 8 cards, so a 16-wide axis spans two nodes and would run at
the inter-node rate (``link_note``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from ..configs import SHAPES, cell_is_applicable, get_arch
from ..models.transformer import get_model, make_trainable
from ..roofline.analysis import (RooflineTerms, collective_bytes,
                                 count_params, model_flops)
from ..roofline.op_walk import analyze
from . import sharding as shp
from . import specs
from .mesh import make_production_mesh
from .steps import make_decode_step, make_prefill_step, make_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
WORLDS = {"single": 256, "multi": 512}
LINK_NOTE = ("collective term at NVLink 4's 450 GB/s a direction on every "
             "mesh axis; an H100 node holds 8 cards, so a 16-wide axis "
             "spans two nodes and would run at the inter-node rate")

# perf-variant presets (the reference's, EXPERIMENTS.md §Perf):
# dataclasses.replace overrides
VARIANTS = {
    "seqpar": {"seq_parallel_kv": True},
    "moecap": {"moe_buffer_shard": "capacity"},
    "seqpar_moecap": {"seq_parallel_kv": True, "moe_buffer_shard": "capacity"},
    "nomicro": {},          # handled via n_micro override below
    "noremat": {"remat": False},
    "moecap_noremat": {"moe_buffer_shard": "capacity", "remat": False},
    "moecap_cf1": {"moe_buffer_shard": "capacity",
                   "moe_capacity_factor": 1.0},
    "kvq8": {"kv_quant_int8": True},
    "moecap2d_cf1": {"moe_buffer_shard": "capacity2d",
                     "moe_capacity_factor": 1.0},
    "moelocal_cf1": {"moe_buffer_shard": "local",
                     "moe_capacity_factor": 1.0},
    "seqpar_kvq8": {"seq_parallel_kv": True, "kv_quant_int8": True},
}

# the leaves whose specs say how the projections and MLP split
_PROJECTIONS = ("wq", "wk", "wv", "wo", "wdq", "wuq", "wuk", "wuv", "w1",
                "w2", "w3", "in_proj", "out_proj")


def _fake_store():
    """torch's ``FakeStore``; RuntimeError where the installed torch lacks
    the fake process group."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"torch {torch.__version__} lacks") from e
    return FakeStore


@contextmanager
def fake_world(n: int):
    """Within: torch's ``fake`` process group of ``n`` ranks as the default
    group, this process rank 0 (collectives return at once, moving
    nothing).  Raises RuntimeError where the installed torch lacks it."""
    dist.init_process_group("fake", store=_fake_store()(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank_bytes(tree) -> int:
    """Bytes one rank holds of the tensors in ``tree`` (a module's state,
    a dict, a tuple ...): each DTensor's local shard, each plain tensor
    whole."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict(keep_vars=True)
    return sum(shp.local_tensor(t).numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _axes(elem) -> list:
    if elem is None:
        return []
    return list(elem) if isinstance(elem, tuple) else [elem]


def _spec_axes(shardings: dict, pick) -> list:
    """The mesh axes named in the specs of the leaves ``pick`` takes, in
    the mesh's order."""
    named = {a for name, s in shardings.items() if pick(name)
             for e in s.spec for a in _axes(e)}
    return [a for a in next(iter(shardings.values())).mesh.axis_names
            if a in named]


def cell_split(cfg, mesh, batch: int, shardings: dict) -> dict:
    """The mesh axes that split the cell's work: the batch, the projections
    and MLP (their weights' specs), the experts (their weights' specs; the
    capacity buffer by ``moe_buffer_shard``) and the MoE routing (every
    token on every rank, but in the local layer), the attention cores and SSD
    scans (``sharding.split_elems``, as the models call it).  An SSM
    decode step's products run on its weights as their specs split them,
    as the projections'."""
    def leaf(name):
        return name.rsplit(".", 1)[-1]
    bat, _ = shp.split_elems(mesh, batch)
    out = {"batch": _axes(bat),
           "projections": _spec_axes(
               shardings, lambda n: leaf(n) in _PROJECTIONS
               and ".experts." not in n)}
    if cfg.is_moe:
        out["experts"] = _spec_axes(shardings, lambda n: ".experts." in n)
        out["moe_buffer_shard"] = cfg.moe_buffer_shard
        # the global layer routes every token on every rank
        out["moe_dispatch"] = (_axes(bat) if cfg.moe_buffer_shard == "local"
                               else [])
    if cfg.n_heads:
        out["attention"] = _axes_pair(shp.split_elems(
            mesh, batch, cfg.n_heads, cfg.n_kv_heads))
    if cfg.family in ("ssm", "hybrid"):
        out["ssd_scan"] = _axes_pair(shp.split_elems(
            mesh, batch, cfg.ssm_nheads,
            *(() if cfg.ssm_ngroups == 1 else (cfg.ssm_ngroups,))))
    return out


def _axes_pair(pair) -> list:
    return _axes(pair[0]) + _axes(pair[1])


def state_bytes(cfg, mesh) -> dict:
    """One rank's bytes of the parameters (bf16, the MoE routers float32)
    and of their AdamW state (float32 master, m and v, the int32 step),
    placed by ``param_shardings`` on ``mesh``."""
    params = specs.param_specs(get_model(cfg))
    shp.place_params(params, shp.param_shardings(params, cfg, mesh))
    return {"params": rank_bytes(params),
            "adamw": rank_bytes(specs.opt_specs(params))}


def build_walk(arch: str, shape: str, multi_pod: bool,
               variant: str | None = None, n_micro: int | None = None,
               changes: dict | None = None, batch: tuple | None = None):
    """The cell's step and its arguments placed under the production mesh
    (the reference's ``build_lowered``): (step, args, mesh, cfg, (seq,
    global batch, kind), the argument bytes by part, the split).
    ``changes`` replaces configuration fields after the variant's and
    ``batch`` = (B, S) a train or prefill cell's inputs (a cut, for
    tests)."""
    cfg = get_arch(arch)
    if variant:
        cfg = dataclasses.replace(cfg, **VARIANTS[variant])
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    api = get_model(cfg)
    seq, gbatch, kind = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)

    params = specs.param_specs(api)
    if kind == "train":
        make_trainable(params)
    p_sh = shp.param_shardings(params, cfg, mesh)
    shp.place_params(params, p_sh)
    inputs = specs.input_specs(arch, shape)
    if batch is not None and kind != "decode":
        gbatch, seq = batch
        inputs = {k: specs.sds((gbatch, seq) if k != "extra"
                               else (gbatch, *v.shape[1:]), v.dtype)
                  for k, v in inputs.items()}
    inputs = {k: shp.place(v, shp.data_sharding(v.shape, mesh))
              for k, v in inputs.items()}
    parts = {"params": rank_bytes(params)}
    if kind == "train":
        n_micro = specs.n_microbatches(cfg, shape) if n_micro is None \
            else n_micro
        opt = specs.opt_specs(params)       # placed as the parameters
        parts["adamw"] = rank_bytes(opt)
        step = make_train_step(api, n_micro, param_dtype=specs.PARAM_DTYPE,
                               grad_shardings=p_sh)
        args = (params, opt, inputs)
    elif kind == "prefill":
        step = make_prefill_step(api, max_len=seq)
        args = (params, inputs)
    else:
        cache = specs.cache_specs(api, arch, shape)
        cache = shp.place_cache(cache, shp.cache_shardings(cache, cfg, mesh))
        parts["cache"] = rank_bytes(cache)
        step = make_decode_step(api)
        inputs = {"tokens": inputs["tokens"]}
        args = (params, cache, inputs["tokens"])
    parts["inputs"] = rank_bytes(inputs)
    split = cell_split(cfg, mesh, gbatch, p_sh)
    return step, args, mesh, cfg, (seq, gbatch, kind), parts, split


def run_cell(arch: str, shape: str, mesh_kind: str,
             variant: str | None = None, n_micro: int | None = None, *,
             changes: dict | None = None, batch: tuple | None = None) -> dict:
    """One cell's record (a skip record where ``cell_is_applicable``
    rejects it), walked over the default process group, which must be a
    ``fake`` group of the mesh kind's world (``fake_world``)."""
    multi_pod = mesh_kind == "multi"
    n_chips = WORLDS[mesh_kind]
    cfg = get_arch(arch)
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "skipped": why}

    t0 = time.perf_counter()
    step, args, mesh, cfg, (seq, gbatch, kind), parts, split = build_walk(
        arch, shape, multi_pod, variant=variant, n_micro=n_micro,
        changes=changes, batch=batch)
    outs = []
    with shp.activate(mesh), torch.set_grad_enabled(kind == "train"):
        acc = analyze(lambda *a: outs.append(step(*a)), *args)
    walk_s = time.perf_counter() - t0

    terms = RooflineTerms(flops_per_device=acc.flops,
                          bytes_per_device=acc.hbm_bytes,
                          collective_per_device=acc.collective_wire_bytes,
                          n_chips=n_chips)
    n_tokens = gbatch * (seq if kind != "decode" else 1)
    mflops = model_flops(cfg, kind, n_tokens)
    flops_global = acc.flops * n_chips
    argument = sum(parts.values())
    out = outs[0]
    if kind == "train":
        output = rank_bytes(out[0]) + rank_bytes(out[1]) + rank_bytes(out[2])
        cache = {}
    else:
        output = rank_bytes(out)
        cache = out[0] if kind == "prefill" else out[1]
    mem = {"argument_size_in_bytes": argument,
           **{f"argument_{k}_bytes": v for k, v in parts.items()},
           "output_size_in_bytes": output,
           "alias_size_in_bytes": parts.get("cache", 0),
           "temp_size_in_bytes": None,
           "generated_code_size_in_bytes": None}
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "chips": n_chips,
        "mesh_shape": dict(mesh.shape),
        "variant": variant, "n_micro_override": n_micro,
        "changes": changes, "batch_override": batch,
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
        "memory_analysis": mem,
        "split": split,
        "cache_placements": {n: str(list(t.placements))
                             for n, t in cache.items()
                             if shp.is_distributed(t)},
        "roofline": terms.to_dict(),
        "link_note": LINK_NOTE,
        "model_flops": mflops,
        "model_params_active": count_params(cfg, active_only=True),
        "useful_flops_fraction": mflops / flops_global if flops_global
        else 0.0,
    }


def _run_one(arch: str, shape: str, mesh_kind: str, args,
             out_dir: Path) -> int:
    """Write one cell's record (unless ``--skip-done`` finds it); 1 if the
    cell raised, else 0."""
    tag = f"{arch}_{shape}_{mesh_kind}".replace(".", "_")
    if args.variant:
        tag += f"__{args.variant}"
    if args.n_micro is not None:
        tag += f"__m{args.n_micro}"
    path = out_dir / f"{tag}.json"
    if args.skip_done and path.exists():
        if "error" not in json.loads(path.read_text()):
            print(f"[skip] {tag}")
            return 0
    print(f"[run ] {tag} ...", flush=True)
    try:
        rec = run_cell(arch, shape, mesh_kind, variant=args.variant,
                       n_micro=args.n_micro)
    except Exception as e:  # noqa: BLE001  (recorded for triage)
        traceback.print_exc()
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "error": f"{type(e).__name__}: {e}"}
    path.write_text(json.dumps(rec, indent=2, default=str))
    if "skipped" in rec:
        print(f"[skip] {tag}: {rec['skipped']}")
    elif "error" in rec:
        print(f"[FAIL] {tag}: {rec['error'][:200]}")
        return 1
    else:
        r = rec["roofline"]
        print(f"[ ok ] {tag}: walk {rec['walk_s']}s  "
              f"flops/dev {rec['flops_per_device']:.3g}  "
              f"coll/dev {rec['collective_bytes_per_device']:.3g}  "
              f"dominant={r['dominant']}", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS),
                    help="perf-variant preset (see VARIANTS)")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    if args.all:
        from ..configs import all_cells
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    try:
        _fake_store()
    except RuntimeError as e:
        raise SystemExit(f"dryrun: {e}")
    failures = 0
    for mesh_kind in meshes:
        with fake_world(WORLDS[mesh_kind]):
            for arch, shape in cells:
                failures += _run_one(arch, shape, mesh_kind, args, out_dir)
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
