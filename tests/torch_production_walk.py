"""The subprocess side of ``tests/test_torch_production_mesh.py``: the dry
run (``launch.dryrun``) of every architecture's ``prefill_32k`` and
``decode_32k`` step and one training step of each family, on the meta
device (``roofline.op_walk``, which allocates nothing) under the
production layout, a (16, 16) ("data", "model") mesh over torch's
``fake`` process group at world 256; and what the gates on those
records need beside them.

Parameters are placed by ``sharding.param_shardings``, decode caches by
``cache_shardings`` and inputs by ``data_sharding``, as the steps take
them on 256 cards (``dryrun.run_cell``).  The training steps run at full
width, their depth cut to one hybrid block or two layers (two encoder
layers), on a global batch of 16 sequences of 128 tokens in one
microbatch, bf16 parameters.  Beside them:

* ``cf7``: C-F7's three cases on a fake world of 4 at (2, 2), meta
  DTensors: a column-parallel product, a product whose left operand
  DTensor gathers inside the op, and that product walked again; and
  C-F9's (B, 1, D) rows times a replicated weight through
  ``layers.dense``;
* ``one_card``: for the cells of ``GATED``, the one-card walk of the
  same step (no mesh), each product's flops by the parameter it
  multiplies (or none), the kernels' flops, and each parameter's mesh
  axes under the production layout;
* ``state``: one rank's parameter and AdamW bytes of every architecture
  at (16, 16) and, over a world of 512, at (2, 16, 16);
* ``multi``: the cells of ``MULTI`` at (2, 16, 16);
* ``ssm_gathers``: in the walk of ``SSM_GATHERS``'s decode step, the
  shape of every all-gather's operand, beside the local shapes of the
  cell's parameters and of a layer of its SSM state (ROADMAP F-6a).

It imports only torch and the port.

    PYTHONPATH=src python tests/torch_production_walk.py

prints one JSON object.

    PYTHONPATH=src python tests/torch_production_walk.py heads CASE

walks one prefill (``CASE``: a JSON object with ``arch``, ``replace``,
``tokens`` (B, S) and ``max_len``) of the reduced configuration in fp32
on a fake world of 4 at (1, 4) on a CPU mesh, as the gloo ranks of
``tests/test_torch_mesh_heads.py`` run it, and prints its collective
counts by kind.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from collections import Counter
from contextlib import nullcontext

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, cell_is_applicable, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shp
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_process_mesh, make_production_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.layers import dense
from repro_torch.models.transformer import get_model
from repro_torch.roofline.op_walk import analyze
from torch_dist_ranks import GatherOperands, held_shapes

WORLD, MESH = 256, (16, 16)
TRAIN_BATCH, TRAIN_SEQ = 16, 128
FAMILIES = {"dense": "qwen2.5-3b", "moe": "olmoe-1b-7b", "mla": "minicpm3-4b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
            "vlm": "internvl2-1b", "encdec": "whisper-tiny"}
# gate (b): per-device flops against the one-card walk split by the split
GATED = [(a, s) for a in ("qwen2.5-3b", "stablelm-3b", "mamba2-130m",
                          "olmoe-1b-7b")
         for s in ("prefill_32k", "decode_32k")] + [("mamba2-130m",
                                                      "long_500k")]
# gate (c): the multi-pod mesh halves these cells' per-device flops
MULTI = [("stablelm-3b", "decode_32k"), ("qwen2.5-3b", "prefill_32k")]
# the cell whose decode step must gather no parameter and no SSM state
SSM_GATHERS = ("zamba2-2.7b", "decode_32k")
KEEP = ("flops_per_device", "bytes_per_device", "collective_bytes_per_device",
        "collective_counts", "kernels", "memory_analysis", "split",
        "cache_placements", "roofline", "walk_s", "chips")


def _cell(arch: str, shape: str, mesh_kind: str) -> dict:
    """The dry run's record of one cell (its error instead, if it raised);
    a training cell cut as the module docstring says."""
    ok, why = cell_is_applicable(get_arch(arch), shape)
    if not ok:
        return {"skipped": why}
    kw = {}
    if SHAPES[shape][2] == "train":
        cfg = get_arch(arch)
        kw = dict(n_micro=1, batch=(TRAIN_BATCH, TRAIN_SEQ), changes=dict(
            n_layers=cfg.attn_every or 2,
            n_encoder_layers=min(cfg.n_encoder_layers, 2)))
    try:
        rec = dryrun.run_cell(arch, shape, mesh_kind, **kw)
    except Exception as e:  # noqa: BLE001  (each cell reports its error)
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}
    return {"ok": True, **{k: rec[k] for k in KEEP}}


class _ByWeight(TorchDispatchMode):
    """Each product's flops by the parameter it multiplies (the tensor
    itself or a view of it; "" for none)."""

    def __init__(self, names: dict):
        super().__init__()
        self.names = names
        self.flops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.overloadpacket in flop_registry:
            flops = flop_registry[func.overloadpacket](*args, **kwargs,
                                                       out_val=out)
            if flops:
                owner = ""
                for t in tree_leaves((args, kwargs)):
                    if not isinstance(t, torch.Tensor):
                        continue
                    for x in (t, t._base):
                        if x is not None and id(x) in self.names:
                            owner = self.names[id(x)]
                self.flops[owner] += flops
        return out


def one_card_products(arch: str, shape: str, mesh) -> dict:
    """The one-card walk of the cell's step (``report.walk_cell``'s call):
    its flops, the kernels' flops, each product's flops by parameter and
    each parameter's mesh axes in its ``param_shardings`` spec on
    ``mesh``."""
    cfg = get_arch(arch)
    api = get_model(cfg)
    seq, _, kind = SHAPES[shape]
    params = specs.param_specs(api)
    batch = specs.input_specs(arch, shape)
    leaves = params.state_dict(keep_vars=True)
    axes = {n: sorted({a for e in s.spec if e is not None
                       for a in (e if isinstance(e, tuple) else (e,))})
            for n, s in shp.param_shardings(params, cfg, mesh).items()}
    mode = _ByWeight({id(t): n for n, t in leaves.items()})
    with mode, torch.no_grad():
        if kind == "prefill":
            acc = analyze(make_prefill_step(api, seq), params, batch)
        else:
            acc = analyze(make_decode_step(api), params,
                          specs.cache_specs(api, arch, shape),
                          batch["tokens"])
    return {"flops": acc.flops,
            "kernels": {k: v["flops"] for k, v in acc.kernels.items()},
            "by_weight": dict(mode.flops), "axes": axes}


def cf7_cases() -> dict:
    """C-F7's cases on a (2, 2) mesh over the fake world of 4, and C-F9's
    product through ``layers.dense``: the walk's flops, bytes, ops and
    collective counts of each."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    mesh = make_process_mesh((2, 2), ("data", "model"), device="cpu")

    def meta(shape, place):
        return distribute_tensor(torch.empty(shape, device="meta"),
                                 mesh.device_mesh, place, src_data_rank=None)
    w = meta((128, 256), [Replicate(), Shard(1)])
    cases = {"column": meta((64, 128), [Shard(0), Replicate()]),
             "gathered": meta((64, 128), [Replicate(), Shard(1)])}
    calls = [(label, torch.mm, x) for label, x in cases.items()]
    calls.append(("again", torch.mm, cases["gathered"]))
    # C-F9's case: a (B, 1, D) DTensor made by ``DTensor.from_local``, as
    # ``sharding.local_call`` makes its outputs, whose strides stop
    # ``matmul``'s fold, through ``layers.dense``
    rows = DTensor.from_local(torch.empty((4, 1, 128), device="meta"),
                              mesh.device_mesh, [Shard(0), Replicate()],
                              run_check=False)
    calls.append(("dense", dense, rows, meta((128, 96), [Replicate()] * 2)))
    out = {}
    for label, fn, *args in calls:
        if len(args) == 1:
            args.append(w)
        with shp.activate(mesh):
            acc = analyze(fn, *args)
        out[label] = {"flops": acc.flops, "hbm_bytes": acc.hbm_bytes,
                      "n_ops": acc.n_ops,
                      "collective_counts": acc.collective_counts}
    return out


def heads_walk(case: dict) -> dict:
    """Gate (d)'s walk: the collective counts by kind of one fp32 prefill
    of the reduced configuration on a (1, 4) CPU mesh over a fake world
    of 4."""
    with dryrun.fake_world(4):
        mesh = make_process_mesh((1, 4), ("data", "model"), device="cpu")
        cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                                  **case["replace"])
        api = get_model(cfg)
        params = api.init_params(torch.Generator().manual_seed(0),
                                 torch.float32, "meta")
        shp.place_params(params, shp.param_shardings(params, cfg, mesh))
        shape = tuple(case["tokens"])
        tokens = shp.place(specs.sds(shape, torch.int32),
                           shp.data_sharding(shape, mesh))
        with shp.activate(mesh), torch.no_grad():
            acc = analyze(make_prefill_step(api, case["max_len"]), params,
                          {"tokens": tokens})
    return {k: n for k, n in acc.collective_counts.items() if n}


def main() -> None:
    if sys.argv[1:2] == ["heads"]:
        print(json.dumps(heads_walk(json.loads(sys.argv[2]))))
        return
    t0 = time.perf_counter()
    out = {}
    with dryrun.fake_world(4):
        out["cf7"] = cf7_cases()
    with dryrun.fake_world(WORLD):
        cells = [(arch, shape) for arch in ARCHS
                 for shape in ("prefill_32k", "decode_32k")]
        cells += [(arch, "train_4k") for arch in FAMILIES.values()]
        cells += [c for c in GATED if c not in cells]
        gathers, out["cells"] = GatherOperands(), {}
        for a, s in cells:
            with gathers if (a, s) == SSM_GATHERS else nullcontext():
                out["cells"][f"{a} {s}"] = _cell(a, s, "single")
        params, cache, _ = dryrun.build_walk(*SSM_GATHERS, False)[1]
        out["ssm_gathers"] = {"gathered": gathers.shapes,
                              "held": held_shapes(params, cache)}
        mesh = make_production_mesh()
        out["one_card"] = {f"{a} {s}": one_card_products(a, s, mesh)
                           for a, s in GATED}
        out["state"] = {"single": {a: dryrun.state_bytes(cfg, mesh)
                                   for a, cfg in ARCHS.items()}}
    with dryrun.fake_world(2 * WORLD):
        out["multi"] = {f"{a} {s}": _cell(a, s, "multi") for a, s in MULTI}
        mesh = make_production_mesh(multi_pod=True)
        out["state"]["multi"] = {a: dryrun.state_bytes(cfg, mesh)
                                 for a, cfg in ARCHS.items()}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
