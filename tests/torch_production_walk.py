"""The subprocess side of ``tests/test_torch_production_mesh.py``: every
architecture's ``prefill_32k`` and ``decode_32k`` step, and one training
step of each family, walked on the meta device (``roofline.op_walk``,
which allocates nothing) under the production layout, a (16, 16)
("data", "model") mesh over torch's ``fake`` process group at world 256.

Parameters are placed by ``sharding.param_shardings``, decode caches by
``cache_shardings`` and inputs by ``data_sharding``, as the steps take
them on 256 cards.  The training steps run at full width, their depth cut
to one hybrid block or two layers (two encoder layers), on a global batch
of 16 sequences of 128 tokens in one microbatch, bf16 parameters.  It
imports only torch and the port.

    PYTHONPATH=src python tests/torch_production_walk.py

prints one JSON object: by cell, "ok" or the error, the walk's flops and
seconds, and the placements of the KV cache's ``k`` and ``v``.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, cell_is_applicable, get_arch
from repro_torch.launch import sharding as shp
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.transformer import get_model, make_trainable
from repro_torch.roofline.op_walk import analyze

WORLD, MESH = 256, (16, 16)
TRAIN_BATCH, TRAIN_SEQ = 16, 128
FAMILIES = {"dense": "qwen2.5-3b", "moe": "olmoe-1b-7b", "mla": "minicpm3-4b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
            "vlm": "internvl2-1b", "encdec": "whisper-tiny"}


def _placed_batch(batch: dict, mesh) -> dict:
    return {k: shp.place(v, shp.data_sharding(v.shape, mesh))
            for k, v in batch.items()}


def _cache_placements(cache: dict) -> dict:
    return {n: str(list(cache[n].placements)) for n in ("k", "v")
            if n in cache}


def walk(arch: str, shape: str, mesh) -> dict:
    """One cell's walk: its flops, seconds and cache placements."""
    cfg = get_arch(arch)
    seq, gbatch, kind = SHAPES[shape]
    if kind == "train":
        cfg = dataclasses.replace(
            cfg, n_layers=cfg.attn_every or 2,
            n_encoder_layers=min(cfg.n_encoder_layers, 2))
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = specs.param_specs(api)
    if kind == "train":
        make_trainable(params)
    shp.place_params(params, shp.param_shardings(params, cfg, mesh))
    batch = specs.input_specs(arch, shape)
    if kind == "train":
        batch = {k: specs.sds((TRAIN_BATCH, TRAIN_SEQ) if k != "extra"
                              else (TRAIN_BATCH, *v.shape[1:]), v.dtype)
                 for k, v in batch.items()}
    batch = _placed_batch(batch, mesh)
    out = {}
    with shp.activate(mesh):
        if kind == "train":
            step = make_train_step(api, 1, param_dtype=specs.PARAM_DTYPE)
            acc = analyze(step, params, specs.opt_specs(params), batch)
        elif kind == "prefill":
            step = make_prefill_step(api, seq)

            def prefill(params, batch):
                out["cache"] = step(params, batch)[0]
            with torch.no_grad():
                acc = analyze(prefill, params, batch)
        else:
            cache = specs.cache_specs(api, arch, shape)
            out["cache"] = shp.place_cache(
                cache, shp.cache_shardings(cache, cfg, mesh))
            with torch.no_grad():
                acc = analyze(make_decode_step(api), params, out["cache"],
                              batch["tokens"])
    return {"ok": True, "flops": acc.flops,
            "seconds": time.perf_counter() - t0,
            "cache": _cache_placements(out.get("cache", {}))}


def main() -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    mesh = make_process_mesh(MESH, ("data", "model"), device="cpu")
    cells = [(arch, shape) for arch in ARCHS
             for shape in ("prefill_32k", "decode_32k")]
    cells += [(arch, "train_4k") for arch in FAMILIES.values()]
    out = {}
    for arch, shape in cells:
        ok, why = cell_is_applicable(get_arch(arch), shape)
        key = f"{arch} {shape}"
        if not ok:
            out[key] = {"skipped": why}
            continue
        try:
            out[key] = walk(arch, shape, mesh)
        except Exception as e:  # noqa: BLE001  (each cell reports its error)
            out[key] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    dist.destroy_process_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
