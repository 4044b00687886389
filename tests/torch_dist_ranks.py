"""The rank side of ``tests/test_torch_distributed.py``: what each of four
gloo ranks on the CPU runs on a (2, 2) ("data", "model") mesh.  It imports
only torch and the port (never JAX or the reference): the test process
computes the reference's answers and passes them in as numpy arrays, and
compares what the ranks send back.  ``checks`` runs every check in one
spawn and reports each one's results, or its traceback, under its name.
"""

from __future__ import annotations

import dataclasses
import traceback

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import sharding as shp
from repro_torch.launch import steps as steps_module
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.launch.train import train
from repro_torch.models import layers
from repro_torch.models.transformer import (get_model, lm_from_numpy,
                                            make_trainable)
from repro_torch.optim import adamw
from repro_torch.roofline import op_walk
from repro_torch.roofline.analysis import RooflineTerms

MOE_BASE = dict(d_model=32, d_expert=64, n_experts=4, top_k=2,
                moe_capacity_factor=8.0)


def moe_cfg(**kw):
    """The reference test's MoE configuration (``tests/test_moe_local.py``):
    mixtral-8x22b ``reduced()``, d 32, d_expert 64, 4 experts, top 2,
    capacity 8.0, with ``kw`` on top."""
    return dataclasses.replace(get_arch("mixtral-8x22b").reduced(),
                               **{**MOE_BASE, **kw})


def _full(x) -> np.ndarray:
    x = x.full_tensor() if shp.is_distributed(x) else x
    return x.detach().float().cpu().numpy()


def _placed_moe(arrays: dict, cfg, mesh, trainable: bool):
    """A MoE layer from numpy arrays, placed as ``param_shardings`` places
    a layer's experts and router."""
    moe = layers.MoE(torch.from_numpy(arrays["router"]),
                     {n: torch.from_numpy(arrays[n])
                      for n in ("w1", "w3", "w2")})
    if trainable:
        moe.make_trainable()
        for p in moe.experts.values():
            p.requires_grad_(True)
    shardings = {"router": shp.NamedSharding(mesh, shp.spec_for_param(
        ("layers", "moe", "router"), arrays["router"].shape, cfg, mesh))}
    for n in ("w1", "w3", "w2"):
        shardings[f"experts.{n}"] = shp.NamedSharding(
            mesh, shp.spec_for_param(("layers", "moe", "experts", n),
                                     arrays[n].shape, cfg, mesh))
    return shp.place_params(moe, shardings)


def _data(x: np.ndarray, mesh):
    t = torch.from_numpy(x)
    return shp.place(t, shp.data_sharding(t.shape, mesh))


def _moe_local(mesh, p: dict) -> dict:
    cfg = moe_cfg(fsdp=True, moe_buffer_shard="local")
    moe = _placed_moe(p, cfg, mesh, trainable=True)
    local_calls = []
    real = layers.moe_layer_local

    def counted(*args, **kwargs):
        local_calls.append(1)
        return real(*args, **kwargs)
    layers.moe_layer_local = counted
    try:
        with shp.activate(mesh):
            out, aux = layers.moe_layer(moe, _data(p["x"], mesh), cfg)
            loss = (out ** 2).mean() + aux
            leaves = [moe.router] + [moe.experts[n] for n in ("w1", "w3",
                                                              "w2")]
            grads = torch.autograd.grad(loss, leaves)
    finally:
        layers.moe_layer_local = real
    return {"out": _full(out), "aux": _full(aux), "local_calls":
            len(local_calls), "grads": dict(zip(("router", "w1", "w3", "w2"),
                                                map(_full, grads)))}


def _hints(mesh, cases: dict) -> dict:
    res = {}
    seen = []
    real = layers.constrain

    def spy(x, *spec):
        y = real(x, *spec)
        if x.dim() == 3 and len(spec) == 3 and shp.is_distributed(y):
            seen.append(str(list(y.placements)))
        return y
    layers.constrain = spy
    try:
        for label, case in cases.items():
            cfg = moe_cfg(n_experts=case["e"],
                          moe_buffer_shard=case["mode"])
            moe = _placed_moe(case, cfg, mesh, trainable=False)
            seen.clear()
            with shp.activate(mesh), torch.no_grad():
                out, aux = layers.moe_layer(moe, _data(case["x"], mesh), cfg)
            res[label] = {"out": _full(out), "aux": _full(aux),
                          "buffer": list(seen)}
    finally:
        layers.constrain = real
    return res


def _lm_steps(mesh, case: dict) -> dict:
    """Prefill (``make_prefill_step``), then ``steps`` decode steps twice:
    ``api.decode_step`` fed the reference's greedy tokens, every step's
    logits back; and ``make_decode_step``'s greedy loop on its own
    tokens."""
    cfg = get_arch(case["arch"]).reduced()
    if case.get("mode"):
        cfg = dataclasses.replace(cfg, moe_buffer_shard=case["mode"])
    api = get_model(cfg)
    params = lm_from_numpy(cfg, case["params"], torch.float32, "cpu")
    shp.place_params(params, shp.param_shardings(params, cfg, mesh))
    prefill = make_prefill_step(api, case["max_len"])
    serve = make_decode_step(api)
    batch = {"tokens": _data(case["tokens"], mesh)}
    with shp.activate(mesh), torch.no_grad():
        cache, last = prefill(params, batch)
        logits = [_full(last)]
        placements = {n: str(list(t.placements)) for n, t in cache.items()
                      if isinstance(t, torch.Tensor)}
        for fed in case["fed"]:
            step_logits, cache = api.decode_step(params, cache,
                                                 _data(fed, mesh))
            logits.append(_full(step_logits))
        cache, last = prefill(params, batch)
        tok = shp.constrain(last, "batch", None, None)[:, -1].argmax(-1)
        tok = tok.to(torch.int32)[:, None]
        greedy = [_full(tok)]
        for _ in case["fed"]:
            tok, cache = serve(params, cache, tok)
            greedy.append(_full(tok))
    return {"logits": logits, "greedy": greedy,
            "cache_placements": placements,
            "embed_placements": str(list(params.embed.placements))}


def _train(mesh) -> dict:
    params, opt, losses = train("mamba2-130m", steps=3, batch_size=4,
                                seq_len=16, mesh=mesh, log_every=3)
    return {"losses": losses,
            "params": {n: _full(p) for n, p in params.named_parameters()},
            "placements": {n: str(list(p.placements))
                           for n, p in params.named_parameters()}}


def _grad_shardings(mesh, batch: dict) -> dict:
    cfg = get_arch("qwen2.5-3b").reduced()
    api = get_model(cfg)
    params = make_trainable(api.init_params(torch.Generator().manual_seed(0),
                                            torch.float32, "cpu"))
    shardings = shp.param_shardings(params, cfg, mesh)
    shp.place_params(params, shardings)
    opt = adamw.init(dict(params.named_parameters()))
    step = make_train_step(api, 1, grad_shardings=shardings)
    pinned = []
    real = steps_module.with_sharding_constraint

    def spy(g, sharding):
        out = real(g, sharding)
        pinned.append((str(list(out.placements)), str(
            shp.placements(sharding.spec, mesh, g.dim()))))
        return out
    steps_module.with_sharding_constraint = spy
    try:
        with shp.activate(mesh):
            placed = {k: _data(v, mesh) for k, v in batch.items()}
            _, opt, metrics = step(params, opt, placed)
    finally:
        steps_module.with_sharding_constraint = real
    return {"m": {n: _full(m) for n, m in opt.m.items()},
            "placed": pinned, "loss": _full(metrics["loss"]),
            "split": sum(any(e is not None for e in s.spec)
                         for s in shardings.values())}


def _constrain(mesh) -> dict:
    x = torch.arange(64.0).reshape(8, 8)
    out = {}
    with shp.activate(mesh):
        for label, t, spec in (
                ("batch, model", x, ("batch", "model")),
                ("(data, model), None", x, (("data", "model"), None)),
                ("model on dim 0", x, ("model", None)),
                ("indivisible", torch.ones(3, 5), ("batch", "model"))):
            y = shp.constrain(t, *spec)
            out[label] = {"placements": str(list(y.placements)),
                          "local": tuple(y.to_local().shape),
                          "equal": bool(torch.equal(y.full_tensor(), t))}
    return out


def _walk(mesh, p: dict) -> dict:
    cfg = moe_cfg(fsdp=True, moe_buffer_shard="local")
    moe = _placed_moe(p, cfg, mesh, trainable=False)
    x = _data(p["x"], mesh)
    with shp.activate(mesh), torch.no_grad():
        acc = op_walk.analyze(layers.moe_layer, moe, x, cfg)
    terms = RooflineTerms(acc.flops, acc.hbm_bytes, acc.collective_wire_bytes,
                          4)
    return {"counts": dict(acc.collective_counts),
            "operand_bytes": dict(acc.collective_operand_bytes),
            "wire_bytes": acc.collective_wire_bytes,
            "collective_s": terms.collective_s}


def _kernels_refuse(mesh) -> dict:
    """Each kernel entry point handed a DTensor raises TypeError (a kernel
    launches on raw pointers; it never runs its plain version instead)."""
    from repro_torch.kernels import ops

    def dt(*shape, dtype=torch.float32):
        return shp.as_dtensor(torch.zeros(shape, dtype=dtype), mesh)
    calls = {
        "flash_attention": lambda: ops.flash_attention(
            dt(1, 4, 2, 8), dt(1, 4, 2, 8), dt(1, 4, 2, 8)),
        "decode_attention": lambda: ops.decode_attention(
            dt(1, 1, 2, 8), dt(1, 4, 2, 8), dt(1, 4, 2, 8),
            dt(4, dtype=torch.int32)),
        "ssd_scan": lambda: ops.ssd_scan(dt(1, 4, 2, 8), dt(1, 4, 2),
                                         dt(2), dt(1, 4, 1, 8),
                                         dt(1, 4, 1, 8)),
        "embedding_bag": lambda: ops.embedding_bag(
            dt(2, 3, dtype=torch.int32), dt(10, 4)),
        "fcfs_scan": lambda: ops.fcfs_scan(
            dt(1, 5), dt(1, 1, 5), dt(1, 2, dtype=torch.int32), dt(2),
            dt(1, 2), 1.0)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "ran"
        except TypeError as e:
            out[name] = str(e)
    return out


def checks(rank: int, world: int, payload: dict) -> dict:
    """Every check on this rank; each one's results, or its traceback
    under "error"."""
    torch.manual_seed(0)
    # four ranks beside the test workers: few intra-op threads each
    torch.set_num_threads(2)
    mesh = make_process_mesh((2, 2), ("data", "model"), device="cpu")
    runs = {"moe_local": lambda: _moe_local(mesh, payload["moe"]),
            "hints": lambda: _hints(mesh, payload["hints"]),
            "train": lambda: _train(mesh),
            "grad_shardings": lambda: _grad_shardings(mesh,
                                                      payload["batch"]),
            "constrain": lambda: _constrain(mesh),
            "kernels": lambda: _kernels_refuse(mesh),
            "walk": lambda: _walk(mesh, payload["moe"])}
    for label, case in payload["lm"].items():
        runs[f"lm {label}"] = lambda case=case: _lm_steps(mesh, case)
    out = {}
    for name, run in runs.items():
        try:
            out[name] = run()
        except Exception:  # noqa: BLE001  (each check reports its failure)
            out[name] = {"error": traceback.format_exc()}
    return out
