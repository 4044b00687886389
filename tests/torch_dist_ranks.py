"""The rank side of ``tests/test_torch_distributed.py`` and
``tests/test_torch_mesh_heads.py``: what each of four gloo ranks on the
CPU runs on a (2, 2) or (1, 4) ("data", "model") mesh (the payload's
``mesh``).  It imports only torch and the port (never JAX or the
reference): the test process computes the reference's answers and passes
them in as numpy arrays, and compares what the ranks send back.
``checks`` runs every check in one spawn and reports each one's results,
or its traceback, under its name.
"""

from __future__ import annotations

import dataclasses
import traceback
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_arch
from repro_torch.launch import sharding as shp
from repro_torch.launch import steps as steps_module
from repro_torch.launch import train as train_module
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.launch.train import train, train_state
from repro_torch.models import layers
from repro_torch.models.transformer import (get_model, lm_from_numpy,
                                            make_trainable)
from repro_torch.optim import adamw
from repro_torch.roofline import op_walk
from repro_torch.roofline.analysis import RooflineTerms
from repro_torch.serving import checkpoint

# the sharded training runs, on the configuration ``reduced_arch`` gives
TRAIN = dict(batch_size=4, seq_len=16, smoke=False)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

MOE_BASE = dict(d_model=32, d_expert=64, n_experts=4, top_k=2,
                moe_capacity_factor=8.0)


def moe_cfg(**kw):
    """The reference test's MoE configuration (``tests/test_moe_local.py``):
    mixtral-8x22b ``reduced()``, d 32, d_expert 64, 4 experts, top 2,
    capacity 8.0, with ``kw`` on top."""
    return dataclasses.replace(get_arch("mixtral-8x22b").reduced(),
                               **{**MOE_BASE, **kw})


@contextmanager
def reduced_arch(arch: str, replace: dict | None):
    """Within: ``train(arch, smoke=False)`` trains ``arch``'s ``reduced()``
    configuration with the fields of ``replace`` on top (``get_arch`` of
    ``launch.train`` patched)."""
    real = train_module.get_arch
    cfg = dataclasses.replace(real(arch).reduced(), **(replace or {}))
    train_module.get_arch = lambda name: cfg if name == arch else real(name)
    try:
        yield
    finally:
        train_module.get_arch = real


@contextmanager
def counted_head_gathers():
    """Within: each time ``sharding.split_heads`` or ``merge_heads``
    gathers a dimension (a collective) appends to the list it yields."""
    gathers = []
    real = shp._whole_where_uneven

    def counted(x, dim, n):
        y = real(x, dim, n)
        if y is not x:
            gathers.append((tuple(x.shape), dim, n))
        return y
    shp._whole_where_uneven = counted
    try:
        yield gathers
    finally:
        shp._whole_where_uneven = real


class GatherOperands(TorchDispatchMode):
    """Within: the shape of every all-gather's operand (``shapes``), a
    local shard of whatever is gathered; ops on DTensors are handed on to
    DTensor, whose collectives come back here (as ``op_walk`` counts
    them).  Nothing else changes: it nests around an op walk."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if op_walk._handed_on(types):
            return NotImplemented
        if func._schema.name == "_c10d_functional::all_gather_into_tensor":
            self.shapes.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


def held_shapes(params, cache: dict) -> list:
    """The local shapes of every parameter and of one layer of the SSM
    state (none without one): what a decode step must not gather."""
    shapes = {tuple(shp.local_tensor(p).shape) for p in params.parameters()}
    if "state" in cache:
        state = shp.local_tensor(cache["state"])
        shapes.add(tuple(state.shape[-4:]))
    return sorted(shapes)


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
    cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                              **case.get("replace", {}))
    if case.get("mode"):
        cfg = dataclasses.replace(cfg, moe_buffer_shard=case["mode"])
    api = get_model(cfg)
    params = lm_from_numpy(cfg, case["params"], torch.float32, "cpu")
    shp.place_params(params, shp.param_shardings(params, cfg, mesh))
    prefill = make_prefill_step(api, case["max_len"])
    serve = make_decode_step(api)
    batch = {"tokens": _data(case["tokens"], mesh)}
    if case.get("extra") is not None:
        batch["extra"] = _data(case["extra"], mesh)
    with shp.activate(mesh), torch.no_grad(), \
            counted_head_gathers() as gathers:
        cache, last = prefill(params, batch)
        logits = [_full(last)]
        placements = {n: str(list(t.placements)) for n, t in cache.items()
                      if isinstance(t, torch.Tensor)}
        # the first decode step's all-gathers, beside what it holds
        held, operands = held_shapes(params, cache), GatherOperands()
        for i, fed in enumerate(case["fed"]):
            with operands if i == 0 else nullcontext():
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
    return {"logits": logits, "greedy": greedy, "head_gathers": len(gathers),
            "step_gathers": operands.shapes, "held": held,
            "cache_placements": placements,
            "embed_placements": str(list(params.embed.placements))}


def _prefill_collectives(mesh, case: dict) -> dict:
    """The collectives one fp32 prefill of ``case`` runs on this rank
    (``make_prefill_step``), by op, as ``CommDebugMode`` counts them:
    what a walk of the same call (``launch.dryrun``) must count."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                              **case.get("replace", {}))
    api = get_model(cfg)
    params = lm_from_numpy(cfg, case["params"], torch.float32, "cpu")
    shp.place_params(params, shp.param_shardings(params, cfg, mesh))
    batch = {"tokens": _data(case["tokens"], mesh)}
    with shp.activate(mesh), torch.no_grad(), CommDebugMode() as comm:
        make_prefill_step(api, case["max_len"])(params, batch)
    return {str(op): n for op, n in comm.get_comm_counts().items()}


def _train(mesh, replace: dict | None) -> dict:
    with reduced_arch("mamba2-130m", replace), \
            counted_head_gathers() as gathers:
        params, opt, losses = train("mamba2-130m", steps=3, mesh=mesh,
                                    log_every=3, **TRAIN)
    return {"losses": losses, "head_gathers": len(gathers),
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


def _ssm_step(mesh, case: dict) -> dict:
    """One fp32 ``make_train_step`` of reduced mamba2-130m with the fields
    of ``case["replace"]`` on top, placed by ``param_shardings``: the loss
    and AdamW's first moment (a tenth of the gradient)."""
    cfg = dataclasses.replace(get_arch("mamba2-130m").reduced(),
                              **case["replace"])
    api = get_model(cfg)
    params = make_trainable(api.init_params(torch.Generator().manual_seed(0),
                                            torch.float32, "cpu"))
    shp.place_params(params, shp.param_shardings(params, cfg, mesh))
    opt = adamw.init(dict(params.named_parameters()))
    with shp.activate(mesh), counted_head_gathers() as gathers:
        batch = {k: _data(v, mesh) for k, v in case["batch"].items()}
        _, opt, metrics = make_train_step(api, 1)(params, opt, batch)
    return {"m": {n: _full(m) for n, m in opt.m.items()},
            "loss": _full(metrics["loss"]), "head_gathers": len(gathers)}


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


def _host_leaves(state) -> list:
    """The leaves of a train state as ``checkpoint.save`` writes them: each
    DTensor gathered whole, on the host (bf16 as ``|V2``)."""
    return [checkpoint._to_host(leaf.full_tensor() if shp.is_distributed(leaf)
                                else leaf)
            for leaf in checkpoint._flatten(state)]


def _differ(state, path: Path) -> list:
    """Indices of the leaves of ``state`` (gathered) that differ, bit for
    bit, from the file's; the leaf counts too where they differ."""
    held = _host_leaves(state)
    with np.load(path) as f:
        files = [f[f"leaf_{i}"] for i in range(len(f.files))]
    if len(files) != len(held):
        return [("count", len(held), len(files))]
    return [i for i, (a, b) in enumerate(zip(held, files))
            if a.dtype != b.dtype or a.shape != b.shape
            or a.tobytes() != b.tobytes()]


def _off_mesh(params, opt, mesh) -> list:
    """Names of the parameters and AdamW leaves not placed by
    ``param_shardings`` (``master``, ``m`` and ``v`` as their parameters);
    the step counter must stay a plain tensor."""
    cfg = train_module.get_arch("mamba2-130m")
    leaves = params.state_dict(keep_vars=True)
    want = {n: str(shp.placements(s.spec, mesh, leaves[n].dim()))
            for n, s in shp.param_shardings(params, cfg, mesh).items()}
    out = [("step", "DTensor")] if shp.is_distributed(opt.step) else []
    for field, named in (("param", dict(params.named_parameters())),
                         ("master", opt.master), ("m", opt.m), ("v", opt.v)):
        for n, t in named.items():
            got = (str(list(t.placements)) if shp.is_distributed(t)
                   else "plain")
            if got != want[n]:
                out.append((field, n, got))
    return out


def _ckpt(mesh, case: dict, dtype: str) -> dict:
    """A-18 on the mesh in ``dtype``: (a) a 4-step run with a checkpoint
    every step, its step-4 file against the gathered tensors; (b) 2 steps,
    a checkpoint, a resume for 2 more, against that run; (c) the one-card
    checkpoint of ``case["one_card"]`` resumed under the mesh; (d) the
    writes each rank made (``np.savez`` calls) and the files kept."""
    kw = dict(mesh=mesh, log_every=100, param_dtype=DTYPES[dtype], **TRAIN)
    root = Path(case["dir"]) / dtype
    writes = []
    real = np.savez

    def counted(*args, **kwargs):
        writes.append(1)
        return real(*args, **kwargs)
    np.savez = counted
    try:
        with reduced_arch("mamba2-130m", case.get("replace")):
            params, opt, losses = train("mamba2-130m", steps=4,
                                        ckpt_dir=root / "every", ckpt_every=1,
                                        **kw)
            train("mamba2-130m", steps=2, ckpt_dir=root / "resume",
                  ckpt_every=2, **kw)
            again, opt2, resumed = train("mamba2-130m", steps=2,
                                         ckpt_dir=root / "resume",
                                         ckpt_every=2, resume=True, **kw)
            one, opt1, _ = train("mamba2-130m", steps=0, resume=True,
                                 ckpt_dir=case["one_card"][dtype], **kw)
            cfg = train_module.get_arch("mamba2-130m")
            differ = {
                "every": _differ(train_state(cfg, params, opt),
                                 root / "every" / "step_0000000004.npz"),
                "one_card": _differ(train_state(cfg, one, opt1), Path(
                    case["one_card"][dtype]) / "step_0000000002.npz")}
            off = {"resumed": _off_mesh(again, opt2, mesh),
                   "one_card": _off_mesh(one, opt1, mesh)}
    finally:
        np.savez = real
    gathered = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(gathered, len(writes))
    named = dict(params.named_parameters())
    return {
        "losses": losses, "resumed_losses": resumed,
        "differ_params": [n for n, p in again.named_parameters()
                          if not torch.equal(p.full_tensor(),
                                             named[n].full_tensor())],
        "differ_opt": [(f, n) for f in ("master", "m", "v")
                       for n, t in getattr(opt2, f).items()
                       if not torch.equal(t.full_tensor(),
                                          getattr(opt, f)[n].full_tensor())],
        "steps": (int(opt.step), int(opt2.step), int(opt1.step)),
        "differ_files": differ, "off_mesh": off, "writes": gathered,
        "kept": sorted(p.name for p in (root / "every").iterdir()),
        "params": {n: _full(p) for n, p in again.named_parameters()}}


def checks(rank: int, world: int, payload: dict) -> dict:
    """Every check on this rank; each one's results, or its traceback
    under "error"."""
    torch.manual_seed(0)
    # four ranks beside the test workers: few intra-op threads each
    torch.set_num_threads(2)
    mesh = make_process_mesh(payload["mesh"], ("data", "model"),
                             device="cpu")
    runs = {}
    if "moe" in payload:
        runs.update({
            "moe_local": lambda: _moe_local(mesh, payload["moe"]),
            "hints": lambda: _hints(mesh, payload["hints"]),
            "grad_shardings": lambda: _grad_shardings(mesh, payload["batch"]),
            "constrain": lambda: _constrain(mesh),
            "kernels": lambda: _kernels_refuse(mesh),
            "walk": lambda: _walk(mesh, payload["moe"])})
    runs["train"] = lambda: _train(mesh, payload["ckpt"].get("replace"))
    if "ssm_step" in payload:
        runs["ssm_step"] = lambda: _ssm_step(mesh, payload["ssm_step"])
    for label, case in payload["lm"].items():
        runs[f"lm {label}"] = lambda case=case: _lm_steps(mesh, case)
    if "collectives" in payload:
        runs["collectives"] = lambda: _prefill_collectives(
            mesh, payload["lm"][payload["collectives"]])
    for dtype in DTYPES:
        runs[f"ckpt {dtype}"] = lambda dtype=dtype: _ckpt(
            mesh, payload["ckpt"], dtype)
    out = {}
    for name, run in runs.items():
        try:
            out[name] = run()
        except Exception:  # noqa: BLE001  (each check reports its failure)
            out[name] = {"error": traceback.format_exc()}
    return out
