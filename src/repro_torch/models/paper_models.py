"""The paper's served models in PyTorch; this slice holds MT-WND.

Counterpart of ``repro/models/paper_models.py``.  MT-WND is the multi-task
wide-and-deep recommender: eight embedding tables pooled by bag sums, a
shared bottom MLP, one tower per task and a wide linear part, summed into
per-task logits and squashed by a sigmoid.  Its tables are held stacked,
(n_tables, V, D), and all their lookups go through one call of
``kernels.ops.embedding_bag``: one launch of the CUDA kernel on a card, the
plain version on the CPU.  The matrix products stay ``nn.Linear``, as the
reference leaves them to XLA outside any Pallas kernel.

Each model exposes ``init(generator, preset, device) -> module``,
``apply(module, batch) -> out`` and ``input_spec(preset, batch)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import embedding_bag_ref

MTWND_PRESETS = {
    "full": dict(n_tables=8, vocab=200_000, emb=64, bag=8, dense=13,
                 bottom=(512, 256), tasks=4, tower=(128, 64)),
    "smoke": dict(n_tables=3, vocab=128, emb=16, bag=4, dense=8,
                  bottom=(32, 16), tasks=2, tower=(16, 8)),
}

# Categorical inputs of random batches are drawn from [0, 100), as the
# reference does (repro/models/paper_models.py make_random_batch).
_CAT_RANGE = 100


class MLP(nn.Module):
    """Linear layers with ReLU between them (and after the last when
    ``last_act``), the reference's ``_mlp_apply``.  Parameters are left
    uninitialised (no global RNG): ``mtwnd_init`` or ``mtwnd_from_numpy``
    fills them."""

    def __init__(self, dims, last_act: bool = False, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, a, b, device=device)
            for a, b in zip(dims[:-1], dims[1:]))
        self.last_act = last_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1 or self.last_act:
                x = torch.relu(x)
        return x


class MTWND(nn.Module):
    """MT-WND: (dense (B, dense), cat (B, n_tables, bag) int32) → (B, tasks)."""

    def __init__(self, preset: str = "smoke", device=None):
        super().__init__()
        cfg = MTWND_PRESETS[preset]
        self.preset = preset
        # (n_tables, V, D): model.tables[i] is table i
        self.tables = nn.Parameter(
            torch.empty(cfg["n_tables"], cfg["vocab"], cfg["emb"],
                        device=device), requires_grad=False)
        in_dim = cfg["dense"] + cfg["n_tables"] * cfg["emb"]
        self.bottom = MLP([in_dim, *cfg["bottom"]], last_act=True,
                          device=device)
        self.towers = nn.ModuleList(
            MLP([cfg["bottom"][-1], *cfg["tower"], 1], device=device)
            for _ in range(cfg["tasks"]))
        self.wide = MLP([in_dim, cfg["tasks"]], device=device)
        self.requires_grad_(False)

    def forward(self, dense: torch.Tensor, cat: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
        """``use_kernel=False`` pools with the plain version on any device;
        it exists to hold the kernel path against it."""
        bag_fn = ops.embedding_bag if use_kernel else embedding_bag_ref
        x = torch.cat([dense, bag_fn(cat, self.tables)], dim=-1)
        deep = self.bottom(x)
        task_logits = torch.cat([tower(deep) for tower in self.towers], dim=-1)
        return torch.sigmoid(task_logits + self.wide(x))


def _normal(generator: torch.Generator, shape, scale: float, device):
    return torch.randn(shape, generator=generator, device=device) * scale


@torch.no_grad()
def mtwnd_init(generator: torch.Generator, preset: str = "smoke",
               device=None) -> MTWND:
    """Random MT-WND at the reference's scales: 0.01·N(0,1) tables,
    a^-0.5·N(0,1) weights (a = fan-in), zero biases.  Drawn on ``device``
    from ``generator``, which must live there."""
    dev = resolve_device(device)
    model = MTWND(preset, device=dev)
    for table in model.tables:
        table.copy_(_normal(generator, table.shape, 0.01, dev))
    for layer in model.modules():
        if isinstance(layer, nn.Linear):
            fan_in = layer.in_features
            layer.weight.copy_(
                _normal(generator, (fan_in, layer.out_features),
                        fan_in ** -0.5, dev).T)
            layer.bias.zero_()
    return model


@torch.no_grad()
def mtwnd_from_numpy(params, preset: str = "smoke", device=None) -> MTWND:
    """The port's MT-WND from the reference's parameter tree (the output of
    ``repro.models.paper_models.mtwnd_init``, converted leaf by leaf with
    ``np.asarray``).  The reference's list of tables is stacked into
    ``model.tables``.  The reference stores ``x @ w + b`` with ``w`` of
    shape (in, out); ``nn.Linear`` holds (out, in), so weights are
    transposed."""
    dev = resolve_device(device)
    model = MTWND(preset, device=dev)

    def put(dst: torch.Tensor, src) -> None:
        src = torch.tensor(np.asarray(src))
        if src.shape != dst.shape:
            raise ValueError(f"shape {tuple(src.shape)} for a parameter of "
                             f"shape {tuple(dst.shape)}")
        dst.copy_(src)

    def put_mlp(mlp: MLP, layers) -> None:
        if len(layers) != len(mlp.layers):
            raise ValueError(f"{len(layers)} layers for an MLP of "
                             f"{len(mlp.layers)}")
        for lin, layer in zip(mlp.layers, layers):
            put(lin.weight, np.asarray(layer["w"]).T)
            put(lin.bias, layer["b"])

    if len(params["tables"]) != len(model.tables):
        raise ValueError(f"{len(params['tables'])} tables for preset "
                         f"{preset!r}")
    for table, src in zip(model.tables, params["tables"]):
        put(table, src)
    put_mlp(model.bottom, params["bottom"])
    for tower, layers in zip(model.towers, params["towers"], strict=True):
        put_mlp(tower, layers)
    put_mlp(model.wide, params["wide"])
    return model


@torch.inference_mode()
def mtwnd_apply(model: MTWND, batch: dict, use_kernel: bool = True):
    """batch = {dense (B, dense) float32, cat (B, n_tables, bag) int32}."""
    return model(batch["dense"], batch["cat"], use_kernel=use_kernel)


def mtwnd_input_spec(preset: str, batch: int) -> dict:
    """Name → (shape, dtype) of one batch's inputs."""
    cfg = MTWND_PRESETS[preset]
    return {"dense": ((batch, cfg["dense"]), torch.float32),
            "cat": ((batch, cfg["n_tables"], cfg["bag"]), torch.int32)}


@dataclass(frozen=True)
class PaperModel:
    name: str
    init: callable
    apply: callable
    input_spec: callable


PAPER_MODELS = {
    "mtwnd": PaperModel("mtwnd", mtwnd_init, mtwnd_apply, mtwnd_input_spec),
}


def make_random_batch(model_name: str, preset: str, batch: int,
                      seed: int = 0, device=None) -> dict:
    """A random input batch drawn on ``device`` from a generator seeded with
    ``seed``: standard normal floats, integers in [0, 100).  The numbers
    differ from the reference's threefry draws of the same seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, (shape, dtype) in PAPER_MODELS[model_name].input_spec(
            preset, batch).items():
        if dtype.is_floating_point:
            out[name] = torch.randn(shape, generator=gen, device=dev,
                                    dtype=dtype)
        else:
            out[name] = torch.randint(0, _CAT_RANGE, shape, generator=gen,
                                      device=dev, dtype=dtype)
    return out
