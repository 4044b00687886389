"""The paper's five served models (Table 1) in PyTorch.

Counterpart of ``repro/models/paper_models.py``: CANDLE (a molecular tower
and a shared drug tower, merged, then a residual prediction tower),
ResNet50 and VGG19 (conv nets), MT-WND (multi-task wide and deep
recommender) and DIEN (GRU interest extractor, attention, a second GRU).

MT-WND holds its eight embedding tables stacked, (n_tables, V, D), and all
their lookups go through one call of ``kernels.ops.embedding_bag``: one
launch of the CUDA kernel on a card, the plain version on the CPU.  The
other four models run no kernel of ours, as the reference runs no Pallas
kernel for them: their convs, products, pools and GRU steps are
``F.conv2d``, ``nn.Linear`` and small torch ops, and DIEN's lookups a plain
gather, as the reference's ``table[idx]``.

The conv nets copy the reference as it is.  Its convs and max pool pad as
XLA's ``"SAME"`` does, which at stride 2 puts the odd pixel at the high
end; the pads come from XLA's rule (``same_pads``), never from PyTorch's
symmetric ``padding=``.  Its ResNet50 has no batch norm and strides each
stage's first block on the 1x1 ``c1`` and ``proj``.  Inputs keep the
reference's NHWC layout, (B, H, W, 3), and are permuted once at the top of
``forward`` (NCHW-logical, channels-last in memory); VGG19 flattens in
NHWC order, as the reference.

Each model exposes ``init(generator, preset, device) -> module``,
``apply(module, batch) -> out``, ``input_spec(preset, batch)`` and
``from_numpy(params, preset, device) -> module``, which carries the
reference's parameter tree across (leaves as numpy arrays).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import embedding_bag_ref

# Integer inputs of random batches are drawn from [0, 100), as the
# reference does (repro/models/paper_models.py make_random_batch).
_CAT_RANGE = 100


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------


def _param(*shape, device) -> nn.Parameter:
    """An uninitialised parameter (no global RNG): ``*_init`` or
    ``*_from_numpy`` fills it."""
    return nn.Parameter(torch.empty(shape, device=device), requires_grad=False)


class MLP(nn.Module):
    """Linear layers with ReLU between them (and after the last when
    ``last_act``), the reference's ``_mlp_apply``."""

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


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of one spatial axis under XLA's ``"SAME"``: the
    output is ceil(size / stride) long, the total pad
    max((out - 1)·stride + k - size, 0), low = total // 2."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    """Pad an (N, C, H, W) tensor as XLA's ``"SAME"`` does."""
    h_lo, h_hi = same_pads(x.shape[2], k, stride)
    w_lo, w_hi = same_pads(x.shape[3], k, stride)
    if h_lo == h_hi == w_lo == w_hi == 0:
        return x
    return F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=value)


class Conv(nn.Module):
    """A k x k conv with XLA's ``"SAME"`` padding, the reference's
    ``_conv``.  The weight is (cout, cin, k, k); the reference's HWIO
    weight is its ``permute(3, 2, 0, 1)``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 device=None):
        super().__init__()
        self.weight = _param(cout, cin, k, k, device=device)
        self.bias = _param(cout, device=device)
        self.k, self.stride = k, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(_pad_same(x, self.k, self.stride), self.weight,
                        self.bias, self.stride)


def _max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``reduce_window(max, "SAME")``: pads of -inf by XLA's rule."""
    return F.max_pool2d(_pad_same(x, k, stride, value=-float("inf")), k,
                        stride)


class GRU(nn.Module):
    """The reference's ``_gru_scan``: gates r, z and h, each
    ``x @ wx + h @ wh + b``, the candidate's on ``r * h``.  Held with the
    three gates' ``wx`` side by side, (in, 3H), so one product covers every
    step's input terms; ``wh`` of r and z side by side, (H, 2H).  The sums
    keep the reference's order: (x @ wx + h @ wh) + b."""

    def __init__(self, in_dim: int, hidden: int, device=None):
        super().__init__()
        self.hidden = hidden
        self.wx = _param(in_dim, 3 * hidden, device=device)
        self.wh_rz = _param(hidden, 2 * hidden, device=device)
        self.wh_h = _param(hidden, hidden, device=device)
        self.b = _param(3 * hidden, device=device)

    def forward(self, xs: torch.Tensor, h: torch.Tensor):
        """xs (B, T, in), h (B, H) -> (h_T, states (B, T, H))."""
        hid = self.hidden
        gx = xs @ self.wx                              # (B, T, 3H)
        b_rz, b_h = self.b[:2 * hid], self.b[2 * hid:]
        states = []
        for t in range(xs.shape[1]):
            g = gx[:, t]
            rz = torch.sigmoid(g[:, :2 * hid] + h @ self.wh_rz + b_rz)
            r, z = rz[:, :hid], rz[:, hid:]
            hh = torch.tanh(g[:, 2 * hid:] + (r * h) @ self.wh_h + b_h)
            h = (1 - z) * h + z * hh
            states.append(h)
        return h, torch.stack(states, dim=1)


def _normal(generator: torch.Generator, shape, scale: float, device):
    return torch.randn(shape, generator=generator, device=device) * scale


@torch.no_grad()
def _init_layers(model: nn.Module, generator: torch.Generator,
                 device) -> None:
    """Fill every layer of ``model`` at the reference's scales, in module
    order: a^-0.5·N(0,1) weights with a = fan-in (cin·k·k for a conv; the
    input width for a GRU's ``wx``, H for its ``wh``), zero biases."""
    for layer in model.modules():
        if isinstance(layer, nn.Linear):
            fan_in = layer.in_features
            layer.weight.copy_(
                _normal(generator, (fan_in, layer.out_features),
                        fan_in ** -0.5, device).T)
            layer.bias.zero_()
        elif isinstance(layer, Conv):
            fan_in = layer.weight[0].numel()
            layer.weight.copy_(_normal(generator, layer.weight.shape,
                                       fan_in ** -0.5, device))
            layer.bias.zero_()
        elif isinstance(layer, GRU):
            for w in (layer.wx, layer.wh_rz, layer.wh_h):
                w.copy_(_normal(generator, w.shape, w.shape[0] ** -0.5,
                                device))
            layer.b.zero_()


def _put(dst: torch.Tensor, src) -> None:
    src = torch.tensor(np.asarray(src))
    if src.shape != dst.shape:
        raise ValueError(f"shape {tuple(src.shape)} for a parameter of "
                         f"shape {tuple(dst.shape)}")
    dst.copy_(src)


def _put_mlp(mlp: MLP, layers) -> None:
    """The reference stores ``x @ w + b`` with ``w`` of shape (in, out);
    ``nn.Linear`` holds (out, in), so weights are transposed."""
    if len(layers) != len(mlp.layers):
        raise ValueError(f"{len(layers)} layers for an MLP of "
                         f"{len(mlp.layers)}")
    for lin, layer in zip(mlp.layers, layers):
        _put(lin.weight, np.asarray(layer["w"]).T)
        _put(lin.bias, layer["b"])


def _put_conv(conv: Conv, p) -> None:
    """HWIO -> OIHW."""
    _put(conv.weight, np.asarray(p["w"]).transpose(3, 2, 0, 1))
    _put(conv.bias, p["b"])


def _put_gru(gru: GRU, p) -> None:
    gates = [p[g] for g in ("r", "z", "h")]
    _put(gru.wx, np.concatenate([np.asarray(g["wx"]) for g in gates], 1))
    _put(gru.wh_rz, np.concatenate([np.asarray(g["wh"]) for g in gates[:2]],
                                   1))
    _put(gru.wh_h, gates[2]["wh"])
    _put(gru.b, np.concatenate([np.asarray(g["b"]) for g in gates]))


def _check_len(what: str, got, want: int, preset: str) -> None:
    if len(got) != want:
        raise ValueError(f"{len(got)} {what} for preset {preset!r}, "
                         f"expected {want}")


# --------------------------------------------------------------------------
# CANDLE
# --------------------------------------------------------------------------

CANDLE_PRESETS = {
    "full": dict(mol_dim=942, drug_dim=3820, tower=1000, depth=3,
                 res_width=1000, res_blocks=3),
    "smoke": dict(mol_dim=32, drug_dim=48, tower=64, depth=2,
                  res_width=64, res_blocks=2),
}


class CANDLE(nn.Module):
    """CANDLE: (mol (B, mol_dim), drug1, drug2 (B, drug_dim)) -> (B, 1).
    One drug tower serves both drugs, as in the reference."""

    def __init__(self, preset: str = "smoke", device=None):
        super().__init__()
        cfg = CANDLE_PRESETS[preset]
        t, rw = cfg["tower"], cfg["res_width"]
        self.mol_tower = MLP([cfg["mol_dim"]] + [t] * cfg["depth"],
                             last_act=True, device=device)
        self.drug_tower = MLP([cfg["drug_dim"]] + [t] * cfg["depth"],
                              last_act=True, device=device)
        self.merge = MLP([3 * t, rw], device=device)
        self.res_blocks = nn.ModuleList(
            MLP([rw] * 3, device=device) for _ in range(cfg["res_blocks"]))
        self.head = MLP([rw, 1], device=device)
        self.requires_grad_(False)

    def forward(self, mol, drug1, drug2):
        h = self.merge(torch.cat([self.mol_tower(mol), self.drug_tower(drug1),
                                  self.drug_tower(drug2)], dim=-1))
        for blk in self.res_blocks:
            h = h + blk(torch.relu(h))
        return self.head(torch.relu(h))


@torch.no_grad()
def candle_init(generator: torch.Generator, preset: str = "smoke",
                device=None) -> CANDLE:
    dev = resolve_device(device)
    model = CANDLE(preset, device=dev)
    _init_layers(model, generator, dev)
    return model


@torch.no_grad()
def candle_from_numpy(params, preset: str = "smoke", device=None) -> CANDLE:
    model = CANDLE(preset, device=resolve_device(device))
    _put_mlp(model.mol_tower, params["mol_tower"])
    _put_mlp(model.drug_tower, params["drug_tower"])
    _put_mlp(model.merge, params["merge"])
    _check_len("residual blocks", params["res_blocks"],
               len(model.res_blocks), preset)
    for blk, layers in zip(model.res_blocks, params["res_blocks"]):
        _put_mlp(blk, layers)
    _put_mlp(model.head, params["head"])
    return model


@torch.inference_mode()
def candle_apply(model: CANDLE, batch: dict):
    return model(batch["mol"], batch["drug1"], batch["drug2"])


def candle_input_spec(preset: str, batch: int) -> dict:
    cfg = CANDLE_PRESETS[preset]
    f = torch.float32
    return {"mol": ((batch, cfg["mol_dim"]), f),
            "drug1": ((batch, cfg["drug_dim"]), f),
            "drug2": ((batch, cfg["drug_dim"]), f)}


# --------------------------------------------------------------------------
# ResNet50 and VGG19
# --------------------------------------------------------------------------

RESNET_PRESETS = {
    # (blocks per stage, base width, img)
    "full": dict(stages=(3, 4, 6, 3), width=64, img=224),
    "smoke": dict(stages=(1, 1, 1, 1), width=8, img=32),
}


class Bottleneck(nn.Module):
    """The reference's block: 1x1 ``c1`` (strided), 3x3 ``c2``, 1x1 ``c3``,
    a strided 1x1 ``proj`` shortcut where the width changes; no norm."""

    def __init__(self, cin: int, cmid: int, cout: int, stride: int,
                 device=None):
        super().__init__()
        self.c1 = Conv(cin, cmid, 1, stride, device=device)
        self.c2 = Conv(cmid, cmid, 3, device=device)
        self.c3 = Conv(cmid, cout, 1, device=device)
        self.proj = (Conv(cin, cout, 1, stride, device=device)
                     if cin != cout else None)

    def forward(self, x):
        h = torch.relu(self.c1(x))
        h = torch.relu(self.c2(h))
        h = self.c3(h)
        return torch.relu(h + (x if self.proj is None else self.proj(x)))


class ResNet50(nn.Module):
    """ResNet50 as the reference builds it: image (B, H, W, 3) -> (B, 1000)."""

    def __init__(self, preset: str = "smoke", device=None):
        super().__init__()
        cfg = RESNET_PRESETS[preset]
        w = cfg["width"]
        self.stem = Conv(3, w, 7, 2, device=device)
        self.stages = nn.ModuleList()
        cin = w
        for si, n_blocks in enumerate(cfg["stages"]):
            cmid = w * 2 ** si
            stage = nn.ModuleList()
            for bi in range(n_blocks):
                stride = 2 if si > 0 and bi == 0 else 1
                stage.append(Bottleneck(cin, cmid, 4 * cmid, stride,
                                        device=device))
                cin = 4 * cmid
            self.stages.append(stage)
        self.head = MLP([cin, 1000], device=device)
        self.requires_grad_(False)

    def forward(self, image):
        x = torch.relu(self.stem(image.permute(0, 3, 1, 2)))
        x = _max_pool_same(x, 3, 2)
        for stage in self.stages:
            for blk in stage:
                x = blk(x)
        return self.head(x.mean(dim=(2, 3)))


@torch.no_grad()
def resnet50_init(generator: torch.Generator, preset: str = "smoke",
                  device=None) -> ResNet50:
    dev = resolve_device(device)
    model = ResNet50(preset, device=dev)
    _init_layers(model, generator, dev)
    return model


@torch.no_grad()
def resnet50_from_numpy(params, preset: str = "smoke",
                        device=None) -> ResNet50:
    model = ResNet50(preset, device=resolve_device(device))
    _put_conv(model.stem, params["stem"])
    _check_len("stages", params["stages"], len(model.stages), preset)
    for stage, blocks in zip(model.stages, params["stages"]):
        _check_len("blocks", blocks, len(stage), preset)
        for blk, p in zip(stage, blocks):
            for name in ("c1", "c2", "c3"):
                _put_conv(getattr(blk, name), p[name])
            if (blk.proj is None) != ("proj" not in p):
                raise ValueError("a block's projection does not match")
            if blk.proj is not None:
                _put_conv(blk.proj, p["proj"])
    _put_mlp(model.head, params["head"])
    return model


@torch.inference_mode()
def resnet50_apply(model: ResNet50, batch: dict):
    return model(batch["image"])


def resnet50_input_spec(preset: str, batch: int) -> dict:
    img = RESNET_PRESETS[preset]["img"]
    return {"image": ((batch, img, img, 3), torch.float32)}


VGG_PRESETS = {
    "full": dict(plan=((64, 2), (128, 2), (256, 4), (512, 4), (512, 4)),
                 img=224, fc=4096),
    "smoke": dict(plan=((8, 1), (16, 1)), img=32, fc=32),
}


class VGG19(nn.Module):
    """VGG19: image (B, H, W, 3) -> (B, 1000).  The features are flattened
    in NHWC order, as the reference's ``reshape``."""

    def __init__(self, preset: str = "smoke", device=None):
        super().__init__()
        cfg = VGG_PRESETS[preset]
        self.convs = nn.ModuleList()
        cin = 3
        for width, reps in cfg["plan"]:
            group = nn.ModuleList()
            for _ in range(reps):
                group.append(Conv(cin, width, 3, device=device))
                cin = width
            self.convs.append(group)
        feat = cin * (cfg["img"] // 2 ** len(cfg["plan"])) ** 2
        self.fc = MLP([feat, cfg["fc"], cfg["fc"], 1000], device=device)
        self.requires_grad_(False)

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)
        for group in self.convs:
            for conv in group:
                x = torch.relu(conv(x))
            x = F.max_pool2d(x, 2, 2)
        return self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


@torch.no_grad()
def vgg19_init(generator: torch.Generator, preset: str = "smoke",
               device=None) -> VGG19:
    dev = resolve_device(device)
    model = VGG19(preset, device=dev)
    _init_layers(model, generator, dev)
    return model


@torch.no_grad()
def vgg19_from_numpy(params, preset: str = "smoke", device=None) -> VGG19:
    model = VGG19(preset, device=resolve_device(device))
    _check_len("conv groups", params["convs"], len(model.convs), preset)
    for group, ps in zip(model.convs, params["convs"]):
        _check_len("convs", ps, len(group), preset)
        for conv, p in zip(group, ps):
            _put_conv(conv, p)
    _put_mlp(model.fc, params["fc"])
    return model


@torch.inference_mode()
def vgg19_apply(model: VGG19, batch: dict):
    return model(batch["image"])


def vgg19_input_spec(preset: str, batch: int) -> dict:
    img = VGG_PRESETS[preset]["img"]
    return {"image": ((batch, img, img, 3), torch.float32)}


# --------------------------------------------------------------------------
# MT-WND
# --------------------------------------------------------------------------

MTWND_PRESETS = {
    "full": dict(n_tables=8, vocab=200_000, emb=64, bag=8, dense=13,
                 bottom=(512, 256), tasks=4, tower=(128, 64)),
    "smoke": dict(n_tables=3, vocab=128, emb=16, bag=4, dense=8,
                  bottom=(32, 16), tasks=2, tower=(16, 8)),
}


class MTWND(nn.Module):
    """MT-WND: (dense (B, dense), cat (B, n_tables, bag) int32) → (B, tasks)."""

    def __init__(self, preset: str = "smoke", device=None):
        super().__init__()
        cfg = MTWND_PRESETS[preset]
        self.preset = preset
        # (n_tables, V, D): model.tables[i] is table i
        self.tables = _param(cfg["n_tables"], cfg["vocab"], cfg["emb"],
                             device=device)
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
    _init_layers(model, generator, dev)
    return model


@torch.no_grad()
def mtwnd_from_numpy(params, preset: str = "smoke", device=None) -> MTWND:
    """The reference's list of tables is stacked into ``model.tables``."""
    model = MTWND(preset, device=resolve_device(device))
    _check_len("tables", params["tables"], len(model.tables), preset)
    for table, src in zip(model.tables, params["tables"]):
        _put(table, src)
    _put_mlp(model.bottom, params["bottom"])
    for tower, layers in zip(model.towers, params["towers"], strict=True):
        _put_mlp(tower, layers)
    _put_mlp(model.wide, params["wide"])
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


# --------------------------------------------------------------------------
# DIEN
# --------------------------------------------------------------------------

DIEN_PRESETS = {
    "full": dict(vocab=500_000, emb=64, hist=50, hidden=128, dense=13,
                 mlp=(200, 80)),
    "smoke": dict(vocab=128, emb=16, hist=8, hidden=16, dense=8,
                  mlp=(16, 8)),
}


class DIEN(nn.Module):
    """DIEN: (dense (B, dense), hist (B, T) int32, target (B,) int32) ->
    CTR (B, 1).  GRU 1 extracts interest states from the history, the
    target attends over them, and GRU 2 runs over the attention-weighted
    states (the reference's "AUGRU approx")."""

    def __init__(self, preset: str = "smoke", device=None):
        super().__init__()
        cfg = DIEN_PRESETS[preset]
        emb, hid = cfg["emb"], cfg["hidden"]
        self.table = _param(cfg["vocab"], emb, device=device)
        self.gru1 = GRU(emb, hid, device=device)
        self.gru2 = GRU(hid, hid, device=device)
        self.attn = MLP([hid + emb, 36, 1], device=device)
        self.mlp = MLP([cfg["dense"] + emb + hid, *cfg["mlp"], 1],
                       device=device)
        self.requires_grad_(False)

    def forward(self, dense, hist, target):
        hist_emb = self.table[hist]                      # (B, T, E)
        tgt_emb = self.table[target]                     # (B, E)
        b, t, e = hist_emb.shape
        h0 = hist_emb.new_zeros(b, self.gru1.hidden)
        _, interest = self.gru1(hist_emb, h0)            # (B, T, H)
        score_in = torch.cat([interest, tgt_emb[:, None, :].expand(b, t, e)],
                             dim=-1)
        att = torch.softmax(self.attn(score_in)[..., 0], dim=-1)   # (B, T)
        final_interest, _ = self.gru2(interest * att[..., None], h0)
        x = torch.cat([dense, tgt_emb, final_interest], dim=-1)
        return torch.sigmoid(self.mlp(x))


@torch.no_grad()
def dien_init(generator: torch.Generator, preset: str = "smoke",
              device=None) -> DIEN:
    """0.01·N(0,1) table, the layers as ``_init_layers``."""
    dev = resolve_device(device)
    model = DIEN(preset, device=dev)
    model.table.copy_(_normal(generator, model.table.shape, 0.01, dev))
    _init_layers(model, generator, dev)
    return model


@torch.no_grad()
def dien_from_numpy(params, preset: str = "smoke", device=None) -> DIEN:
    model = DIEN(preset, device=resolve_device(device))
    _put(model.table, params["table"])
    _put_gru(model.gru1, params["gru1"])
    _put_gru(model.gru2, params["gru2"])
    _put_mlp(model.attn, params["attn"])
    _put_mlp(model.mlp, params["mlp"])
    return model


@torch.inference_mode()
def dien_apply(model: DIEN, batch: dict):
    return model(batch["dense"], batch["hist"], batch["target"])


def dien_input_spec(preset: str, batch: int) -> dict:
    cfg = DIEN_PRESETS[preset]
    return {"dense": ((batch, cfg["dense"]), torch.float32),
            "hist": ((batch, cfg["hist"]), torch.int32),
            "target": ((batch,), torch.int32)}


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PaperModel:
    name: str
    init: callable
    apply: callable
    input_spec: callable
    from_numpy: callable


PAPER_MODELS = {
    "candle": PaperModel("candle", candle_init, candle_apply,
                         candle_input_spec, candle_from_numpy),
    "resnet50": PaperModel("resnet50", resnet50_init, resnet50_apply,
                           resnet50_input_spec, resnet50_from_numpy),
    "vgg19": PaperModel("vgg19", vgg19_init, vgg19_apply, vgg19_input_spec,
                        vgg19_from_numpy),
    "mtwnd": PaperModel("mtwnd", mtwnd_init, mtwnd_apply, mtwnd_input_spec,
                        mtwnd_from_numpy),
    "dien": PaperModel("dien", dien_init, dien_apply, dien_input_spec,
                       dien_from_numpy),
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
