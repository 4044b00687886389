"""Weights made from the seed, on the card, in the type they are served in.

A reference module (``reference/<kind>.py``) lists the leaves of its
architecture with ``params(cfg)``: name, shape, type ("served" or
"float32") and how each is drawn.  ``make`` draws them all in a few large
calls of one ``torch.Generator`` on the device into flat buffers, one per
type and kind of draw, and hands out views, so the same seed gives the same
weights bit for bit.  ``load_into_port`` puts those tensors into the port's
model by name, without a copy; the reference draws them again from the
seed once the port's state is freed, so it takes nothing the program made.

Draws:
    ("normal", std)      N(0, std^2)
    ("norm",)            1 + N(0, 0.1^2): a norm's scale, not all ones, so
                         that a scale left out shows
    ("uniform", lo, hi)  U(lo, hi)
    ("a_log",)           log U(1, 16), Mamba-2's A = -exp(A_log)
    ("dt_bias",)         softplus^-1(dt) for dt log-uniform in [0.001, 0.1]
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

CHUNK = 1 << 28          # elements a generator call fills


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    dtype: str           # "served" or "float32"
    draw: tuple

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def weight_seed(seed: int) -> int:
    return seed % (1 << 64)


def prompt_seed(seed: int, index: int) -> int:
    """The generator seed of request ``index``'s prompts (a negative index:
    a warm-up prompt the window never sends), another stream than the
    weights': splitmix64 of the seed's stream advanced ``index`` times."""
    mask = (1 << 64) - 1
    z = (seed * 6364136223846793005 + 1442695040888963407
         + index * 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


def _kind(leaf: Leaf) -> str:
    return "normal" if leaf.draw[0] in ("normal", "norm") else "uniform"


def _fill(flat: torch.Tensor, kind: str, gen: torch.Generator) -> None:
    for i in range(0, flat.numel(), CHUNK):
        part = flat[i:i + CHUNK]
        if kind == "normal":
            part.normal_(generator=gen)
        else:
            part.uniform_(generator=gen)


def _finish(raw: torch.Tensor, draw: tuple) -> torch.Tensor:
    """Turn a view of standard draws into the leaf's values (float32 math
    for the uniform kinds; in place for the normal ones)."""
    what = draw[0]
    if what == "normal":
        return raw.mul_(draw[1])
    if what == "norm":
        return raw.mul_(0.1).add_(1.0)
    u = raw.float()
    if what == "uniform":
        return u * (draw[2] - draw[1]) + draw[1]
    if what == "a_log":
        return torch.log(1.0 + 15.0 * u)
    if what == "dt_bias":
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown draw {draw!r}")


def make(leaves: list[Leaf], seed: int, served: torch.dtype,
         device) -> dict[str, torch.Tensor]:
    """Every leaf, drawn from ``seed`` on ``device``: name -> tensor."""
    gen = torch.Generator(device=device)
    gen.manual_seed(weight_seed(seed))
    groups: dict[tuple, list[Leaf]] = {}
    for leaf in leaves:
        groups.setdefault((leaf.dtype, _kind(leaf)), []).append(leaf)
    out = {}
    for (dt_name, kind), members in sorted(groups.items()):
        dtype = served if dt_name == "served" else torch.float32
        raw_dtype = dtype if kind == "normal" else torch.float32
        flat = torch.empty(sum(m.numel for m in members), dtype=raw_dtype,
                           device=device)
        _fill(flat, kind, gen)
        at = 0
        for m in members:
            view = flat[at:at + m.numel].view(m.shape)
            at += m.numel
            out[m.name] = _finish(view, m.draw).to(dtype)
    return {leaf.name: out[leaf.name] for leaf in leaves}


def load_into_port(model: torch.nn.Module, weights: dict) -> None:
    """Put each tensor into the port's model (built on the meta device)
    under its name, as a parameter or a buffer as the model holds it.
    Every leaf of the model has to be named, with its shape and type."""
    import torch.nn as nn
    expected = dict(model.named_parameters())
    expected.update(dict(model.named_buffers()))
    missing = sorted(set(expected) - set(weights))
    extra = sorted(set(weights) - set(expected))
    if missing or extra:
        raise ValueError(f"weights do not match the port's model: missing "
                         f"{missing[:5]}, unknown {extra[:5]}")
    for name, t in weights.items():
        old = expected[name]
        if tuple(old.shape) != tuple(t.shape) or old.dtype != t.dtype:
            raise ValueError(f"{name}: the port holds {tuple(old.shape)} "
                             f"{old.dtype}, the benchmark made "
                             f"{tuple(t.shape)} {t.dtype}")
        prefix, _, leaf = name.rpartition(".")
        owner = model.get_submodule(prefix)
        if leaf in owner._parameters:
            owner._parameters[leaf] = nn.Parameter(t, requires_grad=False)
        else:
            owner._buffers[leaf] = t
