"""Device meshes: the local one-card mesh and the production meshes.

Counterpart of ``repro/launch/mesh.py`` (``make_production_mesh`` :16,
``make_local_mesh`` :27).  A ``Mesh`` is a description, the
``jax.sharding.Mesh`` counterpart that ``launch.sharding`` reads: axis
names, the size of each axis (``shape``, a dict as jax's ``Mesh.shape``)
and the devices, one per point of the grid in row-major order.  No
process group is made here: placing tensors over several cards needs
``torch.distributed`` and comes with the multi-device half of the port
(ROADMAP A-11); on one card every sharding resolves to replicated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..device import resolve_device


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: dict
    devices: list


def _mesh(shape: tuple, axes: tuple, devices: list) -> Mesh:
    return Mesh(tuple(axes), dict(zip(axes, shape)), list(devices))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) ("data", "model") over 256 cards, or (2, 16, 16) ("pod",
    "data", "model") over 512; raises RuntimeError when this host has
    fewer CUDA devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have}: the port's "
            "multi-device half (a torch.distributed process group per card) "
            "is ROADMAP A-11")
    return _mesh(shape, axes, [torch.device("cuda", i) for i in range(n)])


def make_local_mesh(device=None) -> Mesh:
    """The 1 x 1 mesh with the production axis names, on the card (cuda:0)
    unless the caller passes ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return _mesh((1, 1), ("data", "model"), [dev])
