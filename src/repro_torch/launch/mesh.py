"""Device meshes: the local one-card mesh, meshes over a process group,
the production meshes, and a launcher of ranks.

Counterpart of ``repro/launch/mesh.py`` (``make_production_mesh`` :16,
``make_local_mesh`` :27).  A ``Mesh`` is the ``jax.sharding.Mesh``
counterpart that ``launch.sharding`` reads: axis names, the size of each
axis (``shape``, a dict as jax's ``Mesh.shape``), the devices, one per
point of the grid in row-major order, and, on a mesh over a
``torch.distributed`` group, the ``DeviceMesh`` that places tensors
(``device_mesh``; None on the one-card mesh, whose every sharding
resolves to replicated).

``make_process_mesh`` builds the mesh over the world of an initialised
group, this rank's device its own card where the world fits on the
cards, else ``cuda:0`` (ranks sharing one card), or the CPU when asked.
``run_ranks`` spawns N ranks (a ``file://`` rendezvous in a temporary
directory, NCCL for one rank a card, gloo where ranks share a card or
run on the CPU), runs a function on each and returns their results.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: dict
    devices: list
    device_mesh: object = None


def _mesh(shape: tuple, axes: tuple, devices: list,
          device_mesh=None) -> Mesh:
    return Mesh(tuple(axes), dict(zip(axes, shape)), list(devices),
                device_mesh)


def rank_device(world: int, rank: int, device=None) -> torch.device:
    """This rank's device: the CPU when ``device`` is "cpu", else its own
    card (``cuda:<rank>``) where the world fits on the cards, or ``cuda:0``
    for every rank where it does not."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if world <= torch.cuda.device_count():
        return torch.device("cuda", rank)
    return torch.device("cuda", 0)


def backend_for(world: int, device=None) -> str:
    """NCCL for one rank a card; gloo for ranks on the CPU or sharing a
    card (NCCL refuses two ranks of a communicator on one card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_process_mesh(shape: tuple = None, axes: tuple = ("data", "model"),
                      device=None) -> Mesh:
    """The mesh of ``shape`` (default: the whole world on "data") over the
    world of the initialised default process group, with a
    ``DeviceMesh`` of the same axis names and shape; ``devices`` lists
    each rank's device.  A gloo group on a card stages its collectives
    through host memory (``host_collectives``)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_process_mesh needs an initialised "
                           "torch.distributed process group (run_ranks)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    shape, axes = tuple(shape), tuple(axes)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {world}")
    dev = rank_device(world, dist.get_rank(), device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if dist.get_backend() == "gloo":
            from . import host_collectives
            host_collectives.install()
    dm = DeviceMesh(dev.type, torch.arange(world, device="cpu").reshape(shape),
                    mesh_dim_names=axes)
    return _mesh(shape, axes, [rank_device(world, r, device)
                               for r in range(world)], dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) ("data", "model") over 256 ranks, or (2, 16, 16) ("pod",
    "data", "model") over 512, one card each, over the initialised
    process group (``make_process_mesh``); raises RuntimeError when the
    world or this host's cards fall short."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    have = torch.cuda.device_count()
    if world != n or have < n:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {n} ranks on {n} cards, "
            f"have {world} rank(s) and {have} card(s)")
    return make_process_mesh(shape, axes)


def make_local_mesh(device=None) -> Mesh:
    """The 1 x 1 mesh with the production axis names, on the card (cuda:0)
    unless the caller passes ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return _mesh((1, 1), ("data", "model"), [dev])


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------


def _rank_main(rank: int, world: int, backend: str, root: str, fn,
               args: tuple) -> None:
    dist.init_process_group(backend, init_method=f"file://{root}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"result-{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, *args, device=None,
              timeout: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    process group (backend by ``backend_for``) and return their results in
    rank order.  ``fn`` must be importable (a module-level function); it
    builds its mesh with ``make_process_mesh``.  Raises if a rank fails,
    and TimeoutError, its ranks ended, after ``timeout`` seconds."""
    import torch.multiprocessing as mp
    backend = backend_for(world, device)
    with tempfile.TemporaryDirectory(prefix="ranks-") as root:
        ctx = mp.start_processes(_rank_main,
                                 args=(world, backend, root, fn, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} ran "
                                       f"past {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(5)
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(world):
            with open(os.path.join(root, f"result-{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
