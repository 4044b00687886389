"""Atomic, versioned checkpointing: an npz payload and a json manifest.

Counterpart of ``repro/serving/checkpoint.py`` (``save`` :26, ``latest_step``
:66, ``restore`` :74), with its files: ``step_%010d.npz`` holding the
leaves as ``leaf_0``, ``leaf_1``, ... and ``step_%010d.json``, written to
temporary names and renamed (atomic), keep-last-k retention, and an async
mode that writes from a background thread.  Used by both planes: the
training loop (``launch.train``: parameters, AdamW state and step) and
the serving control plane (``RibbonOptimizer.state_dict()``).

A state is a tree of dicts, lists, tuples and NamedTuples over leaves
(tensors, numpy arrays, Python scalars; ``None`` holds no leaf).  Leaves
go in jax's flatten order (dict keys sorted, sequences in order), so a
float32 checkpoint written by either package restores in the other.  A
bf16 tensor is written as the 2-byte ``|V2`` payload the reference writes
for a bf16 array; ``restore`` reads it back by the dtype of ``state_like``
(the reference hands it back as a void array, ROADMAP C-R33).

Under a mesh over a process group (a state whose leaves include DTensors)
the files are the same: ``save`` gathers each DTensor leaf whole on every
rank (``full_tensor``, a collective that every rank calls in the same
order), as the reference brings each sharded leaf to the host
(``np.asarray(jax.device_get(leaf))``), and rank 0 alone writes.
``restore`` first waits at a barrier, so that no rank reads before rank
0 has joined its writes (``launch.train`` joins its async writes before
it returns); then every rank reads the whole file and keeps, of each
leaf whose ``state_like`` is a DTensor, its own chunk, placed as that
DTensor is (no data moves).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import torch

from ..launch.sharding import is_distributed, place_as


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree) -> list:
    """The leaves of ``tree`` in jax's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _flatten(x)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _structure(tree) -> str:
    """The tree's form, ``*`` for a leaf (the manifest's ``treedef``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(x) for x in tree)
        if _is_namedtuple(tree):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _to_host(leaf) -> np.ndarray:
    """A copy of the leaf as numpy, taken now (the training loop updates
    its tensors in place); bf16 as its raw 2-byte payload."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.array(leaf)


def _to_like(arr: np.ndarray, like, where: str):
    """A tensor leaf comes back as a tensor of ``like``'s dtype on its
    device (a ``|V2`` payload read as bf16), placed as ``like`` where it
    is a DTensor; any other leaf as the numpy array, as the reference
    returns it."""
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if t.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf dtype {t.dtype} != expected "
                         f"{like.dtype} ({where})")
    return place_as(t.to(like.device), like)


def save(ckpt_dir, state, step: int, keep: int = 3,
         async_write: bool = False):
    """Write checkpoint ``step``.  The leaves are copied to the host before
    this returns.  Returns the final path, or the writing thread when
    ``async_write=True`` (join it to guarantee durability).  Under a mesh
    over a process group every rank must call it; each DTensor leaf is
    gathered whole, and rank 0 writes while every other rank writes
    nothing and returns None."""
    leaves = _flatten(state)
    writes = not any(map(is_distributed, leaves)) or \
        torch.distributed.get_rank() == 0
    host_leaves = []
    for leaf in leaves:
        if is_distributed(leaf):
            leaf = leaf.full_tensor()
        if writes:
            host_leaves.append(_to_host(leaf))
    if not writes:
        return None
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    treedef = _structure(state)

    def _write():
        path = ckpt_dir / f"step_{step:010d}.npz"
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, **{f"leaf_{i}": leaf
                         for i, leaf in enumerate(host_leaves)})
        manifest = {"step": step, "n_leaves": len(host_leaves),
                    "treedef": treedef}
        mtmp = path.with_suffix(".tmp.json")
        mtmp.write_text(json.dumps(manifest))
        tmp.rename(path)
        mtmp.rename(path.with_suffix(".json"))
        _retain(ckpt_dir, keep)
        return path

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    return _write()


def _checkpoints(ckpt_dir: Path) -> list[Path]:
    """Finished checkpoints, oldest first (a write in progress has a
    ``.tmp`` name)."""
    return sorted(p for p in ckpt_dir.glob("step_*.npz")
                  if not p.name.endswith(".tmp.npz"))


def _retain(ckpt_dir: Path, keep: int):
    for old in _checkpoints(ckpt_dir)[:-keep]:
        old.unlink(missing_ok=True)
        old.with_suffix(".json").unlink(missing_ok=True)


def latest_step(ckpt_dir) -> int | None:
    ckpts = _checkpoints(Path(ckpt_dir))
    if not ckpts:
        return None
    return int(ckpts[-1].stem.split("_")[1])


def restore(ckpt_dir, state_like, step: int | None = None):
    """Restore into the structure of ``state_like`` (shapes must match, and
    a tensor leaf's dtype; a DTensor leaf comes back placed as it is).
    Returns (state, step) or (None, None) when no checkpoint exists.
    Under a mesh over a process group every rank must call it, rank 0
    after joining its async writes."""
    leaves = _flatten(state_like)
    if any(map(is_distributed, leaves)):
        torch.distributed.barrier()
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    path = ckpt_dir / f"step_{step:010d}.npz"
    with np.load(path, allow_pickle=False) as payload:
        restored = [payload[f"leaf_{i}"] for i in range(len(leaves))]
    out = []
    for i, (got, want) in enumerate(zip(restored, leaves)):
        if tuple(got.shape) != tuple(np.shape(want)):
            raise ValueError(
                f"checkpoint leaf shape {got.shape} != expected "
                f"{tuple(np.shape(want))} — wrong state structure for step "
                f"{step}")
        out.append(_to_like(got, want, f"leaf {i} of step {step}"))
    return _unflatten(state_like, iter(out)), step
