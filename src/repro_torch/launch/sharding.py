"""Sharding policy: logical-axis constraints and parameter specs.

Counterpart of ``repro/launch/sharding.py``, its tables copied entry for
entry.  A spec is a plain tuple, the ``PartitionSpec`` counterpart: one
element a dimension, each a mesh axis name, a tuple of them or None
(replicated), a 1-tuple normalised to the bare name as the reference
does.  Model code would call ``constrain(x, "batch", None, "model")``
with *logical* names, resolved under the active mesh as

    "batch" → every present data-parallel mesh axis ("pod", "data")
    "model" → the tensor-parallel mesh axis
    None    → replicated

dropping any axis that does not divide its dimension (the policy
degrades to replication).  ``spec_for_param`` gives every parameter leaf
its spec by name: column-parallel projections shard their output
features over "model", row-parallel ones their input features; MoE
experts shard over "model" (EP) when the expert count divides it, else
per-expert tensor-parallel; with ``cfg.fsdp`` big weights also shard one
replicated dimension over "data".

What a spec resolves to is the same as in the reference on any mesh
(``resolve_spec`` and ``spec_for_param`` take any object with
``axis_names`` and ``shape``).  Placing a tensor by a spec that splits it
needs a process group per card, the port's multi-device half (ROADMAP
A-11): until then ``constrain`` and ``with_sharding_constraint`` pass a
replicated tensor through and raise on one they would split, never
replicating it quietly.  On the one-card mesh every spec resolves to
replicated.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from ..models.transformer import lm_tree, ref_path

_ACTIVE: list = []          # stack of meshes activated for model code

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the ``jax.sharding.NamedSharding`` counterpart."""
    mesh: object
    spec: tuple


@contextmanager
def activate(mesh):
    """Enable sharding constraints for model code under this mesh."""
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_mesh():
    return _ACTIVE[-1] if _ACTIVE else None


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _resolve(elem, mesh):
    """Map a logical spec element to mesh axes present in ``mesh``."""
    if elem is None:
        return None
    if elem == "batch":
        present = tuple(a for a in BATCH_AXES
                        if a in mesh.axis_names and mesh.shape[a] > 1)
        return present if present else None
    if isinstance(elem, tuple):
        present = tuple(a for a in elem
                        if a in mesh.axis_names and mesh.shape[a] > 1)
        return present if present else None
    return elem if (elem in mesh.axis_names and mesh.shape[elem] > 1) else None


def resolve_spec(spec, shape, mesh) -> tuple:
    """Logical spec → resolved spec with divisibility fallback."""
    if len(spec) < len(shape):
        spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
    elems = []
    for dim, elem in zip(shape, spec):
        r = _resolve(elem, mesh)
        if r is not None and dim % _axis_size(mesh, r) != 0:
            r = None
        if isinstance(r, tuple) and len(r) == 1:
            r = r[0]        # a 1-tuple as the bare axis name
        elems.append(r)
    return tuple(elems)


def with_sharding_constraint(x: torch.Tensor,
                             sharding: NamedSharding) -> torch.Tensor:
    """``x`` itself when ``sharding`` replicates it; a sharding that would
    split it raises NotImplementedError (ROADMAP A-11)."""
    if any(e is not None for e in sharding.spec):
        raise NotImplementedError(
            f"sharding {sharding.spec} over mesh axes "
            f"{dict(sharding.mesh.shape)} splits a tensor of shape "
            f"{tuple(x.shape)}: placement over several cards is the port's "
            "multi-device half, ROADMAP A-11")
    return x


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """``x`` itself outside a mesh or when ``spec`` resolves to replicated
    under the active one; raises where it would shard (ROADMAP A-11)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return with_sharding_constraint(
        x, NamedSharding(mesh, resolve_spec(spec, x.shape, mesh)))


# --------------------------------------------------------------------------
# parameter partitioning policy
# --------------------------------------------------------------------------

# base (right-aligned) logical specs per parameter leaf name
_COL = (None, "model")        # output features sharded
_ROW = ("model", None)        # input features sharded
_PARAM_SPECS: dict[str, tuple] = {
    # attention
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # MLA
    "wdq": _COL, "wuq": _COL, "wdkv": (None, None), "wkr": (None, None),
    "wuk": _COL, "wuv": _COL,
    "q_norm": (None,), "kv_norm": (None,),
    # MLP
    "w1": _COL, "w3": _COL, "w2": _ROW,
    "b1": ("model",), "b2": (None,),
    # embeddings / head
    "embed": ("model", None), "lm_head": (None, "model"),
    "patch_proj": (None, None),
    # router / norms / scalars
    "router": (None, None),
    "scale": (None,), "bias": (None,),
    # SSM
    "in_proj": _COL, "out_proj": _ROW,
    "conv_w": (None, None), "conv_b": (None,),
    "A_log": (None,), "D": (None,), "dt_bias": (None,),
    "ssm_norm": (None,),
}

# MoE expert tensors: (E, D, F) / (E, F, D)
_MOE_SPECS = {
    "w1": ("model", None, None), "w3": ("model", None, None),
    "w2": ("model", None, None),
}
_MOE_TP_SPECS = {   # when E doesn't divide the model axis: per-expert TP
    "w1": (None, None, "model"), "w3": (None, None, "model"),
    "w2": (None, "model", None),
}

_FSDP_LEAVES = {"w1", "w2", "w3", "wq", "wk", "wv", "wo", "embed", "lm_head",
                "in_proj", "out_proj", "wuq", "wuk", "wuv"}


def _in_experts(path: tuple) -> bool:
    return any(key in ("experts", "moe") for key in path)


def spec_for_param(path: tuple, shape, cfg, mesh) -> tuple:
    """The spec of the parameter leaf at ``path`` (the reference's pytree
    path as a tuple of key names, e.g. ("layers", "attn", "wq")) of
    ``shape`` (layers stacked on leading axes, as in the reference)."""
    name = path[-1]
    if _in_experts(path):
        model_size = mesh.shape.get(MODEL_AXIS, 1)
        table = (_MOE_SPECS if cfg.n_experts % max(model_size, 1) == 0
                 else _MOE_TP_SPECS)
        base = table.get(name, (None,) * len(shape))
    else:
        base = _PARAM_SPECS.get(name, (None,) * len(shape))

    if len(base) < len(shape):
        base = (None,) * (len(shape) - len(base)) + tuple(base)

    # FSDP: shard one replicated dim of big weights over 'data'
    if getattr(cfg, "fsdp", False) and name in _FSDP_LEAVES:
        data_size = mesh.shape.get("data", 1)
        base = list(base)
        for i in range(len(base) - 1, -1, -1):
            if base[i] is None and shape[i] % max(data_size, 1) == 0 \
                    and shape[i] >= data_size and data_size > 1:
                base[i] = "data"
                break
        base = tuple(base)
    return resolve_spec(base, shape, mesh)


def param_shardings(params, cfg, mesh) -> dict:
    """By the port's parameter name (the MoE routers included, buffers while
    serving): the sharding of the reference's leaf the parameter belongs
    to, whose shape has the layers stacked on leading axes (``lm_tree``'s
    layout), so every layer's parameter carries its stack's spec.  Nothing
    is copied: the stacked shapes come from meta tensors."""
    leaves = params.state_dict(keep_vars=True)
    shapes = lm_tree(cfg, {n: torch.empty(t.shape, device="meta")
                           for n, t in leaves.items()})
    out, by_path = {}, {}
    for name in leaves:
        path = ref_path(cfg, name)
        if path not in by_path:
            node = shapes
            for key in path:
                node = node[key]
            by_path[path] = NamedSharding(
                mesh, spec_for_param(path, tuple(node.shape), cfg, mesh))
        out[name] = by_path[path]
    return out


# cache leaves: name → base logical spec (right-aligned)
_CACHE_SPECS = {
    "k": ("batch", None, "model", None),       # (B,W,K,hd): KV heads on model
    "v": ("batch", None, "model", None),
    "k_scale": ("batch", None, "model"),       # (B,W,K) int8-KV scales
    "v_scale": ("batch", None, "model"),
    "ckv": ("batch", None, None),              # (B,W,r)
    "krope": ("batch", None, None),
    "state": ("batch", "model", None, None),   # (B,H,P,N)
    "conv": ("batch", None, None),             # (B,kconv-1,convdim)
    "pos": (None,), "t": (), "enc": ("batch", None, None),
}

# sequence-parallel variant (cfg.seq_parallel_kv): the cache *window* dim is
# sharded over the model axis → decode attention reduces over a sharded axis
# with small partial-softmax combines instead of full-cache all-gathers
_CACHE_SPECS_SEQPAR = {
    "k": ("batch", "model", None, None),
    "v": ("batch", "model", None, None),
    "ckv": ("batch", "model", None),
    "krope": ("batch", "model", None),
    "k_scale": ("batch", "model", None),
    "v_scale": ("batch", "model", None),
    "pos": ("model",),
}


def cache_shardings(cache: dict, cfg, mesh) -> dict:
    """By cache key: each leaf's sharding (the step counter ``t``, a Python
    int, as a 0-d leaf)."""
    seqpar = getattr(cfg, "seq_parallel_kv", False)
    out = {}
    for name, leaf in cache.items():
        shape = tuple(getattr(leaf, "shape", ()))
        base = _CACHE_SPECS_SEQPAR.get(name) if seqpar else None
        if base is None:
            base = _CACHE_SPECS.get(name, (None,) * len(shape))
        out[name] = NamedSharding(mesh, resolve_spec(base, shape, mesh))
    return out


def data_sharding(shape, mesh, batch_dim: int = 0) -> NamedSharding:
    spec = [None] * len(shape)
    spec[batch_dim] = "batch"
    return NamedSharding(mesh, resolve_spec(tuple(spec), shape, mesh))
