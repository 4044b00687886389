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
``axis_names`` and ``shape``).  On a mesh over a process group
(``mesh.make_process_mesh``) a spec places a tensor as a DTensor
(``torch.distributed.tensor``), whose sharding propagation stands in for
GSPMD's: each mesh axis named in element ``d`` of the spec becomes
``Shard(d)`` on that mesh dimension, every other mesh dimension
``Replicate()``, and a tuple element shards one dimension over several
mesh dimensions in their order.  ``constrain`` and
``with_sharding_constraint`` make a plain tensor a replicated DTensor
first and ``redistribute`` a DTensor; ``place_params`` and
``place_cache`` place a model's parameters and a KV cache by their
shardings.  A product whose contraction is split leaves partial sums,
which ``reduce_partial`` adds up at once, as GSPMD does (the models'
``dense``).  On the one-card mesh (no process group) every spec resolves
to replicated and the tensor passes through itself; a spec that would
split a tensor on a mesh without a process group raises, never
replicating it quietly.
"""

from __future__ import annotations

import math
import sys
from contextlib import contextmanager
from dataclasses import dataclass

import torch


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
    """Enable sharding constraints for model code under this mesh.  On a
    mesh over a process group a plain tensor met by a DTensor counts as
    replicated (``implicit_replication``), as an unannotated value is
    under GSPMD: positions, masks and constants need no placing."""
    _ACTIVE.append(mesh)
    try:
        if getattr(mesh, "device_mesh", None) is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
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


def placements(spec, mesh, ndim: int | None = None) -> list:
    """DTensor placements of a resolved ``spec`` on ``mesh``, one per mesh
    dimension; a spec longer than ``ndim`` (a stacked leaf's, for one
    layer's tensor) keeps its last ``ndim`` elements."""
    from torch.distributed.tensor import Replicate, Shard
    spec = tuple(spec)
    if ndim is not None and len(spec) > ndim:
        spec = spec[len(spec) - ndim:]
    out = [Replicate()] * len(mesh.axis_names)
    for dim, elem in enumerate(spec):
        if elem is None:
            continue
        for axis in (elem if isinstance(elem, tuple) else (elem,)):
            out[mesh.axis_names.index(axis)] = Shard(dim)
    return out


def is_distributed(x) -> bool:
    """Whether ``x`` is a DTensor (none exists before
    ``torch.distributed.tensor`` is imported, so a one-card run never
    imports it)."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(x, dtensor.DTensor)


def as_dtensor(x: torch.Tensor, mesh):
    """``x`` as a DTensor on ``mesh``'s DeviceMesh: itself if it is one,
    else the same values on every rank (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh.device_mesh,
                              [Replicate()] * len(mesh.axis_names),
                              run_check=False)


def with_sharding_constraint(x: torch.Tensor,
                             sharding: NamedSharding) -> torch.Tensor:
    """``x`` placed by ``sharding`` (a DTensor, redistributed) on a mesh
    over a process group; ``x`` itself on a mesh without one when the
    spec replicates it, and NotImplementedError when it would split it."""
    mesh = sharding.mesh
    if getattr(mesh, "device_mesh", None) is None:
        if any(e is not None for e in sharding.spec):
            raise NotImplementedError(
                f"sharding {sharding.spec} over mesh axes "
                f"{dict(mesh.shape)} splits a tensor of shape "
                f"{tuple(x.shape)}, and the mesh has no process group to "
                "place it on (build it with mesh.make_process_mesh)")
        return x
    return as_dtensor(x, mesh).redistribute(
        mesh.device_mesh, placements(sharding.spec, mesh, x.dim()))


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """``x`` outside a mesh; under the active mesh, ``x`` placed by the
    logical ``spec`` (``with_sharding_constraint``)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return with_sharding_constraint(
        x, NamedSharding(mesh, resolve_spec(spec, x.shape, mesh)))


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums (``Partial`` placements, what a product
    sharded on its contraction leaves) added up now (``Replicate()``, an
    all-reduce on each such mesh dimension); any other tensor itself.
    DTensor otherwise carries the sums on through the ops that follow
    (a residual add, a norm's square) and may then gather a weight rather
    than reduce an activation, so that the next product runs unsplit on
    every rank of "model"; GSPMD adds them where the product is made."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    place = [Replicate() if isinstance(p, Partial) else p
             for p in x.placements]
    if place == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, place)


def local_call(fn, args: tuple, specs: tuple, out_specs):
    """``fn(*args)`` on each rank's local shards, for code that must see
    plain tensors (the kernels, which launch on raw pointers, and the
    explicit-collective MoE): under a mesh over a process group, each
    DTensor argument is redistributed to its resolved spec in ``specs``
    (None: left as it is, a plain tensor) and taken ``to_local``; each
    output (``out_specs``: one spec, or a tuple of them for a tuple of
    outputs) comes back ``DTensor.from_local`` with its spec.  Both moves
    are differentiable: along a mesh axis that splits any argument, the
    gradient of an argument held whole is each rank's part (Partial).
    Outside such a mesh, or with no DTensor among ``args``, ``fn(*args)``
    as it is."""
    mesh = active_mesh()
    if getattr(mesh, "device_mesh", None) is None or not any(
            map(is_distributed, args)):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dm = mesh.device_mesh
    # a mesh axis that splits any argument splits the work: along it, the
    # gradient of an argument each rank holds whole is each rank's part
    split = {a for spec in specs if spec is not None
             for e in spec if e is not None
             for a in (e if isinstance(e, tuple) else (e,))}
    local = []
    for a, spec in zip(args, specs):
        if isinstance(a, torch.Tensor) and spec is not None:
            place = placements(spec, mesh, a.dim())
            grad = [p if isinstance(p, Shard) else
                    Partial() if axis in split else Replicate()
                    for p, axis in zip(place, mesh.axis_names)]
            a = as_dtensor(a, mesh).redistribute(dm, place).to_local(
                grad_placements=grad)
        local.append(a)
    out = fn(*local)
    many = isinstance(out, tuple)
    outs, out_specs = (out, out_specs) if many else ((out,), (out_specs,))
    wrapped = tuple(DTensor.from_local(o, dm, placements(s, mesh, o.dim()),
                                       run_check=False)
                    for o, s in zip(outs, out_specs))
    return wrapped if many else wrapped[0]


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``; on a placed table, GSPMD's lookup of
    a vocab-parallel table: each "model" rank looks up the tokens in its
    rows of the table (zeros for the others' tokens) and the output is
    the sum over "model" (Partial), the tokens split by batch."""
    import torch.nn.functional as F
    if not is_distributed(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = active_mesh()
    dm = mesh.device_mesh
    bat, mod = split_elems(mesh, tokens.shape[0])
    if mod is not None and table.shape[0] % mesh.shape[mod]:
        mod = None
    names = mesh.axis_names
    local_table = table.redistribute(dm, placements((mod, None), mesh)) \
        .to_local(grad_placements=[
            Shard(0) if a == mod else Partial() for a in names])
    tok = as_dtensor(tokens, mesh).redistribute(
        dm, placements((bat,) + (None,) * (tokens.dim() - 1), mesh)) \
        .to_local()
    rows = local_table.shape[0]
    if mod is not None:
        tok = tok - dm.get_local_rank(mod) * rows
    keep = (tok >= 0) & (tok < rows)
    out = F.embedding(torch.where(keep, tok, 0), local_table) \
        * keep[..., None].to(local_table.dtype)
    bat_axes = () if bat is None else (bat if isinstance(bat, tuple)
                                       else (bat,))
    return DTensor.from_local(
        out, dm, [Shard(0) if a in bat_axes else
                  Partial() if a == mod else Replicate() for a in names],
        run_check=False)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, aliasing its storage (a write lands in the
    DTensor); a plain tensor itself."""
    return t.to_local() if is_distributed(t) else t


def write_cache(cache: dict, name: str, index, x: torch.Tensor,
                at=None) -> None:
    """``cache[name][index] = x`` in place, or ``cache[name][index][at] =
    x`` with ``at``.  ``index`` is an int or a tuple of ints on the
    entry's leading (layer) axes, never split; ``x`` spans the entry's
    other dimensions.  Under a mesh each rank writes its shard of ``x``
    (a plain ``x`` taken as replicated) into its shard of the entry: a
    DTensor has no ``index_put_`` (torch 2.11), so every cache write of
    the models goes through the local tensors here, as the steps write
    them on one card."""
    ref = cache[name]
    dst = local_tensor(ref)[index]
    if is_distributed(ref):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        dm = ref.device_mesh
        lead = len(index) if isinstance(index, tuple) else 1
        place = [Shard(p.dim - lead) if isinstance(p, Shard) else Replicate()
                 for p in ref.placements]
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                                   run_check=False)
        x = x.redistribute(dm, place).to_local()
    if at is None:
        dst.copy_(x)
    else:
        dst[at] = x


def _whole_where_uneven(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """DTensor ``x`` with dimension ``dim`` gathered (``Replicate()``) on
    the mesh dimensions that shard it, where together they do not divide
    ``n``; its other placements kept.  ``x`` itself where they divide
    ``n`` or nothing shards ``dim``: no collective."""
    from torch.distributed.tensor import Replicate, Shard
    place = list(x.placements)
    on = [i for i, p in enumerate(place)
          if isinstance(p, Shard) and p.dim == dim]
    if not on or n % math.prod(x.device_mesh.size(i) for i in on) == 0:
        return x
    for i in on:
        place[i] = Replicate()
    return x.redistribute(x.device_mesh, place)


def split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """``x.reshape(*x.shape[:-1], n, d)``: a projection's last dimension
    split into ``n`` heads of ``d``.  DTensor cannot unflatten a dimension
    sharded over mesh axes that do not divide ``n`` (XLA's partitioner
    can), so under a mesh over a process group that dimension is gathered
    first; where the axes divide ``n`` the heads come out sharded over
    them, as the reshape gives them, and nothing moves."""
    if is_distributed(x):
        x = _whole_where_uneven(x, x.dim() - 1, n)
    return x.reshape(*x.shape[:-1], n, d)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., n, d) as (..., n·d), the inverse of ``split_heads``.
    On a DTensor the gradient of the merge is a split of heads, so it
    passes through ``split_heads``' rule (a gradient sharded over axes
    that do not divide ``n`` is gathered before it is unflattened); the
    heads are gathered first where axes that do not divide ``n`` shard
    them."""
    n, d = x.shape[-2:]
    if not is_distributed(x):
        return x.reshape(*x.shape[:-2], n * d)
    y = _whole_where_uneven(x, x.dim() - 2, n).reshape(*x.shape[:-2], n * d)
    if y.requires_grad:
        y.register_hook(lambda g: _whole_where_uneven(g, g.dim() - 1, n))
    return y


def sum_of_squares(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t``'s squared elements (``vdot`` of it flattened); of a
    DTensor, each rank's ``vdot`` of its shard summed over the shards, a
    replicated 0-d DTensor (a DTensor split on an inner dimension cannot
    be flattened in place)."""
    if not is_distributed(t):
        flat = t.reshape(-1)
        return torch.vdot(flat, flat)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    local = t.to_local().reshape(-1)
    part = DTensor.from_local(torch.vdot(local, local), t.device_mesh,
                              [Partial() if isinstance(p, Shard) else p
                               for p in t.placements], run_check=False)
    return part.redistribute(t.device_mesh,
                             [Replicate()] * t.device_mesh.ndim)


def split_elems(mesh, batch: int, *groups: int) -> tuple:
    """The resolved (batch element, model element) that a kernel's local
    call splits by: the data-parallel axes when they divide ``batch``, and
    "model" when it divides every count in ``groups`` (the heads and the
    KV heads or groups that must split alike), else None for that axis."""
    if getattr(mesh, "device_mesh", None) is None:
        return None, None
    bat = _resolve("batch", mesh)
    if bat is not None and batch % _axis_size(mesh, bat):
        bat = None
    if isinstance(bat, tuple) and len(bat) == 1:
        bat = bat[0]
    mod = _resolve(MODEL_AXIS, mesh)
    if mod is not None and any(g % mesh.shape[mod] for g in groups):
        mod = None
    return bat, mod


def place(x: torch.Tensor, sharding: NamedSharding):
    """A tensor that every rank holds in full, placed by ``sharding``
    (each rank keeps a copy of its own shard, on the mesh's device: no
    data moves between ranks)."""
    mesh = sharding.mesh
    if getattr(mesh, "device_mesh", None) is None:
        return with_sharding_constraint(x, sharding)
    return _own_chunk(x, mesh.device_mesh,
                      placements(sharding.spec, mesh, x.dim()))


def place_as(x: torch.Tensor, like) -> torch.Tensor:
    """A tensor that every rank holds in full, placed as the DTensor
    ``like`` is (its mesh and placements; each rank keeps its own chunk,
    no data moves).  ``x`` itself where ``like`` is a plain tensor."""
    if not is_distributed(like):
        return x
    return _own_chunk(x, like.device_mesh, like.placements)


def _own_chunk(x: torch.Tensor, device_mesh, place):
    from torch.distributed.tensor import DTensor, distribute_tensor
    out = distribute_tensor(x, device_mesh, place, src_data_rank=None)
    local = out.to_local()
    if local.untyped_storage().nbytes() > local.nbytes:
        # a shard is a view of the whole tensor: copied, so that the whole
        # one is freed
        out = DTensor.from_local(local.clone(), out.device_mesh,
                                 out.placements, run_check=False,
                                 shape=out.shape, stride=out.stride())
    return out


def place_params(params: torch.nn.Module, shardings: dict):
    """Place every parameter and buffer of ``params`` (the MoE routers
    included) by ``shardings`` (``param_shardings``), in place; each
    layer's tensor takes its stacked leaf's spec without the layer axes.
    Returns ``params``."""
    for prefix, module in params.named_modules():
        for kind in ("_parameters", "_buffers"):
            table = getattr(module, kind)
            for name, t in list(table.items()):
                if t is None:
                    continue
                full = f"{prefix}.{name}" if prefix else name
                placed = place(t.detach(), shardings[full])
                if kind == "_parameters":
                    placed = torch.nn.Parameter(placed, t.requires_grad)
                table[name] = placed
    return params


def place_cache(cache: dict, shardings: dict) -> dict:
    """The KV cache's tensors placed by ``shardings`` (``cache_shardings``);
    the step counter ``t`` stays a Python int."""
    return {name: place(x, shardings[name]) if isinstance(x, torch.Tensor)
            else x for name, x in cache.items()}


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
    from ..models.transformer import lm_tree, ref_path
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
