"""Counting what the port runs: flops, HBM bytes and collectives of one call.

Counterpart of ``repro/roofline/hlo_walk.py``, which walks XLA's compiled
HLO and multiplies each loop body by its trip count.  In eager PyTorch
every aten op is its own kernel and the layer loops run in Python, so
``analyze(fn, *args, **kwargs)`` runs ``fn`` once under a
``TorchDispatchMode`` and adds up, over every aten op it dispatches:

* ``flops``: ``torch.utils.flop_counter``'s formulas, 2·M·N·K over every
  matrix product (the quantity of ``hlo_walk._dot_flops``), also by the
  type of the product's first operand (``flops_by_dtype``);
* ``hbm_bytes``: the op's input plus output bytes, views and ops that
  launch no kernel (``empty``, ``detach``, ...) left out: the counterpart
  of ``hlo_walk``'s top-level instruction bytes, since an eager op reads
  its inputs from and writes its outputs to device memory (an in-place op
  counts its target as read and written);
* collectives: operand bytes and wire bytes (``hlo_walk``'s ring
  coefficients) by kind for every functional c10d collective and
  DTensor's all-to-all, none on one card.

Pass meta tensors (``launch.specs``): nothing is allocated and nothing
runs on a device.  The port's kernels (``kernels.ops``) take a meta route
only inside a walk: each call is counted by its own formula, each input
read once and each output written once, and returns empty meta outputs
of the kernel's shapes (``kernel_call``).  Flash attention counts
4·D·B·H over the (query, key) pairs its masks let through (half of S·T
when causal), decode attention every slot of the cache (a walk sees no
positions), the SSD scan the products of its 64-row chunks, embedding_bag
each looked-up row (no products), the FCFS scans bytes only.  A walk
through ``use_kernel=False`` counts the plain math instead, (S, S) score
tensors included, which the kernels never write.  Outside a walk a kernel
on meta raises.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels.ssd_scan import CHUNK as SSD_CHUNK
from .analysis import COLLECTIVE_OPS

_WIRE_COEFF = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}
# functional c10d collectives (``torch.distributed._functional_collectives``)
# and DTensor's own all-to-all (a shard moved from one dimension to another
# on a mesh of cards), by op name
_C10D = {"_c10d_functional::all_reduce": "all-reduce",
         "_c10d_functional::all_gather_into_tensor": "all-gather",
         "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
         "_c10d_functional::all_to_all_single": "all-to-all",
         "_dtensor::shard_dim_alltoall": "all-to-all"}

# ops that launch no kernel: allocation, aliasing, metadata
_NO_KERNEL = {"aten::empty", "aten::empty_like", "aten::empty_strided",
              "aten::new_empty", "aten::new_empty_strided",
              "aten::_unsafe_view", "aten::detach", "aten::alias",
              "aten::lift_fresh", "aten::set_", "aten::resize_",
              "_c10d_functional::wait_tensor",
              "_c10d_functional::_wrap_tensor_autograd"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _handed_on(types) -> bool:
    """Whether an op on these tensor types is DTensor's to run (a DTensor
    among them; none exists before ``torch.distributed.tensor`` is
    imported)."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and any(issubclass(t, dtensor.DTensor)
                                       for t in types)


def _fake(types) -> bool:
    """Whether an op runs on fake tensors (DTensor's sharding propagation)."""
    fake = sys.modules.get("torch._subclasses.fake_tensor")
    return fake is not None and any(issubclass(t, fake.FakeTensor)
                                    for t in types)


@dataclass
class OpAccounting:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_operand_bytes: dict = field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_OPS, 0.0))
    collective_wire_bytes: float = 0.0
    collective_counts: dict = field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_OPS, 0.0))
    n_ops: int = 0
    flops_by_dtype: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_operand_bytes": dict(self.collective_operand_bytes),
            "collective_wire_bytes": self.collective_wire_bytes,
            "collective_counts": dict(self.collective_counts),
            "n_ops": self.n_ops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }

    def add(self, flops: float, nbytes: float, dtype) -> None:
        self.n_ops += 1
        self.hbm_bytes += nbytes
        if flops:
            self.flops += flops
            key = str(dtype).removeprefix("torch.")
            self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + flops


class OpWalk(TorchDispatchMode):
    """The dispatch mode of one walk; ``acc`` holds its counts."""

    def __init__(self):
        super().__init__()
        self.acc = OpAccounting()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _handed_on(types):
            return NotImplemented
        if _fake(types):
            return func(*args, **kwargs)
        packet = func.overloadpacket
        # as FlopCounterMode: an op without a formula that decomposes is
        # counted by its parts
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func._schema.name
        if func.is_view or name in _NO_KERNEL:
            return out
        ins = _tensors((args, kwargs))
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, _tensors(out)))
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        kind = _C10D.get(name)
        if kind is not None:
            operand = sum(_nbytes(t) for t in ins)
            wire = (sum(map(_nbytes, _tensors(out))) if kind == "all-gather"
                    else _WIRE_COEFF[kind] * operand)
            self.acc.collective_operand_bytes[kind] += operand
            self.acc.collective_counts[kind] += 1
            self.acc.collective_wire_bytes += wire
        self.acc.add(flops, nbytes, ins[0].dtype if ins else None)
        return out


def active() -> OpWalk | None:
    """The innermost walk in progress on this thread, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpWalk):
            return mode
    return None


def analyze(fn, *args, **kwargs) -> OpAccounting:
    """Run ``fn(*args, **kwargs)`` once under a walk and return its counts
    (pass meta tensors; see the module docstring)."""
    walk = OpWalk()
    with walk:
        fn(*args, **kwargs)
    return walk.acc


# --------------------------------------------------------------------------
# the port's kernels, each counted by its own formula
# --------------------------------------------------------------------------

def attention_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query i, key j) pairs of an S x T attention that its masks let
    through: j <= i when causal, i - j < window when windowed."""
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(s, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _flash_flops(q, k, v, *, causal: bool, window: int) -> int:
    b, s, h, d = q.shape
    return 4 * d * b * h * attention_pairs(s, k.shape[1], causal, window)


def _decode_flops(q, k, v, pos) -> int:
    b, _, h, d = q.shape
    return 4 * d * b * h * k.shape[1]


def ssd_flops(b: int, l: int, h: int, p: int, g: int, n: int) -> int:
    """The SSD scan's products over chunks of SSD_CHUNK rows: C·Bᵀ over the
    causal (i >= j) pairs once per group, (C·Bᵀ ∘ L)·xdt over those pairs
    and the carried state's two Q x N x P products per head."""
    full, rest = divmod(l, SSD_CHUNK)
    pairs = full * SSD_CHUNK * (SSD_CHUNK + 1) // 2 + rest * (rest + 1) // 2
    return b * g * 2 * pairs * n + b * h * (2 * pairs * p + 4 * l * n * p)


def _ssd_flops(x, dt, a_log, b, c) -> int:
    bb, l, h, p = x.shape
    return ssd_flops(bb, l, h, p, b.shape[2], b.shape[3])


_FLOPS = {"flash_attention": _flash_flops, "decode_attention": _decode_flops,
          "ssd_scan": _ssd_flops}


def _read_bytes(name: str, inputs: tuple) -> int:
    if name == "embedding_bag":
        indices, tables, *weights = inputs
        # the rows the indices name, one read each (a walk sees no indices)
        return (_nbytes(indices) + indices.numel() * tables.shape[-1]
                * tables.element_size() + sum(map(_nbytes, _tensors(weights))))
    return sum(map(_nbytes, _tensors(inputs)))


def kernel_call(name: str, inputs: tuple, outputs, **static) -> None:
    """Count one call of the port's kernel ``name`` in the walk in
    progress: its formula's flops, each input read and each output
    written once."""
    walk = active()
    if walk is None:
        raise ValueError(f"{name} runs on cpu or cuda, not meta (outside an "
                         "op walk)")
    flops = _FLOPS[name](*inputs, **static) if name in _FLOPS else 0
    nbytes = _read_bytes(name, inputs) + sum(map(_nbytes, _tensors(outputs)))
    walk.acc.add(flops, nbytes, inputs[0].dtype)
    rec = walk.acc.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                             "bytes": 0.0})
    rec["calls"] += 1
    rec["flops"] += flops
    rec["bytes"] += nbytes
