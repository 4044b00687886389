"""Collectives of ranks that share one card, staged through host memory.

NCCL takes one rank a card, so ranks that share a card form a gloo group,
and gloo's functional collectives on CUDA tensors kill a rank where
DTensor needs them: ``scripts/probe_collectives.py`` on an H100 under
torch 2.11 found a segfault in ``all_gather_into_tensor`` through
``torch.ops._c10d_functional`` (fp32 and bf16), and so in every DTensor
redistribution that gathers (Shard to Replicate, Partial to Shard,
Shard(0) to Shard(1), a sharded matmul), while the functional
all-reduce, reduce-scatter and all-to-all and every c10d call ran.
``install`` registers, for CUDA tensors, each functional collective that
DTensor and the port's explicit collectives call as: copy the operand to
pinned host memory, run the same collective on it (gloo's CPU path),
wait, copy the result back to the operand's card.  Only the operands
move: every computation before and after stays on the card.  ``STAGED``
counts the staged calls by collective and ``STAGED_BYTES`` the bytes
copied, both ways.  ``launch.mesh.make_process_mesh`` installs it in a
gloo group on a card; NCCL groups never take it.
"""

from __future__ import annotations

from collections import Counter

import torch

STAGED: Counter = Counter()
STAGED_BYTES: Counter = Counter()
_LIB: list = []

# the functional collectives staged (each takes its tensor first)
_OPS = ("all_reduce", "all_reduce_", "all_gather_into_tensor",
        "reduce_scatter_tensor", "all_to_all_single", "broadcast",
        "broadcast_")


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _staged(name: str):
    op = getattr(torch.ops._c10d_functional, name)
    wait = torch.ops._c10d_functional.wait_tensor
    in_place = name.endswith("_")

    def run(x: torch.Tensor, *args):
        STAGED[name] += 1
        host = _to_host(x)
        out = wait(op(host, *args))
        STAGED_BYTES[name] += host.nbytes + out.nbytes
        if in_place:
            return x.copy_(out)
        return out.to(x.device)
    return run


def install() -> None:
    """Stage every functional collective on CUDA tensors through host
    memory, in this process, once."""
    if _LIB:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in _OPS:
        lib.impl(name, _staged(name), "CUDA")
    _LIB.append(lib)


def reset() -> None:
    STAGED.clear()
    STAGED_BYTES.clear()
