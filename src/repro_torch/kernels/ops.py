"""Public entry points of the port's kernels.

Each function checks its inputs once, then takes the kernel's plain
version for tensors on the CPU and launches the CUDA kernel for tensors on
a card; there is no fallback from one to the other.  Counterpart of
``repro/kernels/ops.py``.
"""

from __future__ import annotations

import torch

from .embedding_bag import check_inputs, embedding_bag_cuda
from .ref import embedding_bag_ref


def embedding_bag(indices: torch.Tensor, table: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """indices (n_bags, bag) int32; table (V, D) → (n_bags, D).

    Unlike the reference wrapper, the table is not padded to 128 lanes:
    the kernel reads D-wide rows directly.
    """
    check_inputs(indices, table, weights)
    if table.device.type == "cpu":
        return embedding_bag_ref(indices, table, weights)
    if table.device.type == "cuda":
        return embedding_bag_cuda(indices, table, weights)
    raise ValueError(f"embedding_bag runs on cpu or cuda, not {table.device}")
