"""Plain PyTorch versions of the port's kernels.

Each function here computes what its kernel computes, in the same order of
operations, so the CUDA kernel can be held against it on the card and the
CPU path can use it.  Counterpart of ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch


def embedding_bag_ref(indices: torch.Tensor, table: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """indices (n_bags, bag) → (n_bags, D) sums of table rows.

    Lookups are added in order, j = 0 .. bag-1, from zero, in float32
    (product and sum rounded separately when weighted), and the sum is cast
    to the table's type once.  The JAX reference accumulates in the table's
    type, so the two agree bit for bit in float32 and differ by bf16
    rounding in bf16.
    """
    n_bags, bag = indices.shape
    rows = table.index_select(0, indices.reshape(-1).long())
    rows = rows.reshape(n_bags, bag, table.shape[1]).float()
    out = torch.zeros(n_bags, table.shape[1], dtype=torch.float32,
                      device=table.device)
    for j in range(bag):
        row = rows[:, j]
        out += row if weights is None else row * weights[:, j, None]
    return out.to(table.dtype)
