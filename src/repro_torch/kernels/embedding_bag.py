"""Embedding bag on the card: the wrapper of ``csrc/embedding_bag.cu``.

Replaces the TPU kernel ``repro/kernels/embedding_bag.py::embedding_bag``
(Pallas, scalar-prefetched row DMAs).  The CUDA kernel runs one thread
block per (bag, table); each thread owns a two-column slice of D, walks
the bag's lookups in order with the sum in fp32 registers and writes the
result once in the table's type.  One launch pools every table of a
model: tables stacked (T, V, D), indices (n_bags, T, bag) in the model's
own layout, output (n_bags, T·D).  The reference's single-table call is
the T = 1 case of the same launch.  It is bound by memory (index, row and
output bytes); at the live serving path's shapes (n_bags <= 32, T 8,
bag 8, D 64) by the launch, hence one for all tables.

``embedding_bag_cuda.launches`` counts the launches, so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
MAX_TABLES = 65535   # the kernel's grid takes at most this many tables


def check_inputs(indices: torch.Tensor, tables: torch.Tensor,
                 weights: torch.Tensor | None) -> None:
    """Raise on anything the kernel does not take: one table (V, D) with
    int32 indices (n_bags, bag), or T stacked tables (T, V, D) with int32
    indices (n_bags, T, bag); float32 or bfloat16 tables; float32 weights
    of the indices' shape; all contiguous and on one device."""
    tensors = [indices, tables] + ([] if weights is None else [weights])
    if any(t.device != tables.device for t in tensors):
        raise ValueError("embedding_bag: indices, table and weights must be "
                         f"on one device, got {[str(t.device) for t in tensors]}")
    if indices.dtype != torch.int32:
        raise TypeError(f"embedding_bag: indices must be int32, got {indices.dtype}")
    if tables.dtype not in _DTYPE_CODE:
        raise TypeError("embedding_bag: table must be float32 or bfloat16, "
                        f"got {tables.dtype}")
    if tables.dim() not in (2, 3) or indices.dim() != tables.dim():
        raise ValueError("embedding_bag: indices must be (n_bags, bag) and "
                         "table (V, D), or indices (n_bags, T, bag) and "
                         f"tables (T, V, D), got {tuple(indices.shape)} and "
                         f"{tuple(tables.shape)}")
    if tables.dim() == 3 and (indices.shape[1] != tables.shape[0]
                              or not 1 <= tables.shape[0] <= MAX_TABLES):
        raise ValueError(f"embedding_bag: {tables.shape[0]} tables (1 to "
                         f"{MAX_TABLES}) for indices of "
                         f"{indices.shape[1]} tables")
    if weights is not None:
        if weights.dtype != torch.float32:
            raise TypeError(f"embedding_bag: weights must be float32, got {weights.dtype}")
        if weights.shape != indices.shape:
            raise ValueError("embedding_bag: weights must have the indices' "
                             f"shape {tuple(indices.shape)}, got {tuple(weights.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("embedding_bag: inputs must be contiguous")
    if max(indices.numel(), tables.shape[-2], tables.shape[-1]) >= 2 ** 31:
        raise ValueError("embedding_bag: sizes must fit in int32")


def embedding_bag_cuda(indices: torch.Tensor, tables: torch.Tensor,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (inputs already checked
    by ``check_inputs``, on a CUDA device): (n_bags, D) for one table,
    (n_bags, T·D) for T stacked tables.  Raises if the launch fails."""
    if tables.device.type != "cuda":
        raise ValueError(f"embedding_bag_cuda needs CUDA tensors, got {tables.device}")
    stacked = tables.dim() == 3
    n_tables, vocab, d = tables.shape if stacked else (1, *tables.shape)
    n_bags, bag = indices.shape[0], indices.shape[-1]
    out = torch.empty((n_bags, n_tables * d), dtype=tables.dtype,
                      device=tables.device)
    if out.numel() == 0:
        return out
    fn = _build.function("embedding_bag", "embedding_bag_forward", _ARGTYPES)
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        rc = fn(indices.data_ptr(), tables.data_ptr(),
                None if weights is None else weights.data_ptr(),
                out.data_ptr(), n_bags, n_tables, bag, vocab, d,
                _DTYPE_CODE[tables.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: cudaError_t {rc}")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
