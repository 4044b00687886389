"""Embedding bag on the card: the wrapper of ``csrc/embedding_bag.cu``.

Replaces the TPU kernel ``repro/kernels/embedding_bag.py::embedding_bag``
(Pallas, scalar-prefetched row DMAs).  The CUDA kernel runs one thread
block per bag; each thread owns a two-column slice of D, walks the bag's
lookups in order with the sum in fp32 registers and writes the result once
in the table's type.  It is bound by memory (index, row and output bytes);
at the live serving path's shapes (n_bags <= 32, bag 8, D 64) by the
launch.  One launch per table, as the reference makes.

``embedding_bag_cuda.launches`` counts the launches, so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def check_inputs(indices: torch.Tensor, table: torch.Tensor,
                 weights: torch.Tensor | None) -> None:
    """Raise on anything the kernel does not take: int32 indices
    (n_bags, bag), a float32 or bfloat16 table (V, D), float32 weights of
    the indices' shape, all contiguous and on one device."""
    tensors = [indices, table] + ([] if weights is None else [weights])
    if any(t.device != table.device for t in tensors):
        raise ValueError("embedding_bag: indices, table and weights must be "
                         f"on one device, got {[str(t.device) for t in tensors]}")
    if indices.dtype != torch.int32:
        raise TypeError(f"embedding_bag: indices must be int32, got {indices.dtype}")
    if table.dtype not in _DTYPE_CODE:
        raise TypeError("embedding_bag: table must be float32 or bfloat16, "
                        f"got {table.dtype}")
    if indices.dim() != 2 or table.dim() != 2:
        raise ValueError("embedding_bag: indices must be (n_bags, bag) and "
                         f"table (V, D), got {tuple(indices.shape)} and "
                         f"{tuple(table.shape)}")
    if weights is not None:
        if weights.dtype != torch.float32:
            raise TypeError(f"embedding_bag: weights must be float32, got {weights.dtype}")
        if weights.shape != indices.shape:
            raise ValueError("embedding_bag: weights must have the indices' "
                             f"shape {tuple(indices.shape)}, got {tuple(weights.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("embedding_bag: inputs must be contiguous")
    if max(indices.numel(), table.shape[0], table.shape[1]) >= 2 ** 31:
        raise ValueError("embedding_bag: sizes must fit in int32")


def embedding_bag_cuda(indices: torch.Tensor, table: torch.Tensor,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (inputs already checked
    by ``check_inputs``, on a CUDA device).  Raises if the launch fails."""
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag_cuda needs CUDA tensors, got {table.device}")
    n_bags, bag = indices.shape
    d = table.shape[1]
    out = torch.empty((n_bags, d), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    fn = _build.function("embedding_bag", "embedding_bag_forward", _ARGTYPES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(indices.data_ptr(), table.data_ptr(),
                None if weights is None else weights.data_ptr(),
                out.data_ptr(), n_bags, bag, d, _DTYPE_CODE[table.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: cudaError_t {rc}")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
