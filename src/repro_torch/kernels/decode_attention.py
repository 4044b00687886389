"""Decode attention on the card: the wrapper of ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::
decode_attention`` (Pallas, a sequential grid over 512-slot cache blocks).
The CUDA kernel splits the cache across thread blocks (flash-decoding):
each block reads the G query heads of one (batch, KV head) once, streams
its run of 64-slot tiles with an online softmax and writes a partial
(m, l, acc); a second kernel combines the partials, weighing each by
exp(m_split - m_max).  Slots count iff ``pos >= 0``.  The cache layer is
read in its (B, T, KH, D) layout through its strides: nothing is copied or
padded.  It is bound by the cache's bytes.

``decode_attention_cuda.launches`` counts the calls that launch the kernel
(one count per call, which launches the split pass and the combine), so a
run can show that its path went through it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import DTYPE_CODE, MAX_HEAD_DIM

MAX_GROUP = 32
TILE = 64            # keys per tile; a split covers a multiple of it
BLOCKS_PER_SM = 2    # splits are chosen to give about this many blocks per SM
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """Raise on anything the kernel does not take: q (B, 1, H, D) and k, v
    (B, T, KH, D) of one type (float32 or bfloat16), pos (T,) int32
    contiguous, all on one device; H = KH·G with G <= 32; 1 <= D <= 128;
    the head dim contiguous."""
    if any(t.device != q.device for t in (k, v, pos)):
        raise ValueError("decode_attention: q, k, v and pos must be on one "
                         f"device, got {q.device}, {k.device}, {v.device}, "
                         f"{pos.device}")
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k and v must all be float32 "
                        f"or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: pos must be int32, got {pos.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode_attention: q must be (B, 1, H, D) and k, v "
                         f"(B, T, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    _, t, kh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh != 0:
        raise ValueError("decode_attention: k, v must be (B, T, KH, D) with "
                         f"H % KH == 0 for q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)}")
    if pos.shape != (t,) or not pos.is_contiguous():
        raise ValueError(f"decode_attention: pos must be contiguous ({t},), "
                         f"got {tuple(pos.shape)}")
    if t == 0:
        raise ValueError("decode_attention: the cache has no slot")
    if h // kh > MAX_GROUP:
        raise ValueError(f"decode_attention: {h // kh} query heads per KV head "
                         f"> {MAX_GROUP}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {d} not in [1, {MAX_HEAD_DIM}]")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("decode_attention: the head dim of q, k and v must "
                         "be contiguous (stride 1)")
    if max(b * kh, t) >= 2 ** 31:
        raise ValueError("decode_attention: sizes must fit in int32")


def split_plan(n_rows: int, t: int, n_sms: int) -> tuple[int, int]:
    """(span, n_splits): split T slots into runs of ``span`` (a multiple of
    the 64-slot tile) so that ``n_rows`` (batch, KV head) rows give about
    BLOCKS_PER_SM blocks per SM."""
    n_tiles = -(-t // TILE)
    want = max(1, min(n_tiles, -(-BLOCKS_PER_SM * n_sms // n_rows)))
    span = TILE * -(-n_tiles // want)
    return span, -(-t // span)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Launch the CUDA kernels on the current stream (inputs already checked
    by ``check_inputs``, on a CUDA device).  Returns a new contiguous
    (B, 1, H, D) tensor.  Raises if the launch fails."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {q.device}")
    b, _, h, d = q.shape
    _, t, kh, _ = k.shape
    if b * kh > 65535:
        raise ValueError(f"decode_attention_cuda: B·KH {b * kh} > 65535")
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    span, n_splits = split_plan(b * kh, t, n_sms)
    group = h // kh
    partial = torch.empty(b * kh * n_splits * group * (d + 2),
                          dtype=torch.float32, device=q.device)
    fn = _build.function("decode_attention", "decode_attention_forward",
                         _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                out.data_ptr(), partial.data_ptr(),
                b, t, kh, group, d, q.stride(0), q.stride(2),
                *k.stride()[:3], *v.stride()[:3], float(scale), span,
                n_splits, DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError_t {rc}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
