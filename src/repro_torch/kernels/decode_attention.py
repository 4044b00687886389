"""Decode attention on the card: the wrapper of ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::
decode_attention`` (Pallas, a sequential grid over 512-slot cache blocks).
The CUDA kernels split the cache across thread blocks (flash-decoding, the
plan in ``split_plan``): each block reads the G query heads of one
(batch, KV head) once and streams its run of 64-slot tiles with an online
softmax.  Slots count iff ``pos >= 0``.  The cache layer is read in its
(B, T, KH, D) layout through its strides: nothing is copied or padded.  It
is bound by the cache's bytes.

The route is chosen by dtype, up front:

* bfloat16 (the serving type) goes to ``decode_attention_bf16``: one launch
  a call.  Tiles stream by 16-byte cp.async through a ring of 4; scores
  and P·V are mma.sync products for G >= 2 and two-lane dot products for
  G = 1; P is rounded to bf16 before P·V as the TPU kernel does.  The last
  block of each (batch, KV head) to finish combines the splits, found by an
  atomic counter in a buffer zeroed once per device (``_counters``), so the
  call needs no host sync and can be captured in a CUDA graph.  It reads
  D % 8 == 0 and 16-byte aligned bases and strides: the wrapper zero-pads
  q, k and v along D and copies a misaligned view
  (``flash_attention.tensor_core_view``), then slices the output back.
* float32 goes to ``decode_attention_f32``: fp32 FMAs, a split pass and a
  combine kernel.

The partial (m, l, acc) of every split goes to a ``torch.empty`` buffer
allocated per call.  ``decode_attention_cuda.launches`` counts the calls
that launch the kernels and ``decode_attention_cuda.launches_by_dtype``
splits them by input type, so a run can show that its path went through
them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import (DTYPE_CODE, MAX_HEAD_DIM,
                              check_tensor_core_inputs, padded,
                              tensor_core_view)

MAX_GROUP = 32
TILE = 64            # keys per tile; a split covers a multiple of it
MIN_TILES = 4        # tiles every block streams, where T has that many
MAX_SPLITS = 128     # the bf16 kernel's combine takes up to 4 splits a lane
# The C entry point of each input type.
ENTRY = {torch.bfloat16: "decode_attention_bf16",
         torch.float32: "decode_attention_f32"}
# Both take q, k, v, pos, out and partial; bf16 also the split counters.
_SIZES = ([ctypes.c_int] * 5 + [ctypes.c_longlong] * 8
          + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_ARGTYPES = {torch.bfloat16: [ctypes.c_void_p] * 7 + _SIZES,
             torch.float32: [ctypes.c_void_p] * 6 + _SIZES}
# The bf16 kernel's split counters: B·KH·ceil(G / 16) ints, at most this
# many (B·KH <= 65535, G <= 32).
_N_COUNTERS = 2 * 65536
_COUNTERS: dict[torch.device, torch.Tensor] = {}


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
    the 64-slot tile) for ``n_rows`` (batch, KV head) rows.

    The rule: at most one wave of blocks on ``n_sms`` SMs (n_sms // n_rows
    splits per row, at least 1 and at most MAX_SPLITS), and no split
    shorter than MIN_TILES tiles where T has that many, so every block
    keeps tiles in flight through its ring while it works (the card needs
    some 3.3 MB outstanding to stream at 3.35 TB/s; a 64-slot bf16 tile of
    K and V is 32 KB at D 128).  At qwen2.5-3b's step (8 rows, T 2048: 32
    tiles) that is 8 splits of 4 tiles, 64 blocks; at zamba2-2.7b's (128
    rows, T 2096: 33 tiles) one split of 33 tiles, 128 blocks."""
    n_tiles = -(-t // TILE)
    want = max(1, min(n_tiles // MIN_TILES, n_sms // n_rows, MAX_SPLITS))
    span = TILE * -(-n_tiles // want)
    return span, -(-t // span)


def _counters(device: torch.device) -> torch.Tensor:
    """The bf16 kernel's split counters on ``device``: zeroed once, on the
    first call (before any graph capture), and left at 0 by every launch."""
    buf = _COUNTERS.get(device)
    if buf is None:
        buf = _COUNTERS[device] = torch.zeros(_N_COUNTERS, dtype=torch.int32,
                                              device=device)
    return buf


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Launch the CUDA kernel(s) of q's type on the current stream (inputs
    already checked by ``check_inputs``, on a CUDA device).  Returns a new
    contiguous (B, 1, H, D) tensor.  A bf16 call with D not a multiple of 8
    runs on q, k and v zero-padded to the next one, a misaligned bf16 view
    (or pos) on a fresh copy (``tensor_core_view``).  Raises if the launch
    fails."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {q.device}")
    b, _, h, d = q.shape
    if q.dtype == torch.bfloat16:
        q, k, v = (tensor_core_view(t, padded(d)) for t in (q, k, v))
        pos = tensor_core_view(pos)
        if q.shape[-1] != d:
            return decode_attention_cuda(q, k, v, pos,
                                         scale=scale)[..., :d].contiguous()
    _, t, kh, _ = k.shape
    if b * kh > 65535:
        raise ValueError(f"decode_attention_cuda: B·KH {b * kh} > 65535")
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    span, n_splits = split_plan(b * kh, t, n_sms)
    partial = torch.empty(b * kh * n_splits * (h // kh) * (d + 2),
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _counters(q.device) if q.dtype == torch.bfloat16 else None
        _launch(q, k, v, pos, out, partial, counters, span=span,
                n_splits=n_splits, scale=scale, stream=stream)
    return out


def _launch(q, k, v, pos, out, partial, counters, *, span: int,
            n_splits: int, scale: float, stream: int) -> None:
    """Call the C entry point of q's type and count the launch."""
    b, _, h, d = q.shape
    _, t, kh, _ = k.shape
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), partial.data_ptr()]
    if q.dtype == torch.bfloat16:
        check_tensor_core_inputs(q, k, v, pos)
        head.append(counters.data_ptr())
    fn = _build.function("decode_attention", ENTRY[q.dtype],
                         _ARGTYPES[q.dtype])
    rc = fn(*head, b, t, kh, h // kh, d, q.stride(0), q.stride(2),
            *k.stride()[:3], *v.stride()[:3], float(scale), span, n_splits,
            stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError_t {rc}")
    decode_attention_cuda.launches += 1
    decode_attention_cuda.launches_by_dtype[
        str(q.dtype).removeprefix("torch.")] += 1


decode_attention_cuda.launches = 0
decode_attention_cuda.launches_by_dtype = {"bfloat16": 0, "float32": 0}
