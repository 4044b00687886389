"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(Pallas, a sequential grid over key blocks with the online-softmax state in
VMEM).  The CUDA kernel runs one thread block per (batch·head, 64-row query
tile); the block loops over 64-key tiles with the running (m, l, acc) in
registers, skips tiles wholly masked by the causal or window mask, and
masks the ragged last tile by index.  It reads q (B, S, H, D) and k/v
(B, T, KH, D) through their strides, so nothing is transposed, copied or
padded.  It is bound by operations; this first version computes with
scalar fp32 FMAs, not the tensor cores.

``flash_attention_cuda.launches`` counts the launches, so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 window: int) -> None:
    """Raise on anything the kernel does not take: q (B, S, H, D) and k, v
    (B, T, KH, D) of one type (float32 or bfloat16) on one device, H a
    multiple of KH, 1 <= D <= 128, the head dim contiguous, and every query
    row with at least one key its masks let it see.  (A row with none is
    ill-defined in the reference: its plain version averages every value,
    its Pallas kernel every padded block.)"""
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: q, k and v must be on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q must be (B, S, H, D) and k, v "
                         f"(B, T, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] == 0 \
            or h % k.shape[2] != 0:
        raise ValueError("flash_attention: k, v must be (B, T, KH, D) with "
                         f"H % KH == 0 for q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in [1, {MAX_HEAD_DIM}]")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k and v must "
                         "be contiguous (stride 1)")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    t = k.shape[1]
    if t == 0 or (window > 0 and s >= t + window):
        raise ValueError(f"flash_attention: with T {t}, window {window} some "
                         f"of the {s} query rows see no key")
    if max(b * h, s, t) >= 2 ** 31:
        raise ValueError("flash_attention: sizes must fit in int32")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int,
                         scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (inputs already checked
    by ``check_inputs``, on a CUDA device).  Returns a new contiguous
    (B, S, H, D) tensor.  Raises if the launch fails."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    b, s, h, d = q.shape
    if b * h > 65535:
        raise ValueError(f"flash_attention_cuda: B·H {b * h} > 65535")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "flash_attention_forward",
                         _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, k.shape[1], h, k.shape[2], d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                float(scale), int(causal), int(window), DTYPE_CODE[q.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {rc}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
