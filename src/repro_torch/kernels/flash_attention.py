"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(Pallas, a sequential grid over key blocks with the online-softmax state in
VMEM).  The CUDA kernels run one thread block per (batch·head, 64-row query
tile); the block loops over 64-key tiles with the running (m, l, acc) in
registers, skips tiles wholly masked by the causal or window mask, and
masks the ragged last tile by index.  They read q (B, S, H, D) and k/v
(B, T, KH, D) through their strides, so nothing is transposed, copied or
padded to 128.  The work is bound by operations.

The route is chosen by dtype, up front:

* bfloat16 (the serving type) goes to ``flash_attention_bf16``, the
  tensor-core kernel: mma.sync.m16n8k16 products, K/V tiles by cp.async
  into a 2-stage ring, P rounded to bf16 before P·V as the TPU kernel does.
  It reads D % 8 == 0 and 16-byte aligned bases and strides: the wrapper
  zero-pads q, k and v along D to the next multiple of 8 (the padded
  products are exact zeros; the scale stays the original D's) and slices
  the output back, and copies a misaligned view into a fresh allocation
  (``tensor_core_view``), so it takes every input the reference takes.
* float32 goes to ``flash_attention_f32``, fp32 FMAs, so fp32 results stay
  within 1e-4 of the plain version (the tensor cores' TF32 would not).

``flash_attention_cuda.launches`` counts the launches and
``flash_attention_cuda.launches_by_dtype`` splits them by input type, so a
run can show that its bf16 path went through the tensor-core kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
# The C entry point of each input type: the tensor-core kernel for bf16,
# the fp32 FMA kernel for float32.
ENTRY = {torch.bfloat16: "flash_attention_bf16",
         torch.float32: "flash_attention_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


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


def tensor_core_view(t: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """``t`` as the bf16 tensor-core kernels read it: ``t`` itself when its
    base is 16-byte aligned, every stride but the last is a multiple of 8
    elements and its last dim is ``width`` (default: its own); else a fresh
    allocation, ``t`` zero-padded along its last dim to ``width`` or copied
    as it is (``torch.empty(...).copy_(t)``: ``.contiguous()`` would keep
    the misaligned base of a view that is already contiguous).  Works on
    any device; the tests hold the plain versions on its output."""
    width = t.shape[-1] if width is None else width
    if width != t.shape[-1]:
        out = t.new_zeros(*t.shape[:-1], width)
        out[..., :t.shape[-1]] = t
        return out
    if t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1]):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def padded(n: int) -> int:
    """The least multiple of 8 >= ``n``: a head dim, P or N as the bf16
    kernels take it."""
    return -(-n // 8) * 8


def check_tensor_core_inputs(*tensors: torch.Tensor) -> None:
    """Raise on a bf16 input the tensor-core kernels cannot take: a head dim
    (of the first tensor) that is not a multiple of 8, or a base address or
    a stride other than the last that is not 16-byte aligned (their loads
    are 16-byte copies: 8 bf16 values, or 4 entries of decode's int32 pos).
    Shared by flash and decode attention, whose wrappers pad and re-align
    their operands first (``tensor_core_view``), so this is the last guard
    before a launch."""
    d = tensors[0].shape[-1]
    if d % 8 != 0:
        raise ValueError(f"bf16 attention kernel: head dim {d} is not a "
                         "multiple of 8")
    for t in tensors:
        if t.data_ptr() % 16 != 0:
            raise ValueError("bf16 attention kernel: a base address is not "
                             "16-byte aligned")
        if any(st % 8 != 0 for st in t.stride()[:-1]):
            raise ValueError(f"bf16 attention kernel: strides {t.stride()} "
                             "are not multiples of 8 elements")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int,
                         scale: float) -> torch.Tensor:
    """Launch the CUDA kernel of q's type on the current stream (inputs
    already checked by ``check_inputs``, on a CUDA device).  Returns a new
    contiguous (B, S, H, D) tensor.  A bf16 call with D not a multiple of 8
    runs on q, k and v zero-padded to the next one, a misaligned bf16 view
    on a fresh copy (``tensor_core_view``).  Raises if the launch fails."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    b, s, h, d = q.shape
    if q.dtype == torch.bfloat16:
        q, k, v = (tensor_core_view(t, padded(d)) for t in (q, k, v))
        if q.shape[-1] != d:
            return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        scale=scale)[..., :d].contiguous()
    if b * h > 65535:
        raise ValueError(f"flash_attention_cuda: B·H {b * h} > 65535")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(q, k, v, out, causal=causal, window=window, scale=scale,
                stream=stream)
    return out


def _launch(q, k, v, out, *, causal: bool, window: int, scale: float,
            stream: int) -> None:
    """Call the C entry point of q's type and count the launch."""
    if q.dtype == torch.bfloat16:
        check_tensor_core_inputs(q, k, v)
    fn = _build.function("flash_attention", ENTRY[q.dtype], _ARGTYPES)
    b, s, h, d = q.shape
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, k.shape[1], h, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(causal), int(window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {rc}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_dtype[
        str(q.dtype).removeprefix("torch.")] += 1


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_dtype = {"bfloat16": 0, "float32": 0}
