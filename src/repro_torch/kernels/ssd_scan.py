"""The Mamba-2 SSD scan on the card: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan`` (Pallas, a
sequential grid over chunks with the (N, P) state in VMEM).  The CUDA
kernels run one thread block per (batch, head, tile of P); the block loops
over 64-row chunks with the fp32 state on chip, computes each chunk's
in-chunk term, carried-state term and state update as the TPU kernel does,
and writes the final state in (B, H, P, N).  They read x (B, L, H, P) and
b, c (B, L, G, N) through their strides (views into the conv output, as the
model passes them), map head h to group h // (H // G), and apply dt and
``-exp(a_log)`` themselves, so nothing is repeated, moved or pre-scaled.

The route is chosen by dtype, up front:

* bfloat16 (the serving type) goes to ``ssd_scan_bf16``, the tensor-core
  kernel: a block of 8 warps per 64 columns of P, the state in registers as
  mma.sync.m16n8k16 accumulators (each warp 16 rows of P and half of N),
  C·Bᵀ once per chunk, the chunks by cp.async into a 2-stage ring, the
  fp32 operands of the state products split into bf16 hi + lo.  It reads
  P and N multiples of 8 and 16-byte aligned bases and strides: the
  wrapper zero-pads x along P and b, c along N (the padded products are
  exact zeros, so y and the state keep their values), copies a misaligned
  view (``flash_attention.tensor_core_view``) and slices y and the final
  state back.
* float32 goes to ``ssd_scan_f32``, fp32 FMAs, so fp32 results stay within
  2e-5 of the plain version.

``ssd_scan_cuda.launches`` counts the launches and
``ssd_scan_cuda.launches_by_dtype`` splits them by input type, so a run can
show that its bf16 path went through the tensor-core kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import DTYPE_CODE, padded, tensor_core_view

CHUNK = 64           # the kernels' chunk length (rows)
MAX_STATE = 256      # largest N their shared memory takes
# The C entry point of each input type: the tensor-core kernel for bf16,
# the fp32 FMA kernel for float32.
ENTRY = {torch.bfloat16: "ssd_scan_bf16", torch.float32: "ssd_scan_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])


def check_inputs(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor) -> None:
    """Raise on anything the kernel does not take: x (B, L, H, P) and b, c
    (B, L, G, N) of one type (float32 or bfloat16), dt (B, L, H) and a_log
    (H,) float32, all on one device; L >= 1, H a multiple of G, N <= 256;
    the last dim of x, b and c contiguous and a_log contiguous."""
    if any(t.device != x.device for t in (dt, a_log, b, c)):
        raise ValueError("ssd_scan: x, dt, a_log, b and c must be on one "
                         f"device, got {x.device}, {dt.device}, "
                         f"{a_log.device}, {b.device}, {c.device}")
    if x.dtype not in DTYPE_CODE or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("ssd_scan: x, b and c must all be float32 or all "
                        f"bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError("ssd_scan: dt and a_log must be float32, got "
                        f"{dt.dtype}, {a_log.dtype}")
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError("ssd_scan: x must be (B, L, H, P) and b, c "
                         f"(B, L, G, N), got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bsz, slen, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if b.shape[:2] != (bsz, slen) or g == 0 or h % g != 0:
        raise ValueError("ssd_scan: b, c must be (B, L, G, N) with H % G == 0 "
                         f"for x {tuple(x.shape)}, got {tuple(b.shape)}")
    if dt.shape != (bsz, slen, h) or a_log.shape != (h,):
        raise ValueError(f"ssd_scan: dt must be ({bsz}, {slen}, {h}) and "
                         f"a_log ({h},), got {tuple(dt.shape)}, "
                         f"{tuple(a_log.shape)}")
    if slen == 0 or p == 0 or not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan: need L >= 1, P >= 1 and 1 <= N <= "
                         f"{MAX_STATE}, got L {slen}, P {p}, N {n}")
    if any(t.stride(3) != 1 for t in (x, b, c)) or not a_log.is_contiguous():
        raise ValueError("ssd_scan: the last dim of x, b and c must be "
                         "contiguous (stride 1), and a_log contiguous")
    if max(bsz, h, slen, p * n) >= 2 ** 31:
        raise ValueError("ssd_scan: sizes must fit in int32")


def check_tensor_core_inputs(x: torch.Tensor, b: torch.Tensor,
                             c: torch.Tensor) -> None:
    """Raise on a bf16 input the tensor-core kernel cannot take: P or N not
    a multiple of 8, or a base address or a stride other than the last of
    x, b, c that is not 16-byte aligned (its loads are 16-byte copies of 8
    bf16 values).  ``ssd_scan_cuda`` pads and re-aligns first, so this is
    the last guard before a launch."""
    p, n = x.shape[3], b.shape[3]
    if p % 8 != 0 or n % 8 != 0:
        raise ValueError(f"bf16 ssd_scan kernel: P {p} and N {n} must be "
                         "multiples of 8")
    for t in (x, b, c):
        if t.data_ptr() % 16 != 0:
            raise ValueError("bf16 ssd_scan kernel: a base address is not "
                             "16-byte aligned")
        if any(st % 8 != 0 for st in t.stride()[:3]):
            raise ValueError(f"bf16 ssd_scan kernel: strides {t.stride()} "
                             "are not multiples of 8 elements")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor):
    """Launch the CUDA kernel of x's type on the current stream (inputs
    already checked by ``check_inputs``, on a CUDA device).  Returns new
    contiguous y (B, L, H, P) in x's type and final state (B, H, P, N)
    float32.  A bf16 call with P or N not a multiple of 8 runs on x padded
    along P and b, c along N with zeros, a misaligned bf16 view on a fresh
    copy (``tensor_core_view``).  Raises if the launch fails."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {x.device}")
    bsz, slen, h, p = x.shape
    n = b.shape[3]
    if x.dtype == torch.bfloat16:
        x = tensor_core_view(x, padded(p))
        b, c = (tensor_core_view(t, padded(n)) for t in (b, c))
        if (x.shape[3], b.shape[3]) != (p, n):
            y, state = ssd_scan_cuda(x, dt, a_log, b, c)
            return (y[..., :p].contiguous(),
                    state[:, :, :p, :n].contiguous())
    if bsz > 65535 or h > 65535:
        raise ValueError(f"ssd_scan_cuda: B {bsz} or H {h} > 65535")
    y = torch.empty((bsz, slen, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch(x, dt, a_log, b, c, y, state, stream=stream)
    return y, state


def _launch(x, dt, a_log, b, c, y, state, *, stream: int) -> None:
    """Call the C entry point of x's type and count the launch."""
    if x.dtype == torch.bfloat16:
        check_tensor_core_inputs(x, b, c)
    fn = _build.function("ssd_scan", ENTRY[x.dtype], _ARGTYPES)
    bsz, slen, h, p = x.shape
    rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), state.data_ptr(),
            bsz, slen, h, p, b.shape[2], b.shape[3], *x.stride()[:3],
            *dt.stride(), *b.stride()[:3], *c.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError_t {rc}")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.launches_by_dtype[str(x.dtype).removeprefix("torch.")] += 1


ssd_scan_cuda.launches = 0
ssd_scan_cuda.launches_by_dtype = {"bfloat16": 0, "float32": 0}
