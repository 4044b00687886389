"""Gradients through the kernels on the training path.

The wrappers launch their kernels through ctypes into preallocated
outputs, so autograd sees no operation between a kernel's inputs and its
output: without help, a backward pass would stop at the output silently,
and everything upstream of attention or the scan would get its gradient
only through the residual stream.  Each ``torch.autograd.Function`` here
runs the kernel (``ops``) as the forward and, as the backward, the
gradient of the reference's own math for the op, recomputed from the
saved inputs.  The reference has no backward kernel: its training
differentiates that math (``attention_full``, ``ssd_chunked``) with XLA's
autodiff.  The math is passed in by the model (``models.layers``,
``models.ssm``), which owns it.  On the CPU the same Functions run, with
``ops`` taking the plain versions for the forward.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import ops


def _recomputed_grads(math: Callable, inputs, needs, grads) -> tuple:
    """The gradients of ``math(*inputs)``'s outputs, weighted by ``grads``
    (None for an output that gets none), with respect to the inputs whose
    ``needs`` is set; None for the others."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(need)
                  for x, need in zip(inputs, needs)]
        outs = math(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    wrt = [x for x in leaves if x.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs],
                                   wrt, [g for _, g in pairs],
                                   allow_unused=True))
    return tuple(next(got) if need else None for need in needs)


class FlashAttention(torch.autograd.Function):
    """Forward: ``ops.flash_attention``; backward: the gradient of
    ``math(q, k, v)``, the reference's masked attention for the same
    causal/window/scale."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float,
                math: Callable):
        ctx.save_for_backward(q, k, v)
        ctx.math = math
        ctx.set_materialize_grads(False)
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)

    @staticmethod
    def backward(ctx, grad_out):
        if grad_out is None:
            return (None,) * 7
        grads = _recomputed_grads(ctx.math, ctx.saved_tensors,
                                  ctx.needs_input_grad[:3], (grad_out,))
        return (*grads, None, None, None, None)


class SSDScan(torch.autograd.Function):
    """Forward: ``ops.ssd_scan`` (y and the final state); backward: the
    gradient of ``math(x, dt, a_log, b, c)`` with respect to y.  Training
    starts every sequence from a zero state and reads no final state, so
    no gradient may flow into it."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, math: Callable):
        ctx.save_for_backward(x, dt, a_log, b, c)
        ctx.math = math
        ctx.set_materialize_grads(False)
        return ops.ssd_scan(x, dt, a_log.float(), b, c)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        if grad_state is not None:
            raise RuntimeError("ssd_scan: a gradient flows into the final "
                               "state; training reads no final state")
        if grad_y is None:
            return (None,) * 6
        grads = _recomputed_grads(ctx.math, ctx.saved_tensors,
                                  ctx.needs_input_grad[:5], (grad_y, None))
        return (*grads, None)


def flash_attention(q, k, v, *, causal: bool, window: int, scale: float,
                    math: Callable) -> torch.Tensor:
    """``ops.flash_attention`` with ``math``'s gradient as its backward."""
    return FlashAttention.apply(q, k, v, causal, window, scale, math)


def ssd_scan(x, dt, a_log, b, c, *, math: Callable):
    """``ops.ssd_scan`` (``a_log`` cast to float32 for the kernel) with
    ``math``'s gradient as its backward; returns y and the final state."""
    return SSDScan.apply(x, dt, a_log, b, c, math)
