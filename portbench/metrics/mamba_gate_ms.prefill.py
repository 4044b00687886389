"""mamba_gate_ms.prefill: device ms a request in the operations whose
innermost port span is ``rt.mamba.gate``, in the span slice (``spans.py``):
the Mamba-2 layer's D skip, its silu(z) gate and the gated rmsnorm."""

from portbench import spans


def read(r):
    s = spans.of(r)
    return None if s is None else s.device_ms("rt.mamba.gate")
