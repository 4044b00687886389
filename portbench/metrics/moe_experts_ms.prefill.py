"""moe_experts_ms.prefill: device ms a request in the operations whose
innermost port span is ``rt.moe.experts``, in the span slice (``spans.py``):
the experts' batched products and their SwiGLU
(``layers._moe_experts``)."""

from portbench import spans


def read(r):
    s = spans.of(r)
    return None if s is None else s.device_ms("rt.moe.experts")
