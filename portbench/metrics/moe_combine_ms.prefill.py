"""moe_combine_ms.prefill: device ms a request in the operations whose
innermost port span is ``rt.moe.combine``, in the span slice (``spans.py``):
the MoE layer's gather of each token's k expert outputs, weighted and
added in order (``layers._moe_combine``)."""

from portbench import spans


def read(r):
    s = spans.of(r)
    return None if s is None else s.device_ms("rt.moe.combine")
