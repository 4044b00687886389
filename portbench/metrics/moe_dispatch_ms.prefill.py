"""moe_dispatch_ms.prefill: device ms a request in the operations whose
innermost port span is ``rt.moe.dispatch``, in the span slice
(``spans.py``): the MoE layer's routing, the ranks within each expert and
the scatter into the expert buffers (``layers._moe_dispatch``)."""

from portbench import spans


def read(r):
    s = spans.of(r)
    return None if s is None else s.device_ms("rt.moe.dispatch")
