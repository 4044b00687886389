"""mamba_conv_ms.prefill: device ms a request in the operations whose
innermost port span is ``rt.mamba.conv``, in the span slice (``spans.py``):
the Mamba-2 layer's causal conv, a sum of K shifted products, and the silu
after it (``ssm._causal_conv``)."""

from portbench import spans


def read(r):
    s = spans.of(r)
    return None if s is None else s.device_ms("rt.mamba.conv")
