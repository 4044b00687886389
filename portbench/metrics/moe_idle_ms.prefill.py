"""moe_idle_ms.prefill: device idle ms a request inside the MoE layers'
device intervals (``rt.moe``: from each layer's first operation to its
last), in the span slice (``spans.py``): the time the card waits on the
host's issue, and on its syncs, within the layer."""

from portbench import spans


def read(r):
    s = spans.of(r)
    return None if s is None else s.idle_ms("rt.moe")
