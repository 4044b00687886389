"""launches.prefill: the device operations a request's prefill issues, in the
span slice (``spans.py``): kernels, copies and sets under the port's
``rt.prefill`` span, the counters' own (``rt.count``) left out.  A count,
not a time: the same program on the same lengths issues the same
operations, though CUPTI's trace can lose a few of its records (up to 27 of
56,176 in one slice of olmoe-1b-7b's prefills on an H100)."""

from portbench import spans


def read(r):
    s = spans.of(r)
    return None if s is None else s.ops("rt.prefill")
