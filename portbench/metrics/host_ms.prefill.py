"""host_ms.prefill: the host's time to issue one prefill, from the call of
the port's step to its return, before the argmax and the copy; the mean
over the window's requests outside the profiled slices (the profiler
slows the host).  Near the device's time for a request, the host paces
the prefill."""


def read(r):
    if not r.host_prefill_ms:
        return None
    return sum(r.host_prefill_ms) / len(r.host_prefill_ms)
