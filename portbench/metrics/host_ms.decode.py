"""host_ms.decode: the host's time to issue one decode step, from the call
of the port's step to its return, before the tokens are copied out;
the mean over the window's steps outside the profiled slice (the
profiler slows the host)."""


def read(r):
    if not r.host_issue_ms:
        return None
    return sum(r.host_issue_ms) / len(r.host_issue_ms)
