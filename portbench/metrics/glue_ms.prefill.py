"""glue_ms.prefill: device ms a traced request spends in kernels that are
neither matrix products of the libraries nor the port's own kernels (the
MoE dispatch's gathers, scatters and counts, the Mamba-2 layer's
elementwise chain, the norms), ``trace.kind_of``'s "glue"."""


def read(r):
    n = len(r.prefills())
    if not n or "glue" not in r.kernel_s:
        return None
    return 1e3 * r.kernel_s["glue"] / n
