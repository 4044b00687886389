"""ssd_scan_roofline: the SSD-scan kernel's share of its roofline in the
traced prefills, in %: the least time the scans of the traced requests
need (``work.ssd_scan``, one call a Mamba-2 layer) over the device time of
the kernels named as the port's SSD-scan kernel."""

from portbench import work


def read(r):
    sec = r.kernel_s.get("ssd_scan", 0.0)
    cfg = r.cfg
    n = work.mamba_layers(cfg)
    if sec <= 0.0 or not n or not r.prefills():
        return None
    _, nh, p, g, st, _ = work.ssm_shape(cfg)
    chunk = cfg.get("ssm_chunk", 256)
    need = sum(n * work.bound_s(*work.ssd_scan(b, s, nh, p, g, st, chunk))
               for b, s in r.prefills())
    return 100.0 * need / sec
