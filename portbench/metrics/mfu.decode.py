"""mfu.decode: the whole decode step's roofline share, in %: for each traced
step the larger of its FLOPs at the bf16 peak and its bytes at HBM's
(``work.decode_step``), summed, over the traced slice's length (the slice
holds decode steps only, so that is their total time)."""

from portbench import work


def read(r):
    if not r.decodes() or r.window_s <= 0.0:
        return None
    need = sum(work.bound_s(*work.decode_step(r.cfg, b, n))
               for b, n in r.decodes())
    return 100.0 * need / r.window_s
