"""flash_roofline: the flash-attention kernel's share of its roofline in the
traced prefills, in %: the least time the causal attention problems of the
traced requests need (``work.flash``, one call an attention layer) over the
device time of the kernels named as the port's flash kernel."""

from portbench import work


def read(r):
    sec = r.kernel_s.get("flash", 0.0)
    cfg = r.cfg
    n_attn = work.attention_layers(cfg)
    if sec <= 0.0 or not n_attn or not r.prefills():
        return None
    need = sum(n_attn * work.bound_s(*work.flash(
        b, s, cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"],
        cfg.get("sliding_window", 0))) for b, s in r.prefills())
    return 100.0 * need / sec
