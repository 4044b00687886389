"""decode_attn_roofline: the decode-attention kernel's share of its roofline
in the traced decode steps, in %: the least time each step's attention
over the cache's valid positions needs (``work.decode_attention``, one
call an attention layer) over the device time of the kernels named as the
port's decode-attention kernel."""

from portbench import work


def read(r):
    sec = r.kernel_s.get("decode_attention", 0.0)
    cfg = r.cfg
    n_attn = work.attention_layers(cfg)
    if sec <= 0.0 or not n_attn or not r.decodes():
        return None
    need = sum(n_attn * work.bound_s(*work.decode_attention(
        b, n, cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]))
        for b, n in r.decodes())
    return 100.0 * need / sec
