"""mfu.prefill: the model FLOPs of the traced prompts (``work.prefill_flops``:
each token's k experts, causal attention, logits at the last position)
over the traced slice's length at the card's bf16 peak, in %."""

from portbench import work


def read(r):
    if not r.prefills() or r.window_s <= 0.0:
        return None
    flops = sum(work.prefill_flops(r.cfg, b, s) for b, s in r.prefills())
    return 100.0 * flops / (r.window_s * work.PEAK_FLOPS)
