"""idle_share.decode: the share of the traced decode steps in which no
operation ran on the device, in %: one minus the union of their
intervals over the slice's length."""


def read(r):
    if not r.decodes() or r.window_s <= 0.0 or r.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
