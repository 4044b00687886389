"""moe_kept_share: the share of the (token, expert) pairs the routers pick
that the experts' capacity keeps, in %, over the span slice's prefills
(``spans.py``; the port's counters ``moe.pairs_kept`` over
``moe.pairs_routed``).  The rest are dropped: they add nothing to their
tokens' outputs."""

from portbench import spans


def read(r):
    s = spans.of(r)
    if s is None or not s.counters.get("moe.pairs_routed"):
        return None
    return 100.0 * s.counters["moe.pairs_kept"] / \
        s.counters["moe.pairs_routed"]
