"""Plain PyTorch versions of the port's kernels.

Each function here computes what its kernel computes, in the same order of
operations, so the CUDA kernel can be held against it on the card and the
CPU path can use it.  Counterpart of ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch

from .fcfs_scan import EDGE0_BITS, INF, N_BUCKETS, TIE


def embedding_bag_ref(indices: torch.Tensor, table: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """indices (n_bags, bag) and table (V, D) → (n_bags, D) sums of table
    rows; or indices (n_bags, T, bag) and T stacked tables (T, V, D) →
    (n_bags, T·D), table t pooled by ``indices[:, t]`` (one table is the
    T = 1 case).

    An index outside [0, V) is taken as the reference takes it: a
    negative one wraps once (i + V), then it is clamped to [0, V - 1].
    Lookups are added in order, j = 0 .. bag-1, from zero, in float32
    (product and sum rounded separately when weighted), and the sum is cast
    to the table's type once.  The JAX reference accumulates in the table's
    type, so the two agree bit for bit in float32 and differ by bf16
    rounding in bf16.
    """
    if table.dim() == 2:
        indices, table = indices[:, None], table[None]
        weights = None if weights is None else weights[:, None]
    n_bags, n_tables, bag = indices.shape
    vocab, d = table.shape[1:]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + vocab, idx).clamp(0, vocab - 1)
    first = torch.arange(n_tables, device=table.device)[:, None] * vocab
    rows = table.reshape(-1, d).index_select(0, (idx + first).reshape(-1))
    rows = rows.reshape(n_bags, n_tables, bag, d).float()
    out = torch.zeros(n_bags, n_tables, d, dtype=torch.float32,
                      device=table.device)
    for j in range(bag):
        row = rows[:, :, j]
        out += row if weights is None else row * weights[:, :, j, None]
    return out.reshape(n_bags, n_tables * d).to(table.dtype)


MASKED = -1e30   # the score of a masked entry, as in the reference


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, KH, D) → (B, S, H, D), query head h
    reading KV head h // (H // KH).

    The full (S, T) score matrix in float32 (from float32 copies of q and
    k, as the kernel computes), scaled, masked to -1e30 by the causal and
    window masks built from indices (query i sees key j iff j <= i when
    causal and i - j < window when window > 0), a float32 softmax, the
    probabilities cast to v's type and multiplied by v.  The reference's
    ``flash_attention_ref`` on the kernel's (B, S, H, D) layout instead of
    its collapsed (B·H, S, D).
    """
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, s, kh, h // kh, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    scores = torch.where(mask, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def per_head(x: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """Groups on axis ``dim`` broadcast onto ``heads`` heads, head h taking
    group h // (heads // G) (``jnp.repeat``'s order), through ``expand``:
    no host sync, so it can be captured in a CUDA graph."""
    shape = list(x.shape)
    shape.insert(dim + 1, heads // x.shape[dim])
    out = x.unsqueeze(dim + 1).expand(*shape)
    return out.reshape(*x.shape[:dim], heads, *x.shape[dim + 1:])


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor):
    """The Mamba-2 SSD scan, token by token: x (B, L, H, P), dt (B, L, H)
    float32 after softplus, a_log (H,), b and c (B, L, G, N), head h reading
    group h // (H // G) → y (B, L, H, P) in x's type and the final state
    (B, H, P, N) float32.

    The contract of the reference's ``ops.ssd_scan`` and the arithmetic of
    its sequential ``ref.ssd_scan_ref``: xdt = x · dt rounded to x's type
    (dt rounded first, as the reference wrapper does), then in float32

        state_t = exp(dt_t · A) · state_{t-1} + xdt_t ⊗ b_t,   A = -exp(a_log)
        y_t     = state_t · c_t

    and y cast once to x's type.  The kernel computes the same function in
    64-row chunks: the in-chunk decays exp(cum_i - cum_j) come from
    differences of a running sum (kept in float64), and it rounds
    (C·Bᵀ ∘ L) to x's type before the product with xdt.  In float32 the two
    differ by rounding only, about 1e-5 x max |y| at mamba2-130m's prefill
    shape; in bfloat16 the kernel's extra rounding of the score matrix adds
    about one bf16 rounding of each y (2^-9 relative), so its y may land
    one bf16 step from the plain version's.
    """
    bsz, slen, h, p = x.shape
    a = -torch.exp(a_log.float())
    xdt = (x * dt.to(x.dtype)[..., None]).float()
    decay = torch.exp(dt.float() * a)                      # (B, L, H)
    bh = per_head(b.float(), h, 2)                         # (B, L, H, N)
    ch = per_head(c.float(), h, 2)
    state = torch.zeros((bsz, h, p, b.shape[3]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(slen):
        state = (state * decay[:, t, :, None, None]
                 + xdt[:, t, :, :, None] * bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor, *,
                         scale: float | None = None) -> torch.Tensor:
    """q (B, 1, H, D); k, v (B, T, KH, D); pos (T,) → (B, 1, H, D).

    Slot j counts iff ``pos[j] >= 0``; empty slots score -1e30.  Float32
    scores and softmax, probabilities cast to v's type.  The reference's
    ``decode_attention_ref`` on the kernel's layouts instead of its
    collapsed (B·KH, G, D) and (B·KH, T, D).
    """
    b, _, h, d = q.shape
    kh = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, kh, h // kh, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    scores = torch.where(pos >= 0, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v)
    return out.reshape(b, 1, h, d)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` of float32 tensors rounded once to float32, as a fused
    multiply-add (CUDA's ``__fmaf_rn``; XLA fuses the reference's routed
    dispatch keys into one, ROADMAP C-R18).

    The product is exact in float64 and TwoSum gives the float64 sum's own
    rounding error, so the float64 sum rounds to the right float32 except
    when it lands exactly on a float32 tie with a nonzero error: then the
    result is the neighbour on the error's side."""
    x = a.double() * b.double()
    c64 = c.double()
    s = x + c64
    v = s - x
    err = (x - (s - v)) + (c64 - v)
    f = s.float()
    r = f.double()
    toward = torch.where(s > r, float("inf"), float("-inf")).float()
    g = torch.nextafter(f, toward)
    tie = (s != r) & (s - r == g.double() - s) & (err != 0)
    up = err > 0
    hi, lo = torch.maximum(f, g), torch.minimum(f, g)
    return torch.where(tie, torch.where(up, hi, lo), f)


def bucket_edges(device=None) -> torch.Tensor:
    """The telemetry histogram's 31 float32 edges ``1e-4 · 2^k``, k = 0..30,
    built from float32 bit patterns on ``device`` (no copy from the host,
    so a CUDA-graph capture may call it): the kernel's own edges, equal to
    ``serving.telemetry.BUCKET_EDGES``."""
    k = torch.arange(N_BUCKETS - 1, dtype=torch.int32, device=device)
    return (EDGE0_BITS + (k << 23)).view(torch.float32)


def fcfs_scan_ref(arrivals: torch.Tensor, service: torch.Tensor,
                  type_of_slot: torch.Tensor, priority: torch.Tensor,
                  free0: torch.Tensor, qos_t: float, big: float, *,
                  policy=None, n_active: torch.Tensor | None = None,
                  want_lat: bool = False, want_start: bool = False,
                  want_slot: bool = False):
    """FCFS dispatch of W query streams over L slot layouts: arrivals
    (W, nq) f32, service (W or 1, n_types, nq) f32, type_of_slot (L, S)
    i32, priority (S,) f32, free0 (L, S) or per row (W, L, S) f32 →
    (counts (W, L) i32, latencies (W, L, nq) f32 or None, start times
    (W, L, nq) f32 or None, final next-free times (W, L, S) f32, winning
    slots (W, L, nq) i32 or None, telemetry counters (W, L, 3·n_types + 66)
    i32 or None).

    The reference's ``_simulate_scan`` step (and its fused counter
    ``_grid_lane_qos_counts``) on every lane at once, query by query, in
    float32: ``key = where(free <= a, priority - big, free)``; the slot is
    the first minimum of the key; ``start = max(a, free[slot])``;
    ``finish = start + service[type_of_slot[slot], q]`` (type indices
    clamped to [0, n_types), as jnp's gather clamps); the slot's carry
    becomes ``finish``; the latency is ``finish - a`` and it counts when
    ``<= qos_t``.

    ``policy`` = (pref_slot (L, S), affinity (L,), hedge (L,)) f32 routes
    the dispatch as ``_simulate_scan_policy``: with ``svc`` the query's
    service time on each slot's type, the first minimum of
    ``fma(affinity, svc, pref_slot)·TIE + priority`` over the idle slots if
    any is idle, else the first minimum of ``fma(hedge, svc, free)`` (the
    other side keyed ``INF``).  ``n_active`` (L,) i32 asks for the
    telemetry counters of ``_grid_lane_qos_counts_tel``, per lane: served,
    QoS misses and busy milliseconds per type, the latency and wait
    histograms (``bucket_edges``), then the sum and peak of the queue depth
    ``n_active - #(free <= a)``.
    """
    n_w, nq = arrivals.shape
    n_b, n_s = type_of_slot.shape
    n_types = service.shape[1]
    dev = arrivals.device
    free = free0.expand(n_w, n_b, n_s).clone()
    idle_key = priority - big           # float32: big and qos_t are scalars
    types = type_of_slot.long().clamp(0, n_types - 1).expand(n_w, n_b, n_s)
    flat_types = types.reshape(n_w, n_b * n_s)
    service = service.expand(n_w, n_types, nq)
    iota = torch.arange(n_s, device=dev)
    counts = torch.zeros((n_w, n_b), dtype=torch.int32, device=dev)

    def out(flag, dtype=torch.float32):
        return (torch.empty((n_w, n_b, nq), dtype=dtype, device=dev)
                if flag else None)

    lat, starts, slots = out(want_lat), out(want_start), out(want_slot,
                                                             torch.int32)
    if policy is not None:
        pref, aff, hedge = policy
        aff, hedge = aff[None, :, None], hedge[None, :, None]
    tel = None
    if n_active is not None:
        edges = bucket_edges(dev)
        iota_t = torch.arange(n_types, device=dev)
        iota_k = torch.arange(N_BUCKETS, device=dev)
        served = torch.zeros((n_w, n_b, n_types), dtype=torch.int32,
                             device=dev)
        miss, busy = torch.zeros_like(served), torch.zeros_like(served)
        lath = torch.zeros((n_w, n_b, N_BUCKETS), dtype=torch.int32,
                           device=dev)
        waith = torch.zeros_like(lath)
        dsum = torch.zeros((n_w, n_b), dtype=torch.int32, device=dev)
        dpeak = torch.zeros_like(dsum)
    for q in range(nq):
        a = arrivals[:, q, None]                                  # (W, 1)
        idle = free <= a[..., None]
        if policy is None:
            key = torch.where(idle, idle_key, free)
            slot = key.argmin(dim=-1, keepdim=True)               # (W, L, 1)
        else:
            svc_slot = service[:, :, q].gather(1, flat_types).reshape(
                n_w, n_b, n_s)
            ikey = torch.where(idle, fma32(aff, svc_slot, pref) * TIE
                               + priority, INF)
            bkey = torch.where(idle, INF, fma32(hedge, svc_slot, free))
            slot = torch.where(idle.any(dim=-1, keepdim=True),
                               ikey.argmin(dim=-1, keepdim=True),
                               bkey.argmin(dim=-1, keepdim=True))
        start = torch.maximum(a, free.gather(-1, slot)[..., 0])   # (W, L)
        tslot = types.gather(-1, slot)[..., 0]
        svc = service[:, :, q].gather(1, tslot)
        finish = start + svc
        free = torch.where(iota == slot, finish[..., None], free)
        q_lat = finish - a
        counts += (q_lat <= qos_t).to(torch.int32)
        if want_lat:
            lat[:, :, q] = q_lat
        if want_start:
            starts[:, :, q] = start
        if want_slot:
            slots[:, :, q] = slot[..., 0].to(torch.int32)
        if n_active is not None:
            one_t = (iota_t == tslot[..., None]).to(torch.int32)
            served += one_t
            miss += one_t * (q_lat > qos_t).to(torch.int32)[..., None]
            busy += one_t * torch.round(svc * 1000.0).to(torch.int32)[
                ..., None]
            wait = torch.clamp(start - a, min=0.0)
            for hist, x in ((lath, q_lat), (waith, wait)):
                k = (x[..., None] >= edges).sum(dim=-1, keepdim=True)
                hist += (iota_k == k).to(torch.int32)
            depth = n_active - idle.sum(dim=-1).to(torch.int32)
            dsum += depth
            dpeak = torch.maximum(dpeak, depth)
    if n_active is not None:
        tel = torch.cat([served, miss, busy, lath, waith, dsum[..., None],
                         dpeak[..., None]], dim=-1)
    return counts, lat, starts, free, slots, tel


def fcfs_stream_ref(arrivals: torch.Tensor, batches: torch.Tensor,
                    lut: torch.Tensor, type_of_slot: torch.Tensor,
                    priority: torch.Tensor, free: torch.Tensor,
                    count: torch.Tensor, shift: float, qos_t: float,
                    big: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of a streamed episode, the reference's ``_stream_chunk``:
    arrivals (W, nq) f32, batches (W, nq) i32 (each query's row of ``lut``,
    clamped to [0, n_lut) as jnp's gather clamps), lut (n_lut, n_types) f32,
    type_of_slot (L, S) i32, priority (S,) f32, the carries free (W, L, S)
    f32 and count (W, L) i32 → (count + the chunk's QoS count, the final
    next-free times).  The carry is rebased first, ``free - shift`` in
    float32 (``1e30 - shift == 1e30``); then the scan of ``fcfs_scan_ref``
    from per-row carries, with the service table ``lut[batches]``.  The
    inputs are not modified."""
    rows = batches.long().clamp(0, lut.shape[0] - 1)
    service = lut[rows].permute(0, 2, 1).contiguous()   # (W, n_types, nq)
    counts, _, _, final, _, _ = fcfs_scan_ref(
        arrivals, service, type_of_slot, priority, free - shift, qos_t, big)
    return count + counts, final
