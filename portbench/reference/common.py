"""Plain PyTorch pieces of the reference models, float32 throughout.

Written from the published equations, with nothing of the port: norms,
rotary embeddings, causal attention (every score materialised, in blocks so
that it fits), the top-k MoE layer with per-call expert capacity, the
depthwise causal conv and the Mamba-2 SSD scan (chunked, as in the Mamba-2
paper's minimal listing).  ``Precision`` computes every linear layer either
in float32 (TF32 off) or as the control: its inputs rounded to fp8 e4m3,
scaled per row of the activations and per column of the weights, the step
below the bfloat16 the configurations state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """How the reference computes its linear layers: "float32" or "fp8"."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., k) @ w (k, n), both float32."""
        if self.name == "fp8":
            x, w = fake_fp8(x, -1), fake_fp8(w, 0)
        return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotate-half rotary embedding of x (B, S, H, D) at positions (S,)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d))
    ang = (positions.double()[:, None] * inv[None, :]).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, window: int, scale: float,
                     block_bytes: int = 1 << 30) -> torch.Tensor:
    """q (B, S, H, D), k, v (B, S, KH, D) at positions 0 .. S-1, query head
    h reading KV head h // (H / KH); causal, and banded to ``window`` keys
    when it is positive.  Softmax over every score, in float32."""
    b, s, h, _ = q.shape
    kh = k.shape[2]
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= (pos[:, None] - pos[None, :]) < window
    heads = max(1, min(h, block_bytes // (4 * s * s)))
    out = torch.empty_like(q)
    for i in range(b):
        for h0 in range(0, h, heads):
            hs = torch.arange(h0, min(h, h0 + heads), device=q.device)
            kv = hs // (h // kh)
            qh = q[i][:, hs].transpose(0, 1)                 # (hb, S, D)
            kt = k[i][:, kv].transpose(0, 1)
            vt = v[i][:, kv].transpose(0, 1)
            sc = (qh @ kt.transpose(1, 2)) * scale
            sc = sc.masked_fill(~mask, float("-inf"))
            out[i][:, hs] = (torch.softmax(sc, dim=-1) @ vt).transpose(0, 1)
    return out


def swiglu(prec: Precision, x, w1, w3, w2) -> torch.Tensor:
    return prec.linear(F.silu(prec.linear(x, w1)) * prec.linear(x, w3), w2)


def expert_capacity(tokens: int, k: int, n_experts: int, factor: float) -> int:
    """Slots an expert has in one call of ``tokens`` tokens (Switch's
    capacity): ceil(T k / E * factor), at most T, at least k."""
    return max(min(int(math.ceil(tokens * k / n_experts * factor)), tokens),
               k)


def moe(prec: Precision, x: torch.Tensor, group: torch.Tensor, router,
        w1, w3, w2, k: int, factor: float,
        block: int = 16384) -> torch.Tensor:
    """Top-k MoE over tokens x (T, D), float32.  ``group`` (T,) names the
    call each token was served in: the experts' capacity is counted per
    call, over its tokens in the order given, and per token over its picks
    from the most probable down; a pick ranked past its expert's capacity
    adds nothing.  The router is float32 as the configuration states, in
    the control too; the picks' probabilities are renormalised to 1."""
    t = x.shape[0]
    n_exp = router.shape[1]
    probs = torch.softmax(x @ router, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    key = (group[:, None] * n_exp + top_e).reshape(-1)
    order = torch.sort(key, stable=True).indices
    skey = key[order]
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    idx = torch.arange(skey.numel(), device=x.device)
    run_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - run_start
    sizes = torch.bincount(group)
    caps = torch.tensor([expert_capacity(int(n), k, n_exp, factor)
                         for n in sizes.tolist()], device=x.device)
    keep = rank.view(t, k) < caps[group][:, None]
    out = torch.empty_like(x)
    for b0 in range(0, t, block):
        xb, eb = x[b0:b0 + block], top_e[b0:b0 + block]
        kb, pb = keep[b0:b0 + block], top_p[b0:b0 + block]
        contrib = torch.zeros((xb.shape[0], k, x.shape[1]), device=x.device)
        for e in range(n_exp):
            sel = ((eb == e) & kb).nonzero()
            if sel.numel() == 0:
                continue
            tok, pick = sel[:, 0], sel[:, 1]
            y = swiglu(prec, xb[tok], w1[e], w3[e], w2[e])
            contrib[tok, pick] = y * pb[tok, pick][:, None]
        out[b0:b0 + block] = contrib.sum(dim=1)
    return out


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv1d: x (B, L, C), w (K, C), b (C,)."""
    k = w.shape[0]
    pad = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2])), x], dim=1)
    return sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): out[i, j] = sum of a over (j, i], -inf
    where j > i (the stable form: a masked cumulative sum)."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device), -1)
    s = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return s.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a_log, b, c, chunk: int) -> torch.Tensor:
    """The Mamba-2 SSD scan from a zero state, float32.  x (B, L, H, P); dt
    (B, L, H) after softplus; A = -exp(a_log) (H,); b, c (B, L, G, N), head
    h reading group h // (H / G).  Per head, h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t b_t^T and y_t = h_t c_t, computed by chunks of ``chunk``
    (the sequence zero-padded to a whole number of chunks)."""
    bs, length, h, p = x.shape
    g = b.shape[2]
    pad = (-length) % chunk
    if pad:
        x, dt, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, b, c))
    nc = x.shape[1] // chunk
    heads = torch.arange(h, device=x.device) // (h // g)
    a = dt * -torch.exp(a_log)                                  # (B, L, H)
    xdt = (x * dt[..., None]).view(bs, nc, chunk, h, p)
    bh = b.view(bs, nc, chunk, g, -1)[:, :, :, heads]           # (B,z,Q,H,N)
    ch = c.view(bs, nc, chunk, g, -1)[:, :, :, heads]
    a = a.view(bs, nc, chunk, h).permute(0, 3, 1, 2)            # (B,H,z,Q)
    acum = torch.cumsum(a, dim=-1)
    lmat = torch.exp(segsum(a)).permute(0, 2, 1, 3, 4)          # (B,z,H,Q,Q)
    cb = torch.einsum("bzlhn,bzshn->bzhls", ch, bh)
    y = torch.einsum("bzhls,bzshp->bzlhp", cb * lmat, xdt)
    decay = torch.exp(acum[..., -1:] - acum)                    # (B,H,z,Q)
    states = torch.einsum("bzshn,bhzs,bzshp->bzhpn", bh, decay, xdt)
    state = torch.zeros_like(states[:, 0])
    prev = []
    for z in range(nc):
        prev.append(state)
        state = state * torch.exp(acum[:, :, z, -1])[..., None, None] \
            + states[:, z]
    prev = torch.stack(prev, dim=1)                             # (B,z,H,P,N)
    y = y + torch.einsum("bzlhn,bzhpn,bhzl->bzlhp", ch, prev, torch.exp(acum))
    return y.reshape(bs, nc * chunk, h, p)[:, :length]
