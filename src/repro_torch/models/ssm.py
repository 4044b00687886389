"""The Mamba-2 (SSD, state-space duality) layer in PyTorch: chunked scan for
prefill, a stateful recurrent step for decode.

Counterpart of ``repro/models/ssm.py``, with its names, weight layouts and
order of roundings.  Per head, the discrete SSD recurrence of Dao & Gu
(arXiv:2405.21060):

    h_t = exp(dt_t · A) h_{t-1} + dt_t · x_t ⊗ B_t
    y_t = C_t · h_t + D ⊙ x_t

``ssm_forward`` runs a whole sequence through ``kernels.ops.ssd_scan`` (the
CUDA kernel on a card, its plain version on the CPU) inside
``kernels.autograd.SSDScan``, whose backward is the gradient of the
reference model's own chunked math (``ssd_chunked``); ``use_kernel=False``
runs that math instead, so a run can hold the kernel path against it on
the card.  ``ssm_decode_step`` is plain PyTorch (the reference has no
kernel for it) and writes the cache layer's state and conv carry in
place; given the "model" group it runs one rank's part of the step on
the reference's sharded layout (weights and state as the specs split
them over "model", explicit collectives of activations only).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .. import tracing
from ..kernels import autograd as kernel_autograd
from ..kernels.ref import per_head, ssd_scan_ref
from ..launch import sharding as shp
from ..launch.sharding import constrain
from .layers import _collective, _sum, dense, rmsnorm


def init_ssm_params(generator: torch.Generator, cfg, dtype=torch.float32,
                    device=None) -> dict[str, torch.Tensor]:
    """One layer's weights from ``generator`` (on ``device``) with the
    reference's shapes and scales; A_log, D and dt_bias in float32 as the
    reference makes them (its LMs then cast every leaf to the serving
    type)."""
    d, d_in = cfg.d_model, cfg.d_inner
    g, n, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = d_in + 2 * g * n

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device) * scale
        return x.to(dtype)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": normal((d, 2 * d_in + 2 * g * n + nh), d ** -0.5),
        "conv_w": normal((cfg.conv_kernel, conv_dim), cfg.conv_kernel ** -0.5),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones(nh, **f32),
        "dt_bias": torch.zeros(nh, **f32),
        "ssm_norm": torch.ones(d_in, dtype=dtype, device=device),
        "out_proj": normal((d_in, d), d_in ** -0.5),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    """(..., 2·d_inner + 2·G·N + H) → z, xbc, dt (views)."""
    d_in = cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * gn],
            zxbcdt[..., 2 * d_in + 2 * gn:])


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, carry: torch.Tensor | None = None):
    """Depthwise causal conv1d as the reference computes it: a sum of K
    shifted products (elementwise, so no TF32 convolution on the card).
    xbc (B, L, C); conv_w (K, C); carry (B, K-1, C) prefixes the sequence
    (zeros when None).  Returns the output and the new carry, the last K-1
    rows of the padded sequence (a view)."""
    k = conv_w.shape[0]
    if carry is None:
        carry = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    padded = torch.cat([carry, xbc], dim=1)
    out = sum(padded[:, i:i + xbc.shape[1]] * conv_w[i] for i in range(k))
    new_carry = padded[:, -(k - 1):] if k > 1 else carry
    return out + conv_b, new_carry


def _heads(cfg, xbc: torch.Tensor):
    """Split the conv output (..., conv_dim) into x (..., H, P) and b, c
    (..., G, N): views, not copies."""
    d_in, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    return (shp.split_heads(xbc[..., :d_in], cfg.ssm_nheads,
                            cfg.ssm_headdim),
            shp.split_heads(xbc[..., d_in:d_in + g * n], g, n),
            shp.split_heads(xbc[..., d_in + g * n:], g, n))


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular cumulative segment sums: out[..., i, j] =
    sum_{j<k<=i} x_k, -inf above the diagonal.  x (..., T) → (..., T, T)."""
    t = x.shape[-1]
    xx = x[..., None, :].expand(*x.shape, t).transpose(-1, -2)
    ones = torch.ones((t, t), dtype=torch.bool, device=x.device)
    xx = torch.where(torch.tril(ones, diagonal=-1), xx, 0.0)
    out = torch.cumsum(xx, dim=-2)
    return torch.where(torch.tril(ones), out, -torch.inf)


def ssd_chunked(x, dt, a_log, b, c, chunk: int):
    """The reference model's chunked SSD scan (the plain path):
    x (B, L, H, P), dt (B, L, H) after softplus, a_log (H,), b, c
    (B, L, G, N) with groups broadcast onto heads → y (B, L, H, P) in x's
    type and the final state (B, H, P, N) float32.  L % chunk == 0.  The
    in-chunk products run in x's type (the scores rounded to it), the
    state and carried-state term in float32, as the reference."""
    bsz, slen, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if slen % chunk != 0:
        raise ValueError(f"seq {slen} not divisible by chunk {chunk}")
    nc = slen // chunk

    a = -torch.exp(a_log.float())
    da = dt.float() * a                                   # (B, L, H)
    xdt = x * dt[..., None].to(x.dtype)

    xc = xdt.reshape(bsz, nc, chunk, h, p)
    bh = per_head(b.reshape(bsz, nc, chunk, g, n), h, 3)
    ch = per_head(c.reshape(bsz, nc, chunk, g, n), h, 3)
    da_t = da.reshape(bsz, nc, chunk, h).movedim(-1, 2)   # (B, nc, H, Q)
    lmat = torch.exp(segsum(da_t))                        # (B, nc, H, Q, Q)

    scores = torch.einsum("bzqhn,bzkhn->bzhqk", ch, bh).float()
    y_diag = torch.einsum("bzhqk,bzkhp->bzqhp",
                          (scores * lmat).to(x.dtype), xc)

    da_cum = torch.cumsum(da_t, dim=-1)                   # (B, nc, H, Q)
    decay_to_end = torch.exp(da_cum[..., -1:] - da_cum)
    states = torch.einsum("bzqhn,bzhq,bzqhp->bzhpn", bh,
                          decay_to_end.to(bh.dtype), xc).float()

    chunk_decay = torch.exp(da_cum[..., -1])              # (B, nc, H)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for z in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                # (B, nc, H, P, N)

    y_off = torch.einsum("bzqhn,bzhpn,bzhq->bzqhp", ch.float(), prev_states,
                         torch.exp(da_cum))
    y = y_diag.float() + y_off
    return y.reshape(bsz, slen, h, p).to(x.dtype), state


def ssd_reference_sequential(x, dt, a_log, b, c):
    """The O(L) token-by-token recurrence in float32 (x·dt not rounded),
    y cast to x's type: the reference's check of the chunked form."""
    y, state = ssd_scan_ref(x.float(), dt.float(), a_log.float(), b.float(),
                            c.float())
    return y.to(x.dtype), state


def ssm_forward(params, x: torch.Tensor, cfg, *, use_kernel: bool = True):
    """Full-sequence Mamba-2 block from a zero state.  x (B, L, D) →
    (out (B, L, D), carry {"state" (B, H, P, N) float32, "conv"
    (B, K-1, conv_dim)}).  ``use_kernel`` picks ``ops.ssd_scan`` (any L;
    its backward the gradient of ``ssd_chunked``) or the reference's
    ``ssd_chunked`` (chunk ``cfg.ssm_chunk``, or the whole length when it
    does not divide L, as the reference falls back)."""
    bsz, slen, _ = x.shape
    with tracing.span("mamba"):
        z, xbc, dt = _split_proj(cfg, dense(x, params["in_proj"]))
        with tracing.span("mamba.conv"):
            xbc, new_conv = _causal_conv(xbc, params["conv_w"],
                                         params["conv_b"])
            xbc = F.silu(xbc)
        x_in, b, c = _heads(cfg, xbc)
        dt = F.softplus(dt.float() + params["dt_bias"])
        chunk = cfg.ssm_chunk if slen % cfg.ssm_chunk == 0 else slen
        if use_kernel:
            bat, mod = shp.split_elems(shp.active_mesh(), bsz,
                                       cfg.ssm_nheads,
                                       *(() if cfg.ssm_ngroups == 1
                                         else (cfg.ssm_ngroups,)))
            heads = (bat, None, mod, None)
            groups = (bat, None, mod if cfg.ssm_ngroups > 1 else None, None)
            y, state = shp.local_call(
                lambda *a: kernel_autograd.ssd_scan(
                    *a, math=functools.partial(ssd_chunked, chunk=chunk)),
                (x_in, dt, params["A_log"], b, c),
                (heads, (bat, None, mod), (mod,), groups, groups),
                (heads, (bat, mod, None, None)))
        else:
            y, state = ssd_chunked(x_in, dt, params["A_log"], b, c, chunk)
        with tracing.span("mamba.gate"):
            y = shp.merge_heads(y + params["D"].to(x.dtype)[:, None] * x_in)
            y = rmsnorm(y * F.silu(z), params["ssm_norm"], cfg.norm_eps)
        out = constrain(dense(y, params["out_proj"]), "batch", None, None)
    return out, {"state": state, "conv": new_conv}


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' column shards of x (..., C / size) side by side (an
    all-gather over ``group``)."""
    out = _collective("all_gather_into_tensor", x.movedim(-1, 0),
                      group.size(), group=group)
    return out.movedim(0, -1)


def ssm_decode_step(params, x: torch.Tensor, cfg, carry: dict, group=None):
    """Single-token recurrent step.  x (B, 1, D); carry {"state"
    (B, H, P, N) float32, "conv" (B, K-1, conv_dim)}, a cache layer, both
    overwritten in place (the conv carry is read in x's type, as the
    reference casts it).  Returns (out (B, 1, D), carry).

    With ``group``, the mesh's "model" axis, the arguments are one rank's
    local shards, placed as the reference's specs place them, and what is
    split is read from their shapes; the step moves activations only.  An
    ``in_proj`` narrower than its 2·d_inner + 2·G·N + H columns is
    column-parallel: its product's shards are gathered (the segments z,
    xBC and dt cross them, and the conv carry and B, C are needed whole).
    A state with fewer than H heads holds the rank's heads: x, dt, A_log,
    D, dt_bias and the gated norm's columns follow them, the norm's sum of
    squares summed over ``group``.  An ``out_proj`` with fewer than
    d_inner rows is row-parallel: a rank that stepped every head takes its
    rows of y, and the partial products are summed over ``group``."""
    state, conv = carry["state"], carry["conv"]
    nh, hd = cfg.ssm_nheads, cfg.ssm_headdim
    zxbcdt = dense(x, params["in_proj"])
    if zxbcdt.shape[-1] < 2 * cfg.d_inner + 2 * cfg.ssm_ngroups * \
            cfg.ssm_state + nh:
        zxbcdt = _gather_last(zxbcdt, group)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv.to(x.dtype))
    conv.copy_(new_conv)
    x_in, b, c = _heads(cfg, F.silu(xbc)[:, 0])
    heads = cols = slice(None)
    norm_group = None
    if state.shape[1] < nh:                                # this rank's heads
        first = group.rank() * state.shape[1]
        heads = slice(first, first + state.shape[1])
        cols, norm_group = slice(first * hd, heads.stop * hd), group
    x_in = x_in[:, heads]
    bh = per_head(b, nh, 1)[:, heads].float()             # (B, H, N)
    ch = per_head(c, nh, 1)[:, heads].float()
    dt = F.softplus(dt[:, 0, heads].float() + params["dt_bias"][heads])
    # exp(A_log) in A_log's type: bf16 when serving bf16, as the reference
    decay = torch.exp(dt * -torch.exp(params["A_log"][heads]))
    x32 = x_in.float()
    state.mul_(decay[..., None, None]).add_(
        x32[..., None] * bh[:, :, None, :] * dt[..., None, None])
    y = torch.einsum("bhpn,bhn->bhp", state, ch)
    y = shp.merge_heads((y + params["D"][heads][:, None] * x32)[:, None]) \
        .to(x.dtype)
    y = rmsnorm(y * F.silu(z[..., cols]), params["ssm_norm"][cols],
                cfg.norm_eps, norm_group)
    rows = params["out_proj"].shape[0]
    if y.shape[-1] > rows:                 # every head stepped, rows split
        y = y.narrow(-1, group.rank() * rows, rows)
    out = dense(y, params["out_proj"])
    if rows < cfg.d_inner:
        out = _sum(out, group)
    return out, carry
