"""Model layers in PyTorch: norms, RoPE, GQA and MLA attention, the SwiGLU
and GELU MLPs, top-k MoE.

Counterpart of ``repro/models/layers.py``, with its names, weight layouts
((d_in, d_out) matrices) and order of roundings.  The reference's
``constrain`` sharding hints are dropped: they are no-ops outside a device
mesh, and the port runs on one device.  So is ``moe_layer_local``, the
reference's ``shard_map`` form of the MoE layer, which on one device is
``moe_layer`` (ROADMAP A-11 ports the sharded form).

Full-sequence attention goes through ``kernels.ops.flash_attention`` (the
CUDA kernel on a card, its plain version on the CPU); ``use_kernel=False``
runs the reference model's own math instead (``attention_core`` under
``causal_window_mask``), so a run can hold the kernel path against it on
the card.  Attention softmaxes in float32 whatever the activation type.
MLA's absorbed decode and the MoE layer's expert products run no kernel
of ours, as in the reference (no Pallas kernel there either).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import MASKED


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """Normalise in float32, cast back to x's type, then scale by w."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5):
    """Normalise in float32 by the population variance (``jnp.var``'s),
    cast back to x's type, then scale by w and shift by b."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
    y = x @ w
    return y if b is None else y + b


def swiglu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x W1) * (x W3)) W2."""
    gate = F.silu(dense(x, params["w1"]))
    return dense(gate * dense(x, params["w3"]), params["w2"])


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """GELU MLP with biases: gelu(x W1 + b1) W2 + b2.  ``jax.nn.gelu``
    defaults to the tanh approximation, so this takes it too."""
    h = F.gelu(dense(x, params["w1"], params.get("b1")), approximate="tanh")
    return dense(h, params["w2"], params.get("b2"))


@functools.lru_cache(maxsize=16)
def _inv_freq(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """Inverse frequencies computed in numpy float32, as the reference
    does, so the tables agree; copied to the device once (a copy on every
    call would stall each decode step and cannot be graph-captured)."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    return torch.from_numpy(inv).to(device)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables for rotary embedding.  positions (..., S) int →
    (..., S, dim/2) float32."""
    angles = positions[..., None].float() * _inv_freq(dim, theta,
                                                      positions.device)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., S, H, hd); cos/sin (..., S, hd/2): rotate-half convention,
    computed in float32 and cast back to x's type."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def attention_core(q, k, v, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, T, KH, hd) with H = KH·G; mask (S, T) or
    (B, 1, S, T) bool.  Scores in q's type cast to float32, masked to
    -1e30, float32 softmax, probabilities cast to v's type → (B, S, H, hd).
    Materialises every score: the plain path, and the reference's."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    mask = mask[None, None, None] if mask.dim() == 2 else mask[:, :, None]
    scores = torch.where(mask, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, v.shape[-1])


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: int) -> torch.Tensor:
    """(..., S, T) bool: causal, optionally sliding-window banded."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return m


def attention_full(q, k, v, positions: torch.Tensor, window: int,
                   scale: float, *, causal: bool = True,
                   use_kernel: bool = True) -> torch.Tensor:
    """Full-sequence attention of q (B, S, H, hd) over k/v (B, T, KH, hd):
    causal (T = S, at positions 0 .. S-1: the kernel masks by index, so the
    positions must be those, as forward and prefill pass them), or with
    ``causal=False`` every query over every key (an encoder's
    self-attention, cross attention; ``window`` and ``positions`` unused,
    as in the reference)."""
    if use_kernel:
        return ops.flash_attention(q, k, v, causal=causal,
                                   window=window if causal else 0,
                                   scale=scale)
    if causal:
        mask = causal_window_mask(positions, positions, window)
    else:
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device)
    return attention_core(q, k, v, mask, scale)


def normal(generator: torch.Generator, shape, scale: float, dtype,
           device) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 from ``generator`` (on ``device``),
    cast to ``dtype``."""
    x = torch.randn(shape, generator=generator, device=device) * scale
    return x.to(dtype)


def init_gqa_params(generator: torch.Generator, cfg, dtype,
                    device) -> dict[str, torch.Tensor]:
    """GQA projections drawn from ``generator`` (on ``device``) with the
    reference's scales: wq, wk, wv ~ N(0, 1/d_model), wo ~ N(0, 1/(H·hd));
    zero q/k/v biases when ``cfg.qkv_bias``."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    draw = functools.partial(normal, generator, dtype=dtype, device=device)
    p = {"wq": draw((d, h * hd), d ** -0.5),
         "wk": draw((d, kv * hd), d ** -0.5),
         "wv": draw((d, kv * hd), d ** -0.5),
         "wo": draw((h * hd, d), (h * hd) ** -0.5)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros(width, dtype=dtype, device=device)
    return p


def gqa_project_qkv(params, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Project, split heads, rotate.  x (B, S, D) → q (B, S, H, hd),
    k/v (B, S, KH, hd); positions (S,) or (B, S)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = dense(x, params["wq"], params.get("bq")).reshape(b, s, h, hd)
    k = dense(x, params["wk"], params.get("bk")).reshape(b, s, kv, hd)
    v = dense(x, params["wv"], params.get("bv")).reshape(b, s, kv, hd)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_attention(params, x: torch.Tensor, cfg,
                  positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention block, through the flash-attention kernel.
    positions (S,) = 0 .. S-1."""
    q, k, v = gqa_project_qkv(params, x, cfg, positions)
    out = attention_full(q, k, v, positions, cfg.sliding_window,
                         cfg.d_head ** -0.5)
    b, s = x.shape[:2]
    return dense(out.reshape(b, s, cfg.n_heads * cfg.d_head), params["wo"])


# --------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek/MiniCPM3 style)
# --------------------------------------------------------------------------


def init_mla_params(generator: torch.Generator, cfg, dtype,
                    device) -> dict[str, torch.Tensor]:
    """MLA projections with the reference's scales: the down projections
    wdq, wdkv, wkr ~ N(0, 1/d_model), the up projections by their input
    width, wo by H·v_head_dim; unit q and kv norms."""
    d, h = cfg.d_model, cfg.n_heads
    qr, r = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    draw = functools.partial(normal, generator, dtype=dtype, device=device)
    return {"wdq": draw((d, qr), d ** -0.5),
            "wuq": draw((qr, h * (nd + rd)), qr ** -0.5),
            "wdkv": draw((d, r), d ** -0.5),
            "wkr": draw((d, rd), d ** -0.5),
            "wuk": draw((r, h * nd), r ** -0.5),
            "wuv": draw((r, h * vd), r ** -0.5),
            "wo": draw((h * vd, d), (h * vd) ** -0.5),
            "q_norm": torch.ones(qr, dtype=dtype, device=device),
            "kv_norm": torch.ones(r, dtype=dtype, device=device)}


def mla_latents(params, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Per-token latents: c_q (B, S, qr), c_kv (B, S, r) and the rotated
    shared rope key k_rope (B, S, rd)."""
    eps = cfg.norm_eps
    c_q = rmsnorm(dense(x, params["wdq"]), params["q_norm"], eps)
    c_kv = rmsnorm(dense(x, params["wdkv"]), params["kv_norm"], eps)
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim, cfg.rope_theta)
    k_rope = apply_rope(dense(x, params["wkr"])[..., None, :], cos, sin)
    return c_q, c_kv, k_rope[..., 0, :]


def mla_queries(params, c_q: torch.Tensor, cfg, positions: torch.Tensor):
    """q_nope (B, S, H, nd) and the rotated q_rope (B, S, H, rd)."""
    b, s, _ = c_q.shape
    h, nd, rd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = dense(c_q, params["wuq"]).reshape(b, s, h, nd + rd)
    cos, sin = rope_cos_sin(positions, rd, cfg.rope_theta)
    return q[..., :nd], apply_rope(q[..., nd:], cos, sin)


def mla_prefill(params, x: torch.Tensor, cfg, positions: torch.Tensor, *,
                use_kernel: bool = True):
    """Full-sequence MLA over the prompt (K and V materialised from the
    latents), causal with no window (the reference's ``mla_attention``
    passes window 0 whatever ``cfg.sliding_window``).  Returns the block's
    output (B, S, D) and the latents the cache keeps, c_kv (B, S, r) and
    k_rope (B, S, rd).

    The flash kernel takes one head dim for q, k and v, so on the kernel
    path all three are zero-padded to max(nd + rd, vd) (96 at minicpm3-4b,
    whose values are 64 wide): the padded products are exact zeros, the
    scale stays (nd + rd) ** -0.5, and the output is sliced back to vd."""
    b, s, _ = x.shape
    h, nd, rd, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    c_q, c_kv, k_rope = mla_latents(params, x, cfg, positions)
    q_nope, q_rope = mla_queries(params, c_q, cfg, positions)
    k_nope = dense(c_kv, params["wuk"]).reshape(b, s, h, nd)
    v = dense(c_kv, params["wuv"]).reshape(b, s, h, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rd)], dim=-1)
    scale = (nd + rd) ** -0.5
    if use_kernel:
        width = max(nd + rd, vd)
        q, k, v = (F.pad(t, (0, width - t.shape[-1])) for t in (q, k, v))
        out = ops.flash_attention(q, k, v, causal=True, window=0,
                                  scale=scale)[..., :vd]
    else:
        out = attention_core(q, k, v, causal_window_mask(positions, positions,
                                                         0), scale)
    return dense(out.reshape(b, s, h * vd), params["wo"]), c_kv, k_rope


def mla_decode_absorbed(params, c_q: torch.Tensor, cfg,
                        cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
                        valid: torch.Tensor, pos: torch.Tensor):
    """Single-token MLA decode in latent space (weight absorption):

        score_t = q_nope·(W_uk c_t) + q_rope·kr_t
                = (W_uk^T q_nope)·c_t + q_rope·kr_t

    so attention runs against the (r + rd)-wide latent cache, and each
    head's value is rebuilt once from the attended latent.  Plain products
    (the reference has no kernel here either).

    c_q (B, 1, qr), the new token's query latent (``mla_latents``' first
    output: the caller computes the latents once, writes c_kv and k_rope
    into the cache, then calls this; the reference's form takes x and
    computes them again); cache_ckv (B, T, r); cache_krope (B, T, rd);
    valid (T,) bool; pos (B, 1) → (B, 1, D)."""
    b = c_q.shape[0]
    h, nd, rd, vd, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    q_nope, q_rope = mla_queries(params, c_q, cfg, pos)
    wuk = params["wuk"].reshape(r, h, nd)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wuk.to(q_nope.dtype))
    scores = (torch.einsum("bhr,btr->bht", q_lat, cache_ckv)
              + torch.einsum("bhd,btd->bht", q_rope[:, 0], cache_krope))
    scores = scores.float() * (nd + rd) ** -0.5
    scores = torch.where(valid[None, None, :], scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(c_q.dtype)
    lat = torch.einsum("bht,btr->bhr", probs, cache_ckv)
    wuv = params["wuv"].reshape(r, h, vd)
    out = torch.einsum("bhr,rhd->bhd", lat, wuv.to(lat.dtype))
    return dense(out.reshape(b, 1, h * vd), params["wo"])


# --------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-bounded expert buffers)
# --------------------------------------------------------------------------


class MoE(torch.nn.Module):
    """A MoE layer's parameters under the reference's names: ``router``
    (D, E) and ``experts`` w1, w3 (E, D, F) and w2 (E, F, D).

    The router is float32 whatever type the model serves in, as the
    reference's ``init_moe_params`` keeps it: it is a buffer that
    ``Module.to``, ``.half()`` and the like move between devices but never
    cast (``_apply``), so ``params.to(torch.bfloat16)`` leaves it float32
    and bit for bit as it was."""

    def __init__(self, router: torch.Tensor, experts: dict):
        super().__init__()
        self.register_buffer("router", router.float())
        self.experts = torch.nn.ParameterDict(
            {n: torch.nn.Parameter(x, requires_grad=False)
             for n, x in experts.items()})

    def _apply(self, fn, recurse=True):
        router = self._buffers.pop("router")
        super()._apply(fn, recurse)
        # an empty slice through fn tells the target device without a cast
        self.register_buffer("router", router.to(fn(router[:0]).device))
        return self


def init_moe_params(generator: torch.Generator, cfg, dtype, device) -> MoE:
    """Router ~ N(0, 1/d_model) in float32; experts w1, w3 ~ N(0, 1/d_model)
    and w2 ~ N(0, 1/expert_ff) in ``dtype``."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_ff
    draw = functools.partial(normal, generator, device=device)
    return MoE(draw((d, e), d ** -0.5, torch.float32),
               {"w1": draw((e, d, f), d ** -0.5, dtype),
                "w3": draw((e, d, f), d ** -0.5, dtype),
                "w2": draw((e, f, d), f ** -0.5, dtype)})


def moe_capacity(tokens: int, cfg, capacity_factor: float) -> int:
    """Slots per expert: ceil(T·k / E · cf), at most T, at least k."""
    k = cfg.top_k
    cap = min(int(math.ceil(tokens * k / cfg.n_experts * capacity_factor)),
              tokens)
    return max(cap, k)


def moe_route(moe: MoE, xt: torch.Tensor, k: int):
    """The router in float32 for tokens xt (T, D): the softmax over the
    experts' logits (T, E), the top k experts of each token (T, k) and
    their probabilities renormalised to sum to 1."""
    probs = torch.softmax(dense(xt.float(), moe.router), dim=-1)
    topk_p, topk_e = torch.topk(probs, k, dim=-1)
    return probs, topk_p / topk_p.sum(-1, keepdim=True).clamp_min(1e-9), \
        topk_e


def moe_layer(moe: MoE, x: torch.Tensor, cfg,
              capacity_factor: float | None = None):
    """Top-k MoE with capacity-bounded expert buffers: x (B, S, D) →
    (B, S, D) and the Switch-style load-balancing loss (float32 scalar).

    Route in float32 (softmax over the router's logits, top k, weights
    renormalised); rank each (token, expert) pair within its expert by a
    cumulative count in flat (token, k) order; a pair whose rank reaches
    the capacity C goes to the drop bin, slot C, and contributes nothing.
    The pairs are scattered into (E, C + 1, D) buffers, the experts run as
    batched products over (E, C, D) x (E, D, F), and each token's k
    weighted outputs are added up in x's type, in order (the reference's
    scatter-add)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)

    probs, topk_p, topk_e = moe_route(moe, xt, k)

    flat_e = topk_e.reshape(-1)                                     # (T·k,)
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (t * k)
    aux = e * torch.sum(me * ce)

    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    cap = moe_capacity(t, cfg, capacity_factor)
    flat_p = topk_p.reshape(-1).to(x.dtype)
    flat_tok = torch.arange(t, device=x.device)[:, None].expand(t, k) \
        .reshape(-1)                                # pair i is token i // k

    # the one-hot laid out (E, T·k), so that the count runs along the
    # contiguous axis (along the outer one, CUDA scans with one thread an
    # expert: 366 of olmoe-1b-7b's 521 ms bf16 prefill on an H100,
    # scripts/probe_lms.py)
    onehot = (flat_e[None, :] == torch.arange(e, device=x.device)[:, None]
              ).long()
    rank = (torch.cumsum(onehot, dim=1) - onehot).gather(
        0, flat_e[None, :])[0]
    keep = rank < cap
    slot = torch.where(keep, rank, cap)

    # kept pairs land in distinct slots (the reference's add into zeros is
    # a write there); the drop bin, slot C, is cut off unread
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_e, slot] = xt[flat_tok]
    buf = buf[:, :cap]
    ew = moe.experts
    gate = F.silu(torch.bmm(buf, ew["w1"]))
    out_buf = torch.bmm(gate * torch.bmm(buf, ew["w3"]), ew["w2"])
    out_buf = torch.cat([out_buf, out_buf.new_zeros((e, 1, d))], dim=1)

    y = out_buf[flat_e, slot] * flat_p[:, None] * keep[:, None].to(x.dtype)
    # the reference's scatter-add, its k updates of a token applied in
    # order: deterministic, where index_add_ on a card adds by atomics in
    # an order that changes from run to run (bf16 sums round differently)
    y = y.reshape(t, k, d)
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]
    return out.reshape(b, s, d), aux
