"""Model layers in PyTorch: norms, RoPE, GQA and MLA attention, the SwiGLU
and GELU MLPs, top-k MoE.

Counterpart of ``repro/models/layers.py``, with its names, weight layouts
((d_in, d_out) matrices) and order of roundings, and its ``constrain``
sharding hints at the same logical specs (``launch.sharding``): outside
a mesh and on the one-card mesh each returns its input, and under a mesh
over a process group it places the activation as a DTensor.  The
kernels take each rank's local shards (``sharding.local_call``), with
heads split over "model" where the heads and KV heads both divide it,
as GSPMD splits the reference's head-sharded q/k/v.
``moe_layer_local`` is the reference's ``shard_map`` form of the MoE
layer, with explicit collectives.

Full-sequence attention goes through ``kernels.ops.flash_attention`` (the
CUDA kernel on a card, its plain version on the CPU) inside
``kernels.autograd.FlashAttention``, whose backward is the gradient of the
reference model's own math (``attention_core`` under
``causal_window_mask``); ``use_kernel=False`` runs that math instead, so a
run can hold the kernel path against it on the card.  Attention softmaxes
in float32 whatever the activation type.
MLA's absorbed decode and the MoE layer's expert products run no kernel
of ours, as in the reference (no Pallas kernel there either).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from ..kernels import autograd as kernel_autograd
from ..kernels.ref import MASKED
from ..launch import sharding as shp
from ..launch.sharding import constrain


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            group=None):
    """Normalise in float32, cast back to x's type, then scale by w.  With
    ``group`` x and w are one rank's equal shards of the last dimension:
    the mean square is taken over the whole (a sum over ``group``)."""
    x32 = x.float()
    if group is None:
        var = (x32 * x32).mean(dim=-1, keepdim=True)
    else:
        var = _sum((x32 * x32).sum(dim=-1, keepdim=True), group) \
            / (x.shape[-1] * group.size())
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
    """``x @ w (+ b)``.  Under a mesh over a process group x's leading
    dimensions are flattened into one first: ``matmul`` folds them only
    where their strides allow, and a DTensor's strides (a size-1
    dimension's scaled by the shard count) can stop the fold, so that the
    product runs batched on ``w`` expanded, which DTensor then copies for
    each row of the batch shard.  A row-parallel product's partial sums
    are added up at once (``sharding.reduce_partial``), as GSPMD adds
    them."""
    if shp.is_distributed(x) and x.dim() > 2:
        y = x.reshape(-1, x.shape[-1]) @ w
        y = y.reshape(*x.shape[:-1], w.shape[-1])
    else:
        y = x @ w
    y = shp.reduce_partial(y)
    return y if b is None else y + b


def swiglu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x W1) * (x W3)) W2."""
    gate = F.silu(dense(x, params["w1"]))
    h = constrain(gate * dense(x, params["w3"]), "batch", None, "model")
    return dense(h, params["w2"])


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """GELU MLP with biases: gelu(x W1 + b1) W2 + b2.  ``jax.nn.gelu``
    defaults to the tanh approximation, so this takes it too."""
    h = F.gelu(dense(x, params["w1"], params.get("b1")), approximate="tanh")
    h = constrain(h, "batch", None, "model")
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


def _masked_attention(q, k, v, positions, window: int, scale: float,
                      causal: bool) -> torch.Tensor:
    """The reference's ``attention_full`` math: ``attention_core`` under the
    causal/window mask of ``positions``, or no mask."""
    if causal:
        mask = causal_window_mask(positions, positions, window)
    else:
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device)
    return attention_core(q, k, v, mask, scale)


def attention_full(q, k, v, positions: torch.Tensor, window: int,
                   scale: float, *, causal: bool = True,
                   use_kernel: bool = True) -> torch.Tensor:
    """Full-sequence attention of q (B, S, H, hd) over k/v (B, T, KH, hd):
    causal (T = S, at positions 0 .. S-1: the kernel masks by index, so the
    positions must be those, as forward and prefill pass them), or with
    ``causal=False`` every query over every key (an encoder's
    self-attention, cross attention; ``window`` and ``positions`` unused,
    as in the reference).  The kernel's backward is the gradient of the
    math that ``use_kernel=False`` runs."""
    window = window if causal else 0
    if use_kernel:
        def kernel(q, k, v, positions):
            return kernel_autograd.flash_attention(
                q, k, v, causal=causal, window=window, scale=scale,
                math=functools.partial(_masked_attention,
                                       positions=positions, window=window,
                                       scale=scale, causal=causal))
        bat, mod = shp.split_elems(shp.active_mesh(), q.shape[0],
                                   q.shape[2], k.shape[2])
        heads = (bat, None, mod, None)
        return shp.local_call(kernel, (q, k, v, positions),
                              (heads, heads, heads, (None,)), heads)
    return _masked_attention(q, k, v, positions, window, scale, causal)


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
    hd = cfg.d_head
    q, k, v = (shp.split_heads(
        constrain(dense(x, params["w" + n], params.get("b" + n)),
                  "batch", None, "model"), heads, hd)
        for n, heads in zip("qkv", (cfg.n_heads, cfg.n_kv_heads,
                                    cfg.n_kv_heads)))
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_attention(params, x: torch.Tensor, cfg, positions: torch.Tensor,
                  *, use_kernel: bool = True) -> torch.Tensor:
    """Full-sequence attention block, through the flash-attention kernel
    (or the reference's math with ``use_kernel=False``).  positions (S,) =
    0 .. S-1."""
    q, k, v = gqa_project_qkv(params, x, cfg, positions)
    out = attention_full(q, k, v, positions, cfg.sliding_window,
                         cfg.d_head ** -0.5, use_kernel=use_kernel)
    return dense(constrain(shp.merge_heads(out), "batch", None, "model"),
                 params["wo"])


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
    h, nd, rd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = shp.split_heads(dense(c_q, params["wuq"]), h, nd + rd)
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
    k_nope = shp.split_heads(dense(c_kv, params["wuk"]), h, nd)
    v = shp.split_heads(dense(c_kv, params["wuv"]), h, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rd)], dim=-1)
    scale = (nd + rd) ** -0.5
    if use_kernel:
        width = max(nd + rd, vd)
        q, k, v = (F.pad(t, (0, width - t.shape[-1])) for t in (q, k, v))
    out = attention_full(q, k, v, positions, 0, scale,
                         use_kernel=use_kernel)[..., :vd]
    return dense(shp.merge_heads(out), params["wo"]), c_kv, k_rope


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
    h, nd, rd, vd = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = mla_queries(params, c_q, cfg, pos)
    wuk = shp.split_heads(params["wuk"], h, nd)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wuk.to(q_nope.dtype))
    scores = (torch.einsum("bhr,btr->bht", q_lat, cache_ckv)
              + torch.einsum("bhd,btd->bht", q_rope[:, 0], cache_krope))
    scores = scores.float() * (nd + rd) ** -0.5
    scores = torch.where(valid[None, None, :], scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(c_q.dtype)
    lat = torch.einsum("bht,btr->bhr", probs, cache_ckv)
    wuv = shp.split_heads(params["wuv"], h, vd)
    out = torch.einsum("bhr,rhd->bhd", lat, wuv.to(lat.dtype))
    return dense(shp.merge_heads(out[:, None]), params["wo"])


# --------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-bounded expert buffers)
# --------------------------------------------------------------------------


class MoE(torch.nn.Module):
    """A MoE layer's parameters under the reference's names: ``router``
    (D, E) and ``experts`` w1, w3 (E, D, F) and w2 (E, F, D).

    The router is float32 whatever type the model serves in, as the
    reference's ``init_moe_params`` keeps it: ``Module.to``, ``.half()``
    and the like move it between devices but never cast it (``_apply``),
    so ``params.to(torch.bfloat16)`` leaves it float32 and bit for bit as
    it was.  Serving holds it as a buffer; training makes it a parameter
    (``make_trainable``), which the optimizer then casts like any other
    (ROADMAP C-R32)."""

    def __init__(self, router: torch.Tensor, experts: dict):
        super().__init__()
        self.register_buffer("router", router.float())
        self.experts = torch.nn.ParameterDict(
            {n: torch.nn.Parameter(x, requires_grad=False)
             for n, x in experts.items()})

    def make_trainable(self) -> None:
        """The router as a float32 parameter that takes gradients."""
        if "router" in self._buffers:
            self.router = torch.nn.Parameter(self._buffers.pop("router"))

    def _apply(self, fn, recurse=True):
        is_param = "router" in self._parameters
        router = (self._parameters if is_param else self._buffers).pop(
            "router")
        super()._apply(fn, recurse)
        # an empty slice through fn tells the target device without a cast
        moved = router.detach().to(fn(router[:0]).device)
        if is_param:
            self.router = torch.nn.Parameter(moved, router.requires_grad)
        else:
            self.register_buffer("router", moved)
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


def moe_route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """The router (D, E) in float32 for tokens xt (T, D): the softmax over the
    experts' logits (T, E), the top k experts of each token (T, k) and
    their probabilities renormalised to sum to 1.  A router a bf16
    training step has cast runs in float32 on its bf16 values, as the
    reference's type promotion does."""
    probs = torch.softmax(dense(xt.float(), router.float()), dim=-1)
    topk_p, topk_e = torch.topk(probs, k, dim=-1)
    return probs, topk_p / topk_p.sum(-1, keepdim=True).clamp_min(1e-9), \
        topk_e


def _moe_dispatch(router: torch.Tensor, xt: torch.Tensor, cfg, cap: int):
    """Route tokens xt (T, D) and scatter each kept (token, expert) pair
    into the (E, C, D) expert buffers: returns the buffers, the aux loss
    and what the combine needs (flat_e, slot, keep, flat_p)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, topk_p, topk_e = moe_route(router, xt, k)

    flat_e = topk_e.reshape(-1)                                     # (T·k,)
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=xt.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (t * k)
    aux = e * torch.sum(me * ce)

    flat_p = topk_p.reshape(-1).to(xt.dtype)
    flat_tok = torch.arange(t, device=xt.device)[:, None].expand(t, k) \
        .reshape(-1)                                # pair i is token i // k

    # the one-hot laid out (E, T·k), so that the count runs along the
    # contiguous axis (along the outer one, CUDA scans with one thread an
    # expert: 366 of olmoe-1b-7b's 521 ms bf16 prefill on an H100,
    # scripts/probe_lms.py)
    onehot = (flat_e[None, :] == torch.arange(e, device=xt.device)[:, None]
              ).long()
    rank = (torch.cumsum(onehot, dim=1) - onehot).gather(
        0, flat_e[None, :])[0]
    keep = rank < cap
    tracing.count("moe.pairs_routed", t * k)
    tracing.count("moe.pairs_kept", keep.sum)
    slot = torch.where(keep, rank, cap)

    # kept pairs land in distinct slots (the reference's add into zeros is
    # a write there); the drop bin, slot C, is cut off unread
    buf = torch.zeros((e, cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf[flat_e, slot] = xt[flat_tok]
    return buf[:, :cap], aux, flat_e, slot, keep, flat_p


def _moe_experts(buf: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    """The experts' SwiGLU as batched products over (E, C, D) buffers."""
    gate = F.silu(torch.bmm(buf, w1))
    return torch.bmm(gate * torch.bmm(buf, w3), w2)


def _moe_combine(out_buf: torch.Tensor, flat_e, slot, keep,
                 flat_p, k: int) -> torch.Tensor:
    """Each token's k weighted expert outputs (T, D), the dropped pairs'
    read from the zero drop bin; added in order (the reference's
    scatter-add, its k updates of a token applied in order: deterministic,
    where index_add_ on a card adds by atomics in an order that changes
    from run to run, and bf16 sums round differently)."""
    e, _, d = out_buf.shape
    out_buf = torch.cat([out_buf, out_buf.new_zeros((e, 1, d))], dim=1)
    y = out_buf[flat_e, slot] * flat_p[:, None] * keep[:, None].to(
        out_buf.dtype)
    y = y.reshape(-1, k, d)
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]
    return out


def moe_layer(moe: MoE, x: torch.Tensor, cfg,
              capacity_factor: float | None = None, _global: bool = False):
    """Top-k MoE with capacity-bounded expert buffers: x (B, S, D) →
    (B, S, D) and the Switch-style load-balancing loss (float32 scalar).
    ``cfg.moe_buffer_shard == "local"`` takes ``moe_layer_local`` unless
    ``_global``.

    Route in float32 (softmax over the router's logits, top k, weights
    renormalised); rank each (token, expert) pair within its expert by a
    cumulative count in flat (token, k) order; a pair whose rank reaches
    the capacity C goes to the drop bin, slot C, and contributes nothing.
    The pairs are scattered into (E, C + 1, D) buffers, the experts run as
    batched products over (E, C, D) x (E, D, F), and each token's k
    weighted outputs are added up in x's type, in order (the reference's
    scatter-add).  Under a mesh over a process group the global dispatch
    and combine see every token (each rank's local call on the gathered
    tokens), and the buffers take the reference's hint: expert-parallel
    over "model" when it divides E, else ``capacity`` or ``capacity2d``
    by ``cfg.moe_buffer_shard``; the expert products run on DTensors."""
    if not _global and cfg.moe_buffer_shard == "local":
        return moe_layer_local(moe, x, cfg, capacity_factor)
    b, s, d = x.shape
    t = b * s
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    cap = moe_capacity(t, cfg, capacity_factor)
    every = (None,) * 3
    with tracing.span("moe"):
        with tracing.span("moe.dispatch"):
            buf, aux, *route = shp.local_call(
                functools.partial(_moe_dispatch, cfg=cfg, cap=cap),
                (moe.router, x.reshape(t, d)), ((None, None), (None, None)),
                (every, (), (None,), (None,), (None,), (None,)))
        mesh = shp.active_mesh()
        model_size = mesh.shape.get("model", 1) if mesh is not None else 1
        if model_size > 1 and cfg.n_experts % model_size == 0:
            buf = constrain(buf, "model", None, None)
        elif cfg.moe_buffer_shard == "capacity":
            buf = constrain(buf, None, "model", None)
        elif cfg.moe_buffer_shard == "capacity2d":
            buf = constrain(buf, None, ("data", "model"), None)
        ew = moe.experts
        with tracing.span("moe.experts"):
            out_buf = _moe_experts(buf, ew["w1"], ew["w3"], ew["w2"])
        with tracing.span("moe.combine"):
            out = shp.local_call(
                functools.partial(_moe_combine, k=cfg.top_k),
                (out_buf, *route),
                (every, (None,), (None,), (None,), (None,)), (None, None))
    return out.reshape(b, s, d), aux


def _collective(name: str, x: torch.Tensor, *args, group) -> torch.Tensor:
    """A functional collective (``torch.ops._c10d_functional``) over
    ``group``, waited for: the calls DTensor makes, so that a gloo group on
    a card stages these too (``launch.host_collectives``)."""
    fc = torch.ops._c10d_functional
    return fc.wait_tensor(getattr(fc, name)(x.contiguous(), *args,
                                            group.group_name))


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    return _collective("all_reduce", x, "sum", group=group)


class _AllReduce(torch.autograd.Function):
    """Sum over ``group`` forward; the gradient passes as it is (the output
    is the same on every rank, and so is its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradAllReduce(torch.autograd.Function):
    """The identity forward; the gradient summed over ``group`` (each rank
    holds the part of it that its shard of the weights contributes)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """The shards of ``group`` concatenated along ``dim`` forward; the
    gradient summed over the group and cut back to this rank's shard
    backward (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = torch.distributed.get_world_size(group)
        out = _collective("all_gather_into_tensor", x.movedim(dim, 0), n,
                          group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = torch.distributed.get_world_size(ctx.group)
        out = _collective("reduce_scatter_tensor", g.movedim(ctx.dim, 0),
                          "sum", n, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


class _Mean(torch.autograd.Function):
    """The mean over ``group`` forward; each rank's share of the gradient,
    g / n, backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = torch.distributed.get_world_size(group)
        return _sum(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def moe_local_specs(cfg) -> dict:
    """The expert weights' specs that ``moe_layer_local`` computes in: F
    over "model", and under ``cfg.fsdp`` D over "data".  Weights placed so
    take no redistribution a call (``param_shardings`` places experts
    expert-parallel where "model" divides E)."""
    fsdp = "data" if cfg.fsdp else None
    return {"w1": (None, fsdp, "model"), "w3": (None, fsdp, "model"),
            "w2": (None, "model", fsdp)}


def moe_layer_local(moe: MoE, x: torch.Tensor, cfg,
                    capacity_factor: float | None = None):
    """The reference's locality-aware MoE: tokens are dispatched within
    their data shard (no token crosses a shard), the expert weights stay
    tensor-parallel over "model" (F split), under ``cfg.fsdp`` gathered
    over "data" (w1 and w3 on their D axis, w2 on its), the experts'
    down-projections summed over "model", the aux loss averaged over the
    data axes, and the capacity taken from the local token count.  Each
    rank runs the body on its local shards with explicit collectives
    whose backward is the matching collective.  Falls back to the global
    layer where the reference does: no mesh, no data axis over 1, a model
    axis of 1, or an F (or, under fsdp, a D) that does not divide."""
    mesh = shp.active_mesh()
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    if mesh is None:
        return moe_layer(moe, x, cfg, capacity_factor, _global=True)
    data_axes = tuple(a for a in ("pod", "data")
                      if a in mesh.axis_names and mesh.shape[a] > 1)
    model_sz = mesh.shape.get("model", 1)
    d, f = cfg.d_model, cfg.expert_ff
    dp = math.prod(mesh.shape[a] for a in data_axes)
    usable = (data_axes and model_sz > 1 and f % model_sz == 0
              and (not cfg.fsdp or d % dp == 0))
    if not usable:
        return moe_layer(moe, x, cfg, capacity_factor, _global=True)
    if getattr(mesh, "device_mesh", None) is None:
        raise NotImplementedError(
            f"moe_layer_local over mesh axes {dict(mesh.shape)} needs a "
            "process group (mesh.make_process_mesh)")
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dm = mesh.device_mesh
    b, s, _ = x.shape
    k = cfg.top_k
    t_local = (b // dp) * s
    cap = moe_capacity(t_local, cfg, capacity_factor)
    data_group = dm.get_group("data")
    model_group = dm.get_group("model")
    batch_group = (data_group if data_axes == ("data",)
                   else dm._flatten(data_axes).get_group())
    bat = data_axes if len(data_axes) > 1 else data_axes[0]

    def local(x_dt, spec, grad_spec):
        x_dt = shp.as_dtensor(x_dt, mesh)
        return x_dt.redistribute(dm, shp.placements(spec, mesh)).to_local(
            grad_placements=grad_spec)

    # the gradients: a weight's is each rank's part along an axis it is
    # whole on (its tokens' part; under fsdp _AllGather sums over "data"
    # itself); the router's a sum over the data ranks' tokens; the tokens'
    # whole on every model rank (their expert part summed over "model" by
    # _GradAllReduce)
    router = local(moe.router, (None, None),
                   [Partial() if a in data_axes else Replicate()
                    for a in mesh.axis_names])
    w1, w3, w2 = (local(moe.experts[name], spec,
                        [p if isinstance(p, Shard) else Partial()
                         for p in shp.placements(spec, mesh)])
                  for name, spec in moe_local_specs(cfg).items())
    xl = local(x, (bat, None, None),
               [Shard(0) if a in data_axes else Replicate()
                for a in mesh.axis_names])
    if cfg.fsdp:
        w1 = _AllGather.apply(w1, 1, data_group)
        w3 = _AllGather.apply(w3, 1, data_group)
        w2 = _AllGather.apply(w2, 2, data_group)
    bl, sl, _ = xl.shape
    buf, aux, *route = _moe_dispatch(router, xl.reshape(bl * sl, d), cfg,
                                     cap)
    aux = _Mean.apply(aux, batch_group)
    out_buf = _AllReduce.apply(
        _moe_experts(_GradAllReduce.apply(buf, model_group), w1, w3, w2),
        model_group)
    out = _moe_combine(out_buf, *route, k).reshape(bl, sl, d)
    return (DTensor.from_local(out, dm, shp.placements((bat, None, None),
                                                        mesh),
                               run_check=False),
            DTensor.from_local(aux, dm, [Replicate()] * dm.ndim,
                               run_check=False))
