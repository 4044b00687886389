"""Dense decoder layers in PyTorch: RMSNorm, RoPE, GQA attention, SwiGLU.

Counterpart of the dense part of ``repro/models/layers.py`` (:26-217), with
its names, weight layouts ((d_in, d_out) matrices) and order of roundings.
The reference's ``constrain`` sharding hints are dropped: they are no-ops
outside a device mesh, and the port runs on one device.

Full-sequence attention goes through ``kernels.ops.flash_attention`` (the
CUDA kernel on a card, its plain version on the CPU); ``use_kernel=False``
runs the reference model's own math instead (``attention_core`` under
``causal_window_mask``), so a run can hold the kernel path against it on
the card.  Attention softmaxes in float32 whatever the activation type.
"""

from __future__ import annotations

import functools

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


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
    y = x @ w
    return y if b is None else y + b


def swiglu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x W1) * (x W3)) W2."""
    gate = F.silu(dense(x, params["w1"]))
    return dense(gate * dense(x, params["w3"]), params["w2"])


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
                   scale: float, *, use_kernel: bool = True) -> torch.Tensor:
    """Causal full-sequence attention of q (B, S, H, hd) over k/v
    (B, S, KH, hd) at positions 0 .. S-1 (the kernel masks by index, so the
    positions must be those, as forward and prefill pass them)."""
    if use_kernel:
        return ops.flash_attention(q, k, v, causal=True, window=window,
                                   scale=scale)
    return attention_core(q, k, v, causal_window_mask(positions, positions,
                                                      window), scale)


def init_gqa_params(generator: torch.Generator, cfg, dtype,
                    device) -> dict[str, torch.Tensor]:
    """GQA projections drawn from ``generator`` (on ``device``) with the
    reference's scales: wq, wk, wv ~ N(0, 1/d_model), wo ~ N(0, 1/(H·hd));
    zero q/k/v biases when ``cfg.qkv_bias``."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device) * scale
        return x.to(dtype)

    p = {"wq": normal((d, h * hd), d ** -0.5),
         "wk": normal((d, kv * hd), d ** -0.5),
         "wv": normal((d, kv * hd), d ** -0.5),
         "wo": normal((h * hd, d), (h * hd) ** -0.5)}
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
