"""Reference of a Zamba2-style hybrid (zamba2-2.7b), plain PyTorch in float32:
super-blocks of ``attn_every`` Mamba-2 layers, each followed by one shared
attention and SwiGLU block (the same weights every time).

    Mamba-2 layer, n = rms(h) g:
        z, xBC, dt = n · W_in
        x, B, C    = silu(conv(xBC))
        dt         = softplus(dt + dt_bias),  A = -exp(A_log)
        y          = SSD(x, dt, A, B, C) + D x
        h         += (rms(y · silu(z)) g_y) · W_out
    shared block: h += attention(rms(h) g_a);  h += SwiGLU(rms(h) g_m)
    logits = (rms(h) g_f) · W_head
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..weights import Leaf
from .common import causal_conv, rmsnorm, ssd, swiglu
from .decoder import attention_block


def _sizes(cfg: dict):
    d = cfg["d_model"]
    d_in = cfg.get("ssm_expand", 2) * d
    g, n = cfg.get("ssm_ngroups", 1), cfg["ssm_state"]
    nh = d_in // cfg.get("ssm_headdim", 64)
    return d, d_in, g, n, nh


def params(cfg: dict) -> list[Leaf]:
    d, d_in, g, n, nh = _sizes(cfg)
    v, f, k = cfg["vocab_size"], cfg["d_ff"], cfg.get("conv_kernel", 4)
    h, kh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    conv_dim = d_in + 2 * g * n
    out = [Leaf("embed", (v, d), "served", ("normal", 0.02)),
           Leaf("lm_head", (d, v), "served", ("normal", d ** -0.5)),
           Leaf("final_norm", (d,), "served", ("norm",))]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        out += [Leaf(p + "norm", (d,), "served", ("norm",)),
                Leaf(p + "ssm.in_proj", (d, 2 * d_in + 2 * g * n + nh),
                     "served", ("normal", d ** -0.5)),
                Leaf(p + "ssm.conv_w", (k, conv_dim), "served",
                     ("normal", k ** -0.5)),
                Leaf(p + "ssm.conv_b", (conv_dim,), "served", ("normal", 0.1)),
                Leaf(p + "ssm.A_log", (nh,), "served", ("a_log",)),
                Leaf(p + "ssm.D", (nh,), "served", ("uniform", 0.5, 1.5)),
                Leaf(p + "ssm.dt_bias", (nh,), "served", ("dt_bias",)),
                Leaf(p + "ssm.ssm_norm", (d_in,), "served", ("norm",)),
                Leaf(p + "ssm.out_proj", (d_in, d), "served",
                     ("normal", d_in ** -0.5))]
    s = "shared."
    out += [Leaf(s + "attn_norm", (d,), "served", ("norm",)),
            Leaf(s + "mlp_norm", (d,), "served", ("norm",)),
            Leaf(s + "attn.wq", (d, h * hd), "served", ("normal", d ** -0.5)),
            Leaf(s + "attn.wk", (d, kh * hd), "served", ("normal", d ** -0.5)),
            Leaf(s + "attn.wv", (d, kh * hd), "served", ("normal", d ** -0.5)),
            Leaf(s + "attn.wo", (h * hd, d), "served",
                 ("normal", (h * hd) ** -0.5)),
            Leaf(s + "mlp.w1", (d, f), "served", ("normal", d ** -0.5)),
            Leaf(s + "mlp.w3", (d, f), "served", ("normal", d ** -0.5)),
            Leaf(s + "mlp.w2", (f, d), "served", ("normal", f ** -0.5))]
    return out


def mamba_layer(prec, cfg: dict, w, p: str, x: torch.Tensor) -> torch.Tensor:
    """One Mamba-2 layer's output (B, L, D) for its normed input x."""
    b, length, _ = x.shape
    _, d_in, g, n, nh = _sizes(cfg)
    hp = cfg.get("ssm_headdim", 64)
    zxbcdt = prec.linear(x, w(p + "in_proj"))
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * g * n]
    dt = zxbcdt[..., 2 * d_in + 2 * g * n:]
    xbc = F.silu(causal_conv(xbc, w(p + "conv_w"), w(p + "conv_b")))
    xs = xbc[..., :d_in].reshape(b, length, nh, hp)
    bm = xbc[..., d_in:d_in + g * n].reshape(b, length, g, n)
    cm = xbc[..., d_in + g * n:].reshape(b, length, g, n)
    dt = F.softplus(dt + w(p + "dt_bias"))
    y = ssd(xs, dt, w(p + "A_log"), bm, cm, cfg.get("ssm_chunk", 256))
    y = (y + w(p + "D")[:, None] * xs).reshape(b, length, d_in)
    y = rmsnorm(y * F.silu(z), w(p + "ssm_norm"), cfg.get("norm_eps", 1e-5))
    return prec.linear(y, w(p + "out_proj"))


def final_hidden(prec, cfg: dict, w, tokens: torch.Tensor, prompt_len: int,
                 first: int) -> torch.Tensor:
    """The final normed hidden state (B, S - first, D) of tokens (B, S).
    No layer here couples sequences, so ``prompt_len`` does not matter."""
    eps = cfg.get("norm_eps", 1e-5)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h = w("embed")[tokens]
    every = cfg["attn_every"]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        h = h + mamba_layer(prec, cfg, w, p + "ssm.",
                            rmsnorm(h, w(p + "norm"), eps))
        if (i + 1) % every == 0:
            h = h + attention_block(prec, cfg, w, "shared.attn.",
                                    rmsnorm(h, w("shared.attn_norm"), eps),
                                    positions)
            h = h + swiglu(prec, rmsnorm(h, w("shared.mlp_norm"), eps),
                           w("shared.mlp.w1"), w("shared.mlp.w3"),
                           w("shared.mlp.w2"))
    return rmsnorm(h[:, first:], w("final_norm"), eps)
