"""Reference of a decoder LM with rotary GQA attention and a SwiGLU MLP or a
top-k MoE layer (olmoe-1b-7b), plain PyTorch in float32.

    h = E[tokens]
    per layer:  h += Wo · attn(rope(Wq n), rope(Wk n), Wv n),  n = rms(h) g_a
                h += ffn(rms(h) g_m)      (SwiGLU, or the top-k MoE)
    logits = (rms(h) g_f) · W_head

The weights are the benchmark's (``weights.py``); ``params`` names them.
"""

from __future__ import annotations

import torch

from ..weights import Leaf
from .common import causal_attention, moe, rmsnorm, rope, swiglu


def params(cfg: dict) -> list[Leaf]:
    d, v = cfg["d_model"], cfg["vocab_size"]
    h, kh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    out = [Leaf("embed", (v, d), "served", ("normal", 0.02)),
           Leaf("lm_head", (d, v), "served", ("normal", d ** -0.5)),
           Leaf("final_norm", (d,), "served", ("norm",))]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        out += [Leaf(p + "attn_norm", (d,), "served", ("norm",)),
                Leaf(p + "mlp_norm", (d,), "served", ("norm",)),
                Leaf(p + "attn.wq", (d, h * hd), "served", ("normal", d ** -0.5)),
                Leaf(p + "attn.wk", (d, kh * hd), "served", ("normal", d ** -0.5)),
                Leaf(p + "attn.wv", (d, kh * hd), "served", ("normal", d ** -0.5)),
                Leaf(p + "attn.wo", (h * hd, d), "served",
                     ("normal", (h * hd) ** -0.5))]
        if cfg.get("n_experts", 0):
            e, f = cfg["n_experts"], cfg["d_expert"]
            out += [Leaf(p + "moe.router", (d, e), "float32",
                         ("normal", d ** -0.5)),
                    Leaf(p + "moe.experts.w1", (e, d, f), "served",
                         ("normal", d ** -0.5)),
                    Leaf(p + "moe.experts.w3", (e, d, f), "served",
                         ("normal", d ** -0.5)),
                    Leaf(p + "moe.experts.w2", (e, f, d), "served",
                         ("normal", f ** -0.5))]
        else:
            f = cfg["d_ff"]
            out += [Leaf(p + "mlp.w1", (d, f), "served", ("normal", d ** -0.5)),
                    Leaf(p + "mlp.w3", (d, f), "served", ("normal", d ** -0.5)),
                    Leaf(p + "mlp.w2", (f, d), "served", ("normal", f ** -0.5))]
    return out


def attention_block(prec, cfg: dict, w, prefix: str, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Wo · attn(...) of x (B, S, D) at positions 0 .. S-1."""
    b, s, _ = x.shape
    h, kh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    theta = cfg.get("rope_theta", 1e4)
    q = prec.linear(x, w(prefix + "wq")).view(b, s, h, hd)
    k = prec.linear(x, w(prefix + "wk")).view(b, s, kh, hd)
    v = prec.linear(x, w(prefix + "wv")).view(b, s, kh, hd)
    out = causal_attention(rope(q, positions, theta), rope(k, positions, theta),
                           v, cfg.get("sliding_window", 0), hd ** -0.5)
    return prec.linear(out.reshape(b, s, h * hd), w(prefix + "wo"))


def served_order(b: int, s: int, prompt_len: int, device):
    """The order the program serves the tokens of B sequences of S in, and
    the call each is served in: the prompts, (b, s) order, in one call
    (group 0), then position prompt_len + j of every sequence, in b order,
    in call j + 1 (a decode step).  Returns (flat index into the (B, S)
    tokens, group)."""
    idx = torch.arange(b * s, device=device).view(b, s)
    first = idx[:, :prompt_len].reshape(-1)
    steps = idx[:, prompt_len:].transpose(0, 1).reshape(-1)
    group = torch.cat([torch.zeros_like(first),
                       torch.arange(1, s - prompt_len + 1, device=device)
                       .repeat_interleave(b)])
    return torch.cat([first, steps]), group


def final_hidden(prec, cfg: dict, w, tokens: torch.Tensor, prompt_len: int,
                 first: int) -> torch.Tensor:
    """The final normed hidden state (B, S - first, D) of tokens (B, S),
    the prompts' prompt_len and then one served token a decode step."""
    b, s = tokens.shape
    eps = cfg.get("norm_eps", 1e-5)
    positions = torch.arange(s, device=tokens.device)
    h = w("embed")[tokens]
    order, group = served_order(b, s, prompt_len, tokens.device)
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        h = h + attention_block(prec, cfg, w, p + "attn.",
                                rmsnorm(h, w(p + "attn_norm"), eps),
                                positions)
        x = rmsnorm(h, w(p + "mlp_norm"), eps)
        if cfg.get("n_experts", 0):
            xt = x.reshape(b * s, -1)[order]
            y = torch.empty_like(xt)
            y[order] = moe(prec, xt, group, w(p + "moe.router"),
                           w(p + "moe.experts.w1"), w(p + "moe.experts.w3"),
                           w(p + "moe.experts.w2"), cfg["top_k"],
                           cfg.get("moe_capacity_factor", 1.25))
            h = h + y.view(b, s, -1)
        else:
            h = h + swiglu(prec, x, w(p + "mlp.w1"), w(p + "mlp.w3"),
                           w(p + "mlp.w2"))
    return rmsnorm(h[:, first:], w("final_norm"), eps)
