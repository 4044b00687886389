"""The yardstick's counts: the work a problem needs, from its shapes, and the
card's peaks.

Each count is what the problem needs, whatever implements it: every input
read once, every output written once, causal attention over the keys each
query may see, each token's k experts (not a padded capacity).  Peaks are
NVIDIA's data-sheet figures for one H100 SXM at its 700 W limit, dense
bf16 on the tensor cores and HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12        # bf16 dense, FLOP/s
PEAK_BYTES = 3.35e12       # HBM3, bytes/s
BF16 = 2
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: compute or memory, the larger."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def causal_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs a causal mask keeps over s positions, banded to
    ``window`` keys when it is positive."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash(b: int, s: int, h: int, kh: int, d: int, window: int = 0):
    """Causal prefill attention of q (b, s, h, d) over k, v (b, s, kh, d):
    (flops, bytes) for QK^T and PV on the pairs the mask keeps."""
    flops = 4 * b * h * d * causal_pairs(s, window)
    nbytes = BF16 * (2 * b * s * h * d + 2 * b * s * kh * d)
    return flops, nbytes


def decode_attention(b: int, n_valid: int, h: int, kh: int, d: int):
    """One query a sequence against n_valid cached keys and values."""
    flops = 4 * b * h * d * n_valid
    nbytes = BF16 * (2 * b * n_valid * kh * d + 2 * b * h * d) + 4 * n_valid
    return flops, nbytes


def ssd_scan(b: int, length: int, h: int, p: int, g: int, n: int,
             chunk: int):
    """The Mamba-2 SSD scan of x (b, L, h, p) with dt (b, L, h) float32, B
    and C (b, L, g, n), to y (b, L, h, p) and the final float32 state: the
    chunked form's products, its in-chunk part causal."""
    full, rest = divmod(length, chunk)
    pairs = full * chunk * (chunk + 1) // 2 + rest * (rest + 1) // 2
    flops = b * h * (2 * pairs * (n + p) + 4 * length * n * p)
    nbytes = (BF16 * (2 * b * length * h * p + 2 * b * length * g * n)
              + F32 * (b * length * h + h + b * h * p * n))
    return flops, nbytes


def _sizes(cfg: dict):
    d, hd = cfg["d_model"], cfg.get("d_head") or 0
    h, kh = cfg.get("n_heads", 0), cfg.get("n_kv_heads", 0)
    return d, h, kh, hd


def attention_layers(cfg: dict) -> int:
    if cfg["family"] == "hybrid":
        return cfg["n_layers"] // cfg["attn_every"]
    return cfg["n_layers"] if cfg["family"] in ("dense", "moe") else 0


def mamba_layers(cfg: dict) -> int:
    if cfg["family"] == "hybrid":
        return cfg["n_layers"] // cfg["attn_every"] * cfg["attn_every"]
    return cfg["n_layers"] if cfg["family"] == "ssm" else 0


def ssm_shape(cfg: dict):
    """(d_inner, heads, head dim, groups, state, conv channels)."""
    d_in = cfg.get("ssm_expand", 2) * cfg["d_model"]
    p = cfg.get("ssm_headdim", 64)
    g, n = cfg.get("ssm_ngroups", 1), cfg["ssm_state"]
    return d_in, d_in // p, p, g, n, d_in + 2 * g * n


def _per_token_matmul_params(cfg: dict) -> int:
    """Weights a token multiplies, summed over the layers (k experts a MoE
    layer and its router; no embedding, no head)."""
    d, h, kh, hd = _sizes(cfg)
    attn = d * hd * (2 * h + 2 * kh)
    if cfg["family"] == "moe":
        ffn = cfg["top_k"] * 3 * d * cfg["d_expert"] + d * cfg["n_experts"]
    else:
        ffn = 3 * d * cfg["d_ff"]
    total = attention_layers(cfg) * (attn + ffn)
    if mamba_layers(cfg):
        d_in, nh, _, g, n, _ = ssm_shape(cfg)
        total += mamba_layers(cfg) * (d * (2 * d_in + 2 * g * n + nh)
                                      + d_in * d)
    return total


def prefill_flops(cfg: dict, b: int, s: int) -> int:
    """Model FLOPs of a prefill of b prompts of s tokens: every layer's
    products, causal attention, the conv and SSD scan, and the logits at
    the last position only."""
    d, h, kh, hd = _sizes(cfg)
    flops = 2 * b * s * _per_token_matmul_params(cfg)
    n_attn = attention_layers(cfg)
    if n_attn:
        flops += n_attn * flash(b, s, h, kh, hd,
                                cfg.get("sliding_window", 0))[0]
    if mamba_layers(cfg):
        _, nh, p, g, n, conv = ssm_shape(cfg)
        per = ssd_scan(b, s, nh, p, g, n, cfg.get("ssm_chunk", 256))[0]
        per += 2 * b * s * cfg.get("conv_kernel", 4) * conv
        flops += mamba_layers(cfg) * per
    return flops + 2 * b * d * cfg["vocab_size"]


def weight_bytes(cfg: dict) -> int:
    """Bytes of every weight but the embedding table, served in bf16 (a
    MoE router float32)."""
    d, h, kh, hd = _sizes(cfg)
    attn = d * hd * (2 * h + 2 * kh) + 2 * d
    if cfg["family"] == "moe":
        e = cfg["n_experts"]
        ffn = e * 3 * d * cfg["d_expert"]
        router = d * e * F32
    else:
        ffn, router = 3 * d * cfg["d_ff"], 0
    n_attn = attention_layers(cfg)
    blocks = 1 if cfg["family"] == "hybrid" else n_attn
    total = BF16 * blocks * (attn + ffn) + blocks * router
    if mamba_layers(cfg):
        d_in, nh, _, g, n, conv = ssm_shape(cfg)
        per = (d * (2 * d_in + 2 * g * n + nh) + d_in * d
               + cfg.get("conv_kernel", 4) * conv + conv + 3 * nh + d_in + d)
        total += BF16 * mamba_layers(cfg) * per
    return total + BF16 * (d * cfg["vocab_size"] + d)


def decode_step(cfg: dict, b: int, n_valid: int):
    """(flops, bytes) of one greedy decode step of b sequences whose cache
    holds n_valid positions, the new one included: every weight read once
    (every expert of a MoE layer, which b x k picks all but always touch),
    b rows of the embedding, the cache's valid keys and values and the
    recurrent state read once and the new entries written."""
    d, h, kh, hd = _sizes(cfg)
    flops = 2 * b * (_per_token_matmul_params(cfg) + d * cfg["vocab_size"])
    nbytes = weight_bytes(cfg) + BF16 * b * d
    n_attn = attention_layers(cfg)
    if n_attn:
        f, by = decode_attention(b, n_valid, h, kh, hd)
        flops += n_attn * f
        nbytes += n_attn * by
    if mamba_layers(cfg):
        _, nh, p, g, n, conv = ssm_shape(cfg)
        flops += mamba_layers(cfg) * b * nh * 5 * p * n
        nbytes += mamba_layers(cfg) * F32 * b * (
            2 * nh * p * n + 2 * (cfg.get("conv_kernel", 4) - 1) * conv)
    return flops, nbytes
