"""Decode-time caches, preallocated and written in place.

Counterpart of ``repro/models/cache.py``.  A KV cache is a dict: ``k`` and
``v`` (L, B, W, KH, hd) tensors, ``pos`` the shared (W,) int32 table of
each slot's absolute position (-1 = empty), and ``t`` the next decode step
as a Python int (so a step picks its slot with no read from the device).
W is the ring size: the sliding window when the architecture has one, else
the longest sequence.  All sequences of the batch decode in lock-step.
The int8 form (``kv_quant_int8``) holds ``k`` and ``v`` as int8 with one
scale per (token, head) in ``k_scale`` and ``v_scale`` (L, B, W, KH), in
the serving type; an MLA cache (``init_mla_cache``) holds the latents
``ckv`` (L, B, W, r) and the rope keys ``krope`` (L, B, W, rd) instead.

The reference's caches are immutable pytrees rebuilt on every write
(``.at[:, slot].set`` and restacking out of ``lax.scan``); here the tensors
are allocated once and every write lands in place, so a decode step moves
one slot per layer instead of copying 2·L·B·W·KH·hd elements.  An SSM
cache (``init_ssm_cache``) holds each layer's recurrent state and conv
carry, overwritten in place by prefill and by every decode step.
"""

from __future__ import annotations

import torch


def init_kv_cache(cfg, n_layers: int, batch: int, window: int,
                  dtype=torch.bfloat16, device=None, quant=None) -> dict:
    """``quant`` (default ``cfg.kv_quant_int8``) asks for the int8 form:
    ``k``, ``v`` int8 and their scales in ``dtype``."""
    if quant is None:
        quant = cfg.kv_quant_int8
    shape = (n_layers, batch, window, cfg.n_kv_heads, cfg.d_head)
    kv_dtype = torch.int8 if quant else dtype
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "pos": torch.full((window,), -1, dtype=torch.int32, device=device),
        "t": 0,
    }
    if quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=dtype, device=device)
    return cache


def quantize_kv(x: torch.Tensor):
    """x (..., hd) → int8 values and one scale per vector, in x's type:
    scale = max(max |x| / 127, 1e-8) in float32, values round(x / scale)
    (half to even, as ``jnp.round``) clipped to [-127, 127].  The stored
    scale carries x's rounding (bf16 when serving), the values do not."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(x.dtype)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 values times their scale, in float32, cast to ``dtype``."""
    return (q.float() * scale[..., None].float()).to(dtype)


def init_mla_cache(cfg, n_layers: int, batch: int, window: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {
        "ckv": torch.zeros((n_layers, batch, window, cfg.kv_lora_rank),
                           dtype=dtype, device=device),
        "krope": torch.zeros((n_layers, batch, window, cfg.qk_rope_dim),
                             dtype=dtype, device=device),
        "pos": torch.full((window,), -1, dtype=torch.int32, device=device),
        "t": 0,
    }


def init_ssm_cache(cfg, n_layers: int, batch: int, device=None) -> dict:
    """``state`` (L, B, H, P, N) and ``conv`` (L, B, K-1, conv_dim), both
    float32 whatever the activation type, as in the reference; ``t`` the
    next decode step as a Python int."""
    h, p, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * n
    return {
        "state": torch.zeros((n_layers, batch, h, p, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((n_layers, batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=torch.float32, device=device),
        "t": 0,
    }


def cache_window(cfg, max_len: int) -> int:
    """Ring size: the sliding window if the arch has one, else max_len."""
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_len)
    return max_len


def ring_slot(t: int, window: int) -> int:
    return t % window

