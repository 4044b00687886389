"""Decode-time caches, preallocated and written in place.

Counterpart of the non-quantised part of ``repro/models/cache.py``.  A KV
cache is a dict: ``k`` and ``v`` (L, B, W, KH, hd) tensors, ``pos`` the
shared (W,) int32 table of each slot's absolute position (-1 = empty), and
``t`` the next decode step as a Python int (so a step picks its slot with
no read from the device).  W is the ring size: the sliding window when the
architecture has one, else the longest sequence.  All sequences of the
batch decode in lock-step.

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
                  dtype=torch.bfloat16, device=None) -> dict:
    shape = (n_layers, batch, window, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
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


def write_slot(cache_layer: torch.Tensor, slot: int,
               value: torch.Tensor) -> torch.Tensor:
    """cache_layer (B, W, ...) ← value (B, 1, ...) at ``slot``, in place;
    returns cache_layer."""
    cache_layer[:, slot] = value[:, 0]
    return cache_layer
