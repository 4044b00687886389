"""Decoder LMs in PyTorch: the dense GQA family's serving path.

Counterpart of ``repro/models/transformer.py`` (the dense branch of
``make_decoder_lm``, :180-350).  ``get_model(cfg)`` returns a ``ModelApi``:

    init_params(generator, dtype, device)             -> DecoderLM
    forward(params, tokens, extra)                    -> (logits, aux)
    init_cache(batch, max_len, dtype, device)         -> cache dict
    prefill(params, tokens, max_len, extra)           -> (cache, last_logits)
    decode_step(params, cache, tokens)                -> (logits, cache)

Parameters live in a ``DecoderLM`` module whose layers are an
``nn.ModuleList`` (the reference scans over parameters stacked on a layer
axis); ``lm_from_numpy`` carries the reference's parameter pytree across.
Forward and prefill attend through the flash-attention kernel and each
decode step through the decode-attention kernel, one launch per layer;
``prefill`` and ``decode_step`` take ``use_kernel=False`` to run the
reference model's own attention math instead, so a run can hold the
kernel path against it on the card.  The cache is preallocated and written in place (``cache.py``):
``decode_step`` returns the same dict it was given, advanced one step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels import ops
from .cache import cache_window, init_kv_cache, ring_slot, write_slot
from .layers import (attention_core, attention_full, dense, gqa_attention,
                     gqa_project_qkv, init_gqa_params, rmsnorm, swiglu_mlp)


@dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init_params: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm block: ``attn`` (wq, wk, wv, wo and q/k/v biases) and
    ``mlp`` (w1, w3, w2) as ParameterDicts under the reference's names."""

    def __init__(self, attn_norm, mlp_norm, attn: dict, mlp: dict):
        super().__init__()
        self.attn_norm = _param(attn_norm)
        self.mlp_norm = _param(mlp_norm)
        self.attn = nn.ParameterDict({n: _param(x) for n, x in attn.items()})
        self.mlp = nn.ParameterDict({n: _param(x) for n, x in mlp.items()})


class DecoderLM(nn.Module):
    """Embedding (V, D), untied ``lm_head`` (D, V), final norm, layers."""

    def __init__(self, embed, lm_head, final_norm, layers):
        super().__init__()
        self.embed = _param(embed)
        self.lm_head = _param(lm_head)
        self.final_norm = _param(final_norm)
        self.layers = nn.ModuleList(layers)


def _unsupported(cfg: ArchConfig) -> str | None:
    """The ROADMAP item that ports what ``cfg`` needs beyond this family."""
    if cfg.family == "ssm":
        return "the SSM family is ROADMAP A-S3 (next slice)"
    if cfg.family in ("hybrid", "encdec"):
        return f"the {cfg.family} family is ROADMAP A-15e"
    if cfg.family == "vlm":
        return "VLM patch prefixes are ROADMAP A-15d"
    if cfg.is_moe or cfg.family == "moe":
        return "MoE layers are ROADMAP A-15b"
    if cfg.attention == "mla":
        return "MLA attention is ROADMAP A-15a"
    if cfg.kv_quant_int8:
        return "the int8 KV cache is ROADMAP A-15c"
    if cfg.family != "dense":
        return f"unknown family {cfg.family!r}"
    return None


def get_model(cfg: ArchConfig) -> ModelApi:
    """The dense GQA decoder family; anything else raises
    ``NotImplementedError`` naming the ROADMAP item that ports it."""
    reason = _unsupported(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: not ported yet; {reason}")
    return make_decoder_lm(cfg)


def _init_embed(generator, cfg, dtype, device) -> dict:
    d, v = cfg.d_model, cfg.vocab_size

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device) * scale
        return x.to(dtype)

    return {"embed": normal((v, d), 0.02),
            "lm_head": normal((d, v), d ** -0.5),
            "final_norm": torch.ones(d, dtype=dtype, device=device)}


def _logits(params: DecoderLM, h: torch.Tensor, cfg) -> torch.Tensor:
    return dense(rmsnorm(h, params.final_norm, cfg.norm_eps), params.lm_head)


def _ring_scatter(cache: dict, layer: int, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor) -> None:
    """Write the prompt's keys and values (B, S, KH, hd), keyed by absolute
    positions (S,), into slots ``positions mod W`` of cache layer ``layer``
    and the position table, in place; of S > W positions the last W are
    kept.  The reference builds a new ring instead."""
    w = cache["k"].shape[2]
    kept = positions[-w:]
    slots = kept.long() % w
    cache["k"][layer][:, slots] = k[:, -w:]
    cache["v"][layer][:, slots] = v[:, -w:]
    cache["pos"][slots] = kept


def _check_extra(extra) -> None:
    if extra is not None:
        raise NotImplementedError("VLM patch prefixes are ROADMAP A-15d")


def make_decoder_lm(cfg: ArchConfig) -> ModelApi:
    eps, scale = cfg.norm_eps, cfg.d_head ** -0.5
    width = cfg.n_heads * cfg.d_head

    def init_params(generator: torch.Generator, dtype=torch.float32,
                    device=None) -> DecoderLM:
        """Random weights from ``generator`` (a generator on ``device``)
        with the reference's distributions."""
        dev = resolve_device(device)
        d, f = cfg.d_model, cfg.d_ff

        def normal(shape, s):
            x = torch.randn(shape, generator=generator, device=dev) * s
            return x.to(dtype)

        emb = _init_embed(generator, cfg, dtype, dev)
        layers = []
        for _ in range(cfg.n_layers):
            ones = torch.ones(d, dtype=dtype, device=dev)
            attn = init_gqa_params(generator, cfg, dtype, dev)
            mlp = {"w1": normal((d, f), d ** -0.5),
                   "w3": normal((d, f), d ** -0.5),
                   "w2": normal((f, d), f ** -0.5)}
            layers.append(DecoderLayer(ones, ones.clone(), attn, mlp))
        return DecoderLM(emb["embed"], emb["lm_head"], emb["final_norm"],
                         layers)

    def forward(params: DecoderLM, tokens: torch.Tensor, extra=None):
        """tokens (B, S) → logits (B, S, V) and the auxiliary loss (0 for
        the dense family)."""
        _check_extra(extra)
        h = F.embedding(tokens, params.embed)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=h.device)
        for layer in params.layers:
            h = h + gqa_attention(layer.attn, rmsnorm(h, layer.attn_norm, eps),
                                  cfg, positions)
            h = h + swiglu_mlp(layer.mlp, rmsnorm(h, layer.mlp_norm, eps))
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return _logits(params, h, cfg), aux

    def init_cache(batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        return init_kv_cache(cfg, cfg.n_layers, batch,
                             cache_window(cfg, max_len), dtype,
                             resolve_device(device))

    def prefill(params: DecoderLM, tokens: torch.Tensor, max_len: int,
                extra=None, *, use_kernel: bool = True):
        """Run the prompt tokens (B, S); returns a cache of ring size
        ``cache_window(cfg, max_len)`` in the parameters' type holding the
        prompt's keys and values, and the last position's logits
        (B, 1, V)."""
        _check_extra(extra)
        h = F.embedding(tokens, params.embed)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=h.device)
        cache = init_cache(b, max_len, h.dtype, h.device)
        for i, layer in enumerate(params.layers):
            hn = rmsnorm(h, layer.attn_norm, eps)
            q, k, v = gqa_project_qkv(layer.attn, hn, cfg, positions)
            out = attention_full(q, k, v, positions, cfg.sliding_window,
                                 scale, use_kernel=use_kernel)
            h = h + dense(out.reshape(b, s, width), layer.attn["wo"])
            h = h + swiglu_mlp(layer.mlp, rmsnorm(h, layer.mlp_norm, eps))
            _ring_scatter(cache, i, k, v, positions)
        cache["t"] = s
        return cache, _logits(params, h[:, -1:], cfg)

    def decode_step(params: DecoderLM, cache: dict, tokens: torch.Tensor, *,
                    use_kernel: bool = True):
        """One new token (B, 1) for every sequence against the standing
        cache; writes its keys and values into slot t mod W of every layer
        in place.  Returns logits (B, 1, V) and the cache."""
        t = cache["t"]
        slot = ring_slot(t, cache["k"].shape[2])
        cache["pos"][slot].fill_(t)   # a device fill: no host copy
        h = F.embedding(tokens, params.embed)
        b = h.shape[0]
        pos_arr = torch.full((b, 1), t, dtype=torch.int32, device=h.device)
        valid = None if use_kernel else (cache["pos"] >= 0)[None, :]
        for i, layer in enumerate(params.layers):
            hn = rmsnorm(h, layer.attn_norm, eps)
            q, k_new, v_new = gqa_project_qkv(layer.attn, hn, cfg, pos_arr)
            k_l = write_slot(cache["k"][i], slot, k_new)
            v_l = write_slot(cache["v"][i], slot, v_new)
            if use_kernel:
                out = ops.decode_attention(q, k_l, v_l, cache["pos"],
                                           scale=scale)
            else:
                out = attention_core(q, k_l, v_l, valid, scale)
            h = h + dense(out.reshape(b, 1, width), layer.attn["wo"])
            h = h + swiglu_mlp(layer.mlp, rmsnorm(h, layer.mlp_norm, eps))
        cache["t"] = t + 1
        return _logits(params, h, cfg), cache

    return ModelApi(cfg, init_params, forward, init_cache, prefill,
                    decode_step)


def lm_from_numpy(cfg: ArchConfig, params: dict, dtype=torch.float32,
                  device=None) -> DecoderLM:
    """The reference's parameter pytree, as numpy arrays with the layers
    stacked on a leading L axis (``jax.tree.map(np.asarray, params)``), as
    the port's ``DecoderLM`` in ``dtype`` on ``device``."""
    reason = _unsupported(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: not ported yet; {reason}")
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    stack = params["layers"]
    layers = [DecoderLayer(tensor(stack["attn_norm"][i]),
                           tensor(stack["mlp_norm"][i]),
                           {n: tensor(a[i]) for n, a in stack["attn"].items()},
                           {n: tensor(a[i]) for n, a in stack["mlp"].items()})
              for i in range(cfg.n_layers)]
    return DecoderLM(tensor(params["embed"]), tensor(params["lm_head"]),
                     tensor(params["final_norm"]), layers)
