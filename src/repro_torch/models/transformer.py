"""Decoder LMs in PyTorch: the dense GQA, SSM and hybrid families' serving
paths.

Counterpart of ``repro/models/transformer.py`` (the dense branch of
``make_decoder_lm``, :180-350, ``make_ssm_lm`` :353 and ``make_hybrid_lm``
:422).  ``get_model(cfg)`` returns a ``ModelApi``:

    init_params(generator, dtype, device)             -> DecoderLM
    forward(params, tokens, extra)                    -> (logits, aux)
    init_cache(batch, max_len, dtype, device)         -> cache dict
    prefill(params, tokens, max_len, extra)           -> (cache, last_logits)
    decode_step(params, cache, tokens)                -> (logits, cache)

Parameters live in a ``DecoderLM`` module whose layers are an
``nn.ModuleList`` (the reference scans over parameters stacked on a layer
axis); ``lm_from_numpy`` carries the reference's parameter pytree across.
Dense layers attend through the flash-attention kernel in forward and
prefill and through the decode-attention kernel in each decode step, one
launch per layer.  Mamba-2 layers (``ssm.py``) scan the prompt through the
SSD-scan kernel, one launch per layer, and decode in plain PyTorch.  The
hybrid family (zamba2) runs ``attn_every`` Mamba-2 layers, then one shared
attention block, per super-block, each super-block with its own KV ring
layer.  ``prefill`` and ``decode_step`` take ``use_kernel=False`` to run
the reference model's own math instead, so a run can hold the kernel path
against it on the card.  Caches are preallocated and written in place
(``cache.py``): ``decode_step`` returns the same dict it was given,
advanced one step.
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
from .cache import (cache_window, init_kv_cache, init_ssm_cache, ring_slot,
                    write_slot)
from .layers import (attention_core, attention_full, dense, gqa_attention,
                     gqa_project_qkv, init_gqa_params, rmsnorm, swiglu_mlp)
from .ssm import init_ssm_params, ssm_decode_step, ssm_forward


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


class MambaLayer(nn.Module):
    """One pre-norm Mamba-2 block: ``norm`` and ``ssm`` (in_proj, conv_w,
    conv_b, A_log, D, dt_bias, ssm_norm, out_proj) under the reference's
    names."""

    def __init__(self, norm, ssm: dict):
        super().__init__()
        self.norm = _param(norm)
        self.ssm = nn.ParameterDict({n: _param(x) for n, x in ssm.items()})


class DecoderLM(nn.Module):
    """Embedding (V, D), untied ``lm_head`` (D, V), final norm, layers; the
    hybrid family adds its one ``shared`` attention block (a
    ``DecoderLayer``)."""

    def __init__(self, embed, lm_head, final_norm, layers, shared=None):
        super().__init__()
        self.embed = _param(embed)
        self.lm_head = _param(lm_head)
        self.final_norm = _param(final_norm)
        self.layers = nn.ModuleList(layers)
        self.shared = shared


def _unsupported(cfg: ArchConfig) -> str | None:
    """The ROADMAP item that ports what ``cfg`` needs beyond the ported
    families."""
    if cfg.family == "encdec":
        return "the encdec family is ROADMAP A-15e"
    if cfg.family == "vlm":
        return "VLM patch prefixes are ROADMAP A-15d"
    if cfg.is_moe or cfg.family == "moe":
        return "MoE layers are ROADMAP A-15b"
    if cfg.attention == "mla":
        return "MLA attention is ROADMAP A-15a"
    if cfg.kv_quant_int8:
        return "the int8 KV cache is ROADMAP A-15c"
    if cfg.family not in _FAMILIES:
        return f"unknown family {cfg.family!r}"
    return None


def get_model(cfg: ArchConfig) -> ModelApi:
    """The dense GQA, SSM (mamba2) and hybrid (zamba2) families; anything
    else raises ``NotImplementedError`` naming the ROADMAP item that ports
    it."""
    reason = _unsupported(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: not ported yet; {reason}")
    return _FAMILIES[cfg.family](cfg)


def _init_embed(generator, cfg, dtype, device) -> dict:
    d, v = cfg.d_model, cfg.vocab_size

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device) * scale
        return x.to(dtype)

    return {"embed": normal((v, d), 0.02),
            "lm_head": normal((d, v), d ** -0.5),
            "final_norm": torch.ones(d, dtype=dtype, device=device)}


def _init_block(generator, cfg, dtype, device) -> DecoderLayer:
    """One attention + SwiGLU block with the reference's distributions."""
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, s):
        x = torch.randn(shape, generator=generator, device=device) * s
        return x.to(dtype)

    ones = torch.ones(d, dtype=dtype, device=device)
    attn = init_gqa_params(generator, cfg, dtype, device)
    mlp = {"w1": normal((d, f), d ** -0.5), "w3": normal((d, f), d ** -0.5),
           "w2": normal((f, d), f ** -0.5)}
    return DecoderLayer(ones, ones.clone(), attn, mlp)


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


def _attn_prefill(cfg, attn, hn: torch.Tensor, cache: dict, layer: int,
                  positions: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """Full-sequence attention block (B, S, D) → (B, S, D) at positions
    0 .. S-1, through the flash-attention kernel (or the reference's math
    with ``use_kernel=False``); writes its keys and values into ring layer
    ``layer`` of the cache."""
    b, s, _ = hn.shape
    q, k, v = gqa_project_qkv(attn, hn, cfg, positions)
    out = attention_full(q, k, v, positions, cfg.sliding_window,
                         cfg.d_head ** -0.5, use_kernel=use_kernel)
    _ring_scatter(cache, layer, k, v, positions)
    return dense(out.reshape(b, s, cfg.n_heads * cfg.d_head), attn["wo"])


def _advance_ring(cache: dict) -> int:
    """Mark slot t mod W as position t on the device (no host copy) and
    return the slot."""
    t = cache["t"]
    slot = ring_slot(t, cache["k"].shape[2])
    cache["pos"][slot].fill_(t)
    return slot


def _attn_decode(cfg, attn, hn: torch.Tensor, cache: dict, layer: int,
                 slot: int, use_kernel: bool) -> torch.Tensor:
    """Single-token GQA/SWA attention block (B, 1, D) → (B, 1, D) against
    ring layer ``layer``: writes the new key and value into ``slot`` in
    place, then attends through the decode-attention kernel (or the
    reference's masked ``attention_core`` with ``use_kernel=False``).  The
    counterpart of the reference's ``_attn_decode_gqa``."""
    b = hn.shape[0]
    pos_arr = torch.full((b, 1), cache["t"], dtype=torch.int32,
                         device=hn.device)
    q, k_new, v_new = gqa_project_qkv(attn, hn, cfg, pos_arr)
    k_l = write_slot(cache["k"][layer], slot, k_new)
    v_l = write_slot(cache["v"][layer], slot, v_new)
    scale = cfg.d_head ** -0.5
    if use_kernel:
        out = ops.decode_attention(q, k_l, v_l, cache["pos"], scale=scale)
    else:
        out = attention_core(q, k_l, v_l, (cache["pos"] >= 0)[None, :], scale)
    return dense(out.reshape(b, 1, cfg.n_heads * cfg.d_head), attn["wo"])


def _check_extra(extra) -> None:
    if extra is not None:
        raise NotImplementedError("VLM patch prefixes are ROADMAP A-15d")


def make_decoder_lm(cfg: ArchConfig) -> ModelApi:
    eps = cfg.norm_eps

    def init_params(generator: torch.Generator, dtype=torch.float32,
                    device=None) -> DecoderLM:
        """Random weights from ``generator`` (a generator on ``device``)
        with the reference's distributions."""
        dev = resolve_device(device)
        emb = _init_embed(generator, cfg, dtype, dev)
        layers = [_init_block(generator, cfg, dtype, dev)
                  for _ in range(cfg.n_layers)]
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
            h = h + _attn_prefill(cfg, layer.attn,
                                  rmsnorm(h, layer.attn_norm, eps), cache, i,
                                  positions, use_kernel)
            h = h + swiglu_mlp(layer.mlp, rmsnorm(h, layer.mlp_norm, eps))
        cache["t"] = s
        return cache, _logits(params, h[:, -1:], cfg)

    def decode_step(params: DecoderLM, cache: dict, tokens: torch.Tensor, *,
                    use_kernel: bool = True):
        """One new token (B, 1) for every sequence against the standing
        cache; writes its keys and values into slot t mod W of every layer
        in place.  Returns logits (B, 1, V) and the cache."""
        slot = _advance_ring(cache)
        h = F.embedding(tokens, params.embed)
        for i, layer in enumerate(params.layers):
            h = h + _attn_decode(cfg, layer.attn,
                                 rmsnorm(h, layer.attn_norm, eps), cache, i,
                                 slot, use_kernel)
            h = h + swiglu_mlp(layer.mlp, rmsnorm(h, layer.mlp_norm, eps))
        cache["t"] += 1
        return _logits(params, h, cfg), cache

    return ModelApi(cfg, init_params, forward, init_cache, prefill,
                    decode_step)


def _init_mamba_layers(generator, cfg, n: int, dtype, device) -> list:
    """``n`` Mamba-2 layers drawn in float32 and cast, every leaf (A_log, D
    and dt_bias included), to ``dtype``, as the reference's ``_cast``."""
    layers = []
    for _ in range(n):
        ssm = init_ssm_params(generator, cfg, torch.float32, device)
        layers.append(MambaLayer(
            torch.ones(cfg.d_model, dtype=dtype, device=device),
            {k: x.to(dtype) for k, x in ssm.items()}))
    return layers


def _mamba_prefill(cfg, layer: MambaLayer, h: torch.Tensor, cache: dict,
                   index: tuple, use_kernel: bool) -> torch.Tensor:
    """One Mamba-2 block over the prompt; its final state and conv carry
    land in cache entry ``index`` of ``state`` and ``conv``."""
    out, carry = ssm_forward(layer.ssm, rmsnorm(h, layer.norm, cfg.norm_eps),
                             cfg, use_kernel=use_kernel)
    cache["state"][index].copy_(carry["state"])
    cache["conv"][index].copy_(carry["conv"])
    return h + out


def _mamba_decode(cfg, layer: MambaLayer, h: torch.Tensor, cache: dict,
                  index: tuple) -> torch.Tensor:
    """One Mamba-2 block for one token, advancing cache entry ``index`` in
    place."""
    out, _ = ssm_decode_step(layer.ssm, rmsnorm(h, layer.norm, cfg.norm_eps),
                             cfg, {"state": cache["state"][index],
                                   "conv": cache["conv"][index]})
    return h + out


def make_ssm_lm(cfg: ArchConfig) -> ModelApi:
    """The attention-free Mamba-2 stack (mamba2-130m).  Its cache holds each
    layer's state and conv carry, the same size at any length: ``max_len``
    and the cache's ``dtype`` do not shape it."""

    def init_params(generator: torch.Generator, dtype=torch.float32,
                    device=None) -> DecoderLM:
        dev = resolve_device(device)
        emb = _init_embed(generator, cfg, dtype, dev)
        return DecoderLM(emb["embed"], emb["lm_head"], emb["final_norm"],
                         _init_mamba_layers(generator, cfg, cfg.n_layers,
                                            dtype, dev))

    def forward(params: DecoderLM, tokens: torch.Tensor, extra=None):
        _check_extra(extra)
        h = F.embedding(tokens, params.embed)
        for layer in params.layers:
            out, _ = ssm_forward(layer.ssm,
                                 rmsnorm(h, layer.norm, cfg.norm_eps), cfg)
            h = h + out
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return _logits(params, h, cfg), aux

    def init_cache(batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        return init_ssm_cache(cfg, cfg.n_layers, batch,
                              resolve_device(device))

    def prefill(params: DecoderLM, tokens: torch.Tensor, max_len: int,
                extra=None, *, use_kernel: bool = True):
        """Run the prompt tokens (B, S) through the SSD scan (one kernel
        launch per layer); returns the cache and the last logits (B, 1, V)."""
        _check_extra(extra)
        h = F.embedding(tokens, params.embed)
        cache = init_cache(tokens.shape[0], max_len, device=h.device)
        for i, layer in enumerate(params.layers):
            h = _mamba_prefill(cfg, layer, h, cache, (i,), use_kernel)
        cache["t"] = tokens.shape[1]
        return cache, _logits(params, h[:, -1:], cfg)

    def decode_step(params: DecoderLM, cache: dict, tokens: torch.Tensor, *,
                    use_kernel: bool = True):
        """One new token (B, 1) per sequence; advances every layer's state
        and conv carry in place.  No kernel runs here (``use_kernel`` is
        taken for a uniform API)."""
        h = F.embedding(tokens, params.embed)
        for i, layer in enumerate(params.layers):
            h = _mamba_decode(cfg, layer, h, cache, (i,))
        cache["t"] += 1
        return _logits(params, h, cfg), cache

    return ModelApi(cfg, init_params, forward, init_cache, prefill,
                    decode_step)


def make_hybrid_lm(cfg: ArchConfig) -> ModelApi:
    """zamba2: ``n_super = n_layers // attn_every`` super-blocks of
    ``attn_every`` Mamba-2 layers, each followed by the one shared
    attention block (``attn_norm``, ``attn``, ``mlp_norm``, ``mlp``), which
    keeps a KV ring layer per super-block.  ``params.layers`` holds the
    Mamba-2 layers in order; cache ``state`` and ``conv`` are
    (n_super, attn_every, ...) as in the reference."""
    eps = cfg.norm_eps
    n_super, inner = cfg.n_layers // cfg.attn_every, cfg.attn_every

    def init_params(generator: torch.Generator, dtype=torch.float32,
                    device=None) -> DecoderLM:
        dev = resolve_device(device)
        emb = _init_embed(generator, cfg, dtype, dev)
        layers = _init_mamba_layers(generator, cfg, n_super * inner, dtype,
                                    dev)
        return DecoderLM(emb["embed"], emb["lm_head"], emb["final_norm"],
                         layers, _init_block(generator, cfg, dtype, dev))

    def _mamba(params: DecoderLM, s: int):
        return params.layers[s * inner:(s + 1) * inner]

    def forward(params: DecoderLM, tokens: torch.Tensor, extra=None):
        _check_extra(extra)
        h = F.embedding(tokens, params.embed)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=h.device)
        sh = params.shared
        for s in range(n_super):
            for layer in _mamba(params, s):
                out, _ = ssm_forward(layer.ssm, rmsnorm(h, layer.norm, eps),
                                     cfg)
                h = h + out
            h = h + gqa_attention(sh.attn, rmsnorm(h, sh.attn_norm, eps), cfg,
                                  positions)
            h = h + swiglu_mlp(sh.mlp, rmsnorm(h, sh.mlp_norm, eps))
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return _logits(params, h, cfg), aux

    def init_cache(batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        dev = resolve_device(device)
        kv = init_kv_cache(cfg, n_super, batch, cache_window(cfg, max_len),
                           dtype, dev)
        ssm = init_ssm_cache(cfg, n_super * inner, batch, dev)
        for name in ("state", "conv"):
            kv[name] = ssm[name].view(n_super, inner, *ssm[name].shape[1:])
        return kv

    def prefill(params: DecoderLM, tokens: torch.Tensor, max_len: int,
                extra=None, *, use_kernel: bool = True):
        """Run the prompt tokens (B, S): per super-block, its Mamba-2 layers
        through the SSD scan, then the shared block through flash
        attention, its keys and values into the super-block's ring layer.
        Returns the cache and the last logits (B, 1, V)."""
        _check_extra(extra)
        h = F.embedding(tokens, params.embed)
        b, s_len = tokens.shape
        positions = torch.arange(s_len, dtype=torch.int32, device=h.device)
        cache = init_cache(b, max_len, h.dtype, h.device)
        sh = params.shared
        for s in range(n_super):
            for j, layer in enumerate(_mamba(params, s)):
                h = _mamba_prefill(cfg, layer, h, cache, (s, j), use_kernel)
            h = h + _attn_prefill(cfg, sh.attn, rmsnorm(h, sh.attn_norm, eps),
                                  cache, s, positions, use_kernel)
            h = h + swiglu_mlp(sh.mlp, rmsnorm(h, sh.mlp_norm, eps))
        cache["t"] = s_len
        return cache, _logits(params, h[:, -1:], cfg)

    def decode_step(params: DecoderLM, cache: dict, tokens: torch.Tensor, *,
                    use_kernel: bool = True):
        """One new token (B, 1) per sequence: the Mamba-2 layers advance
        their state in place, the shared block writes slot t mod W of its
        ring layer and attends through the decode-attention kernel."""
        slot = _advance_ring(cache)
        h = F.embedding(tokens, params.embed)
        sh = params.shared
        for s in range(n_super):
            for j, layer in enumerate(_mamba(params, s)):
                h = _mamba_decode(cfg, layer, h, cache, (s, j))
            h = h + _attn_decode(cfg, sh.attn, rmsnorm(h, sh.attn_norm, eps),
                                 cache, s, slot, use_kernel)
            h = h + swiglu_mlp(sh.mlp, rmsnorm(h, sh.mlp_norm, eps))
        cache["t"] += 1
        return _logits(params, h, cfg), cache

    return ModelApi(cfg, init_params, forward, init_cache, prefill,
                    decode_step)


_FAMILIES = {"dense": make_decoder_lm, "ssm": make_ssm_lm,
             "hybrid": make_hybrid_lm}


def lm_from_numpy(cfg: ArchConfig, params: dict, dtype=torch.float32,
                  device=None) -> DecoderLM:
    """The reference's parameter pytree, as numpy arrays with the layers
    stacked on leading axes (``jax.tree.map(np.asarray, params)``), as the
    port's ``DecoderLM`` in ``dtype`` on ``device``: ``layers`` (L, ...)
    for the dense and SSM families; ``mamba`` (n_super, attn_every, ...)
    and ``shared`` for the hybrid family."""
    reason = _unsupported(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: not ported yet; {reason}")
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    def group(tree: dict, i) -> dict:
        return {n: tensor(a[i]) for n, a in tree.items()}

    def block(tree: dict, i) -> DecoderLayer:
        return DecoderLayer(tensor(tree["attn_norm"][i]),
                            tensor(tree["mlp_norm"][i]),
                            group(tree["attn"], i), group(tree["mlp"], i))

    shared = None
    if cfg.family == "dense":
        stack = params["layers"]
        layers = [block(stack, i) for i in range(cfg.n_layers)]
    elif cfg.family == "ssm":
        stack = params["layers"]
        layers = [MambaLayer(tensor(stack["norm"][i]), group(stack["ssm"], i))
                  for i in range(cfg.n_layers)]
    else:
        stack = params["mamba"]
        n_super, inner = stack["norm"].shape[:2]
        layers = [MambaLayer(tensor(stack["norm"][s, j]),
                             group(stack["ssm"], (s, j)))
                  for s in range(n_super) for j in range(inner)]
        shared = block(params["shared"], ...)
    return DecoderLM(tensor(params["embed"]), tensor(params["lm_head"]),
                     tensor(params["final_norm"]), layers, shared)
