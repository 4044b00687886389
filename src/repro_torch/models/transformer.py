"""The LM families in PyTorch: decoder LMs (dense GQA, MLA, MoE, VLM patch
prefixes, the int8 KV cache), SSM, hybrid and encoder-decoder.

Counterpart of ``repro/models/transformer.py`` (``make_decoder_lm`` :180,
``make_ssm_lm`` :353, ``make_hybrid_lm`` :422, ``make_encdec_lm`` :571).
``get_model(cfg)`` returns a ``ModelApi`` for every configuration in
``configs.ARCHS``:

    init_params(generator, dtype, device)             -> DecoderLM
    forward(params, tokens, extra)                    -> (logits, aux)
    loss(params, tokens, labels, extra)               -> scalar
    init_cache(batch, max_len, dtype, device)         -> cache dict
    prefill(params, tokens, max_len, extra)           -> (cache, last_logits)
    decode_step(params, cache, tokens)                -> (logits, cache)

Parameters live in a ``DecoderLM`` module whose layers are an
``nn.ModuleList`` of ``Layer``s under the reference's names (the reference
scans over parameters stacked on a layer axis); ``lm_from_numpy`` carries
the reference's parameter pytree across.  GQA layers attend through the
flash-attention kernel in forward and prefill and through the
decode-attention kernel in each decode step, one launch per layer; the
int8 KV cache is dequantised to the serving type for that kernel.  MLA
layers prefill through the flash kernel (q, k and v zero-padded to one
head dim) and decode in latent space with plain products, as the
reference does.  MoE layers route and run their experts in plain PyTorch
(``layers.moe_layer``).  A VLM prepends its patch embeddings (``extra``,
(B, n_patches, D)) to the tokens' and decodes on from position
n_patches + S.  Mamba-2 layers (``ssm.py``) scan the prompt through the
SSD-scan kernel, one launch per layer, and decode in plain PyTorch.  The
hybrid family (zamba2) runs ``attn_every`` Mamba-2 layers, then one shared
attention block, per super-block, each super-block with its own KV ring
layer.  The encoder-decoder (whisper) encodes its frames (``extra``,
(B, T, D)) with non-causal flash attention, attends from the decoder to
them through flash attention in prefill and through the decode-attention
kernel in each step.  ``forward``, ``loss``, ``prefill`` and
``decode_step`` take ``use_kernel=False`` to run the reference model's own
math instead, so a run can hold the kernel path against it on the card.
Caches are preallocated and written in place (``cache.py``):
``decode_step`` returns the same dict it was given, advanced one step.

Training (``launch.train``): ``loss`` is the reference's ``_lm_loss``;
gradients flow through the kernels by ``kernels.autograd`` (the kernel
forward, the gradient of the reference's math backward); with
``cfg.remat`` each block of ``forward`` runs under
``torch.utils.checkpoint`` while autograd records, as the reference's
``jax.checkpoint`` (the block's kernels then run twice a step);
``make_trainable`` turns a model's parameters on for gradients (serving
keeps them frozen), and ``lm_tree``/``lm_untree`` map its parameters to
and from the reference's pytree layout (layers stacked), the checkpoints'
and the reference's optimizer state's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels import ops
from ..launch import sharding as shp
from ..launch.sharding import constrain
from ..optim.adamw import AdamWState
from .cache import (cache_window, dequantize_kv, init_kv_cache,
                    init_mla_cache, init_ssm_cache, quantize_kv, ring_slot)
from .layers import (MoE, attention_core, attention_full, dense, gelu_mlp,
                     gqa_attention, gqa_project_qkv, init_gqa_params,
                     init_mla_params, init_moe_params, layernorm,
                     mla_decode_absorbed, mla_latents, mla_prefill,
                     moe_layer, normal, rmsnorm, swiglu_mlp)
from .ssm import init_ssm_params, ssm_decode_step, ssm_forward


@dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init_params: Callable
    forward: Callable
    loss: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class Layer(nn.Module):
    """One layer's parameters under the reference's names: a tensor is a
    Parameter, a dict of tensors a ParameterDict, a module (``MoE``) kept as
    it is.  A decoder block has ``attn_norm``, ``attn``, ``mlp_norm`` and
    ``mlp`` or ``moe``; a Mamba-2 block ``norm`` and ``ssm``; an encoder
    block ``norm1_w/b``, ``attn``, ``norm2_w/b`` and ``mlp`` (w1, b1, w2,
    b2), a decoder block of the encoder-decoder those and ``xattn``,
    ``norm3_w/b``."""

    def __init__(self, **parts):
        super().__init__()
        for name, x in parts.items():
            if isinstance(x, dict):
                x = nn.ParameterDict({n: _param(a) for n, a in x.items()})
            elif not isinstance(x, nn.Module):
                x = _param(x)
            setattr(self, name, x)


class DecoderLM(nn.Module):
    """Embedding (V, D), untied ``lm_head`` (D, V), final norm, layers; the
    hybrid family adds its one ``shared`` attention block, the
    encoder-decoder its ``enc_layers`` (its ``layers`` are the reference's
    ``dec_layers``)."""

    def __init__(self, embed, lm_head, final_norm, layers, shared=None,
                 enc_layers=None):
        super().__init__()
        self.embed = _param(embed)
        self.lm_head = _param(lm_head)
        self.final_norm = _param(final_norm)
        self.layers = nn.ModuleList(layers)
        self.shared = shared
        self.enc_layers = None if enc_layers is None else \
            nn.ModuleList(enc_layers)


def get_model(cfg: ArchConfig) -> ModelApi:
    """Every family of ``configs.ARCHS``: dense (GQA or MLA), moe and vlm
    (``make_decoder_lm``), ssm (mamba2), hybrid (zamba2), encdec
    (whisper)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg)


def _init_embed(generator, cfg, dtype, device) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    return {"embed": normal(generator, (v, d), 0.02, dtype, device),
            "lm_head": normal(generator, (d, v), d ** -0.5, dtype, device),
            "final_norm": torch.ones(d, dtype=dtype, device=device)}


def _init_block(generator, cfg, dtype, device) -> Layer:
    """One attention (GQA or MLA) + SwiGLU or MoE block with the
    reference's distributions."""
    d, f = cfg.d_model, cfg.d_ff
    ones = torch.ones(d, dtype=dtype, device=device)
    if cfg.attention == "mla":
        attn = init_mla_params(generator, cfg, dtype, device)
    else:
        attn = init_gqa_params(generator, cfg, dtype, device)
    parts = {"attn_norm": ones, "mlp_norm": ones.clone(), "attn": attn}
    if cfg.is_moe:
        parts["moe"] = init_moe_params(generator, cfg, dtype, device)
    else:
        parts["mlp"] = {"w1": normal(generator, (d, f), d ** -0.5, dtype,
                                      device),
                        "w3": normal(generator, (d, f), d ** -0.5, dtype,
                                      device),
                        "w2": normal(generator, (f, d), f ** -0.5, dtype,
                                      device)}
    return Layer(**parts)


def _logits(params: DecoderLM, h: torch.Tensor, cfg) -> torch.Tensor:
    return dense(rmsnorm(h, params.final_norm, cfg.norm_eps), params.lm_head)


def _remat(cfg, block: Callable, *args):
    """``block(*args)``; while autograd records and ``cfg.remat`` is set,
    through ``torch.utils.checkpoint`` (the reference's ``_maybe_remat``):
    the block's activations are dropped after the forward and recomputed,
    its kernels included, in the backward."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def _lm_loss(forward: Callable) -> Callable:
    def loss(params: DecoderLM, tokens: torch.Tensor, labels: torch.Tensor,
             extra=None, *, use_kernel: bool = True) -> torch.Tensor:
        """Mean next-token NLL of labels (B, S) under the log-softmax of the
        logits cast to float32, plus 0.01 x the MoE aux loss; a VLM's
        patch positions are dropped (the reference's ``_lm_loss``; its
        encoder-decoder loss adds no aux, and the port's aux is 0 there)."""
        logits, aux = forward(params, tokens, extra, use_kernel=use_kernel)
        logits = logits[:, -labels.shape[1]:]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
        return nll.mean() + 0.01 * aux
    return loss


def _no_extra(cfg, extra) -> None:
    if extra is not None:
        raise ValueError(f"{cfg.name}: the {cfg.family} family takes no "
                         "extra input (patch or frame embeddings)")


def _embed_tokens(params: DecoderLM, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, S, D), split by batch under a mesh."""
    return constrain(shp.embedding(tokens, params.embed), "batch", None,
                     None)


def _embed(params: DecoderLM, cfg, tokens: torch.Tensor, extra):
    """Token embeddings (B, S, D); a VLM's patch embeddings ``extra``
    (B, n_patches, D), cast to their type, go in front."""
    if extra is None:
        return _embed_tokens(params, tokens)
    h = _embed_tokens(params, tokens)
    if cfg.family != "vlm":
        _no_extra(cfg, extra)
    return constrain(torch.cat([extra.to(h.dtype), h], dim=1), "batch", None,
                     None)


def _placed(cfg, cache: dict) -> dict:
    """A new cache placed by ``cache_shardings`` under a mesh over a
    process group (batch over the data axes, KV heads or SSM heads over
    "model"); as it is elsewhere."""
    mesh = shp.active_mesh()
    if getattr(mesh, "device_mesh", None) is None:
        return cache
    return shp.place_cache(cache, shp.cache_shardings(cache, cfg, mesh))


def _ring_scatter(cache: dict, layer: int, entries: dict,
                  positions: torch.Tensor) -> None:
    """Write the prompt's cache entries (B, S, ...), keyed by absolute
    positions (S,), into slots ``positions mod W`` of cache layer ``layer``
    and the position table, in place; of S > W positions the last W are
    kept.  An int8 cache quantises the whole ring of k and v after the
    scatter, as the reference does (empty slots: value 0, scale 1e-8).
    The reference builds a new ring instead."""
    w = cache["pos"].shape[0]
    kept = positions[-w:]
    slots = kept.long() % w
    at = (slice(None), slots)
    for name, x in entries.items():
        x = x[:, -w:]
        if name + "_scale" in cache:
            # quantised one vector at a time: the empty ring's, then the
            # entries' into their slots
            empty = quantize_kv(torch.zeros((x.shape[0], w, *x.shape[2:]),
                                            dtype=x.dtype, device=x.device))
            for key, part in zip((name, name + "_scale"), empty):
                shp.write_cache(cache, key, layer, part)
            x, scale = quantize_kv(x)
            shp.write_cache(cache, name + "_scale", layer, scale, at)
        shp.write_cache(cache, name, layer, x, at)
    shp.local_tensor(cache["pos"])[slots] = kept


def _attn_prefill(cfg, attn, hn: torch.Tensor, cache: dict, layer: int,
                  positions: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """Full-sequence attention block (B, S, D) → (B, S, D) at positions
    0 .. S-1, through the flash-attention kernel (or the reference's math
    with ``use_kernel=False``); writes its keys and values into ring layer
    ``layer`` of the cache."""
    q, k, v = gqa_project_qkv(attn, hn, cfg, positions)
    out = attention_full(q, k, v, positions, cfg.sliding_window,
                         cfg.d_head ** -0.5, use_kernel=use_kernel)
    _ring_scatter(cache, layer, {"k": k, "v": v}, positions)
    return dense(shp.merge_heads(out), attn["wo"])


def _advance_ring(cache: dict) -> int:
    """Mark slot t mod W as position t on the device (no host copy) and
    return the slot."""
    t = cache["t"]
    slot = ring_slot(t, cache["pos"].shape[0])
    shp.local_tensor(cache["pos"])[slot].fill_(t)
    return slot


def _write_kv(cache: dict, name: str, layer: int, slot: int,
              x: torch.Tensor) -> torch.Tensor:
    """Write the new token's keys or values x (B, 1, KH, hd) into ``slot``
    of ring layer ``layer`` in place and return the layer as attention
    reads it: the layer itself, or for an int8 cache x quantised into the
    slot and the whole layer dequantised to x's type (the reference's
    ``_attn_decode_gqa_q8``)."""
    at = (slice(None), slice(slot, slot + 1))
    if name + "_scale" not in cache:
        shp.write_cache(cache, name, layer, x, at)
        return cache[name][layer]
    q, scale = quantize_kv(x)
    shp.write_cache(cache, name, layer, q, at)
    shp.write_cache(cache, name + "_scale", layer, scale, at)
    return dequantize_kv(cache[name][layer], cache[name + "_scale"][layer],
                         x.dtype)


def _attn_decode(cfg, attn, hn: torch.Tensor, cache: dict, layer: int,
                 slot: int, use_kernel: bool) -> torch.Tensor:
    """Single-token GQA/SWA attention block (B, 1, D) → (B, 1, D) against
    ring layer ``layer``: writes the new key and value into ``slot`` in
    place, then attends through the decode-attention kernel (or the
    reference's masked ``attention_core`` with ``use_kernel=False``).  The
    counterpart of the reference's ``_attn_decode_gqa`` and
    ``_attn_decode_gqa_q8``."""
    b = hn.shape[0]
    pos_arr = torch.full((b, 1), cache["t"], dtype=torch.int32,
                         device=hn.device)
    q, k_new, v_new = gqa_project_qkv(attn, hn, cfg, pos_arr)
    k_l = _write_kv(cache, "k", layer, slot, k_new)
    v_l = _write_kv(cache, "v", layer, slot, v_new)
    out = _decode_core(q, k_l, v_l, cache["pos"], cfg.d_head ** -0.5,
                       use_kernel)
    return dense(shp.merge_heads(out), attn["wo"])


def _decode_core(q, k_l, v_l, pos: torch.Tensor, scale: float,
                 use_kernel: bool) -> torch.Tensor:
    """One query token against a cache layer where ``pos >= 0``: the
    decode-attention kernel (on each rank's local heads under a mesh), or
    the reference's ``attention_core``."""
    if use_kernel:
        bat, mod = shp.split_elems(shp.active_mesh(), q.shape[0], q.shape[2],
                                   k_l.shape[2])
        heads = (bat, None, mod, None)
        return shp.local_call(
            lambda q, k, v, pos: ops.decode_attention(q, k, v, pos,
                                                      scale=scale),
            (q, k_l, v_l, pos), (heads, heads, heads, (None,)), heads)
    return attention_core(q, k_l, v_l, (pos >= 0)[None, :], scale)


def _mla_decode(cfg, attn, hn: torch.Tensor, cache: dict, layer: int,
                slot: int) -> torch.Tensor:
    """Single-token MLA block: the new token's latents go into ``slot`` of
    the latent ring first, then the absorbed attention reads the ring (no
    kernel of ours)."""
    b = hn.shape[0]
    pos_arr = torch.full((b, 1), cache["t"], dtype=torch.int32,
                         device=hn.device)
    c_q, c_kv, k_rope = mla_latents(attn, hn, cfg, pos_arr)
    for name, x in (("ckv", c_kv), ("krope", k_rope)):
        shp.write_cache(cache, name, layer, x,
                        (slice(None), slice(slot, slot + 1)))
    ckv_l, kr_l = cache["ckv"][layer], cache["krope"][layer]
    return mla_decode_absorbed(attn, c_q, cfg, ckv_l, kr_l,
                               cache["pos"] >= 0, pos_arr)


def _ffn(cfg, layer: Layer, hn: torch.Tensor):
    """The block's MLP or MoE: (output, MoE aux loss or None)."""
    if cfg.is_moe:
        return moe_layer(layer.moe, hn, cfg)
    return swiglu_mlp(layer.mlp, hn), None


def make_decoder_lm(cfg: ArchConfig) -> ModelApi:
    """Dense, MoE and VLM decoders, with GQA or MLA attention and a plain or
    int8 KV cache."""
    eps = cfg.norm_eps
    mla = cfg.attention == "mla"

    def init_params(generator: torch.Generator, dtype=torch.float32,
                    device=None) -> DecoderLM:
        """Random weights from ``generator`` (a generator on ``device``)
        with the reference's distributions (MoE routers float32)."""
        dev = resolve_device(device)
        emb = _init_embed(generator, cfg, dtype, dev)
        layers = [_init_block(generator, cfg, dtype, dev)
                  for _ in range(cfg.n_layers)]
        return DecoderLM(emb["embed"], emb["lm_head"], emb["final_norm"],
                         layers)

    def block(layer: Layer, h: torch.Tensor, positions: torch.Tensor,
              use_kernel: bool):
        hn = rmsnorm(h, layer.attn_norm, eps)
        if mla:
            h = h + mla_prefill(layer.attn, hn, cfg, positions,
                                use_kernel=use_kernel)[0]
        else:
            h = h + gqa_attention(layer.attn, hn, cfg, positions,
                                  use_kernel=use_kernel)
        out, aux = _ffn(cfg, layer, rmsnorm(h, layer.mlp_norm, eps))
        return constrain(h + out, "batch", None, None), aux

    def forward(params: DecoderLM, tokens: torch.Tensor, extra=None, *,
                use_kernel: bool = True):
        """tokens (B, S) (after a VLM's patches ``extra``) → logits
        (B, n_patches + S, V) and the auxiliary loss, the sum of the MoE
        layers' load-balancing losses (0 without experts)."""
        h = _embed(params, cfg, tokens, extra)
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        auxs = []
        for layer in params.layers:
            h, aux = _remat(cfg, block, layer, h, positions, use_kernel)
            if aux is not None:
                auxs.append(aux)
        aux = torch.stack(auxs).sum() if auxs else \
            torch.zeros((), dtype=torch.float32, device=h.device)
        return _logits(params, h, cfg), aux

    def init_cache(batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        w, dev = cache_window(cfg, max_len), resolve_device(device)
        if mla:
            return init_mla_cache(cfg, cfg.n_layers, batch, w, dtype, dev)
        return init_kv_cache(cfg, cfg.n_layers, batch, w, dtype, dev)

    def prefill(params: DecoderLM, tokens: torch.Tensor, max_len: int,
                extra=None, *, use_kernel: bool = True):
        """Run the prompt tokens (B, S), after a VLM's patches; returns a
        cache of ring size ``cache_window(cfg, max_len)`` in the parameters'
        type holding the prompt's keys and values (or MLA latents), and the
        last position's logits (B, 1, V)."""
        with tracing.span("prefill"):
            h = _embed(params, cfg, tokens, extra)
            b, s = h.shape[:2]
            positions = torch.arange(s, dtype=torch.int32, device=h.device)
            cache = _placed(cfg, init_cache(b, max_len, h.dtype, h.device))
            for i, layer in enumerate(params.layers):
                hn = rmsnorm(h, layer.attn_norm, eps)
                if mla:
                    out, c_kv, k_rope = mla_prefill(layer.attn, hn, cfg,
                                                    positions,
                                                    use_kernel=use_kernel)
                    _ring_scatter(cache, i, {"ckv": c_kv, "krope": k_rope},
                                  positions)
                else:
                    out = _attn_prefill(cfg, layer.attn, hn, cache, i,
                                        positions, use_kernel)
                h = h + out
                h = h + _ffn(cfg, layer,
                             rmsnorm(h, layer.mlp_norm, eps))[0]
            cache["t"] = s
            return cache, _logits(params, h[:, -1:], cfg)

    def decode_step(params: DecoderLM, cache: dict, tokens: torch.Tensor, *,
                    use_kernel: bool = True):
        """One new token (B, 1) for every sequence against the standing
        cache; writes its keys and values (or latents) into slot t mod W of
        every layer in place.  Returns logits (B, 1, V) and the cache.  MLA
        runs no kernel (``use_kernel`` is taken for a uniform API)."""
        slot = _advance_ring(cache)
        h = _embed_tokens(params, tokens)
        for i, layer in enumerate(params.layers):
            hn = rmsnorm(h, layer.attn_norm, eps)
            if mla:
                h = h + _mla_decode(cfg, layer.attn, hn, cache, i, slot)
            else:
                h = h + _attn_decode(cfg, layer.attn, hn, cache, i, slot,
                                     use_kernel)
            h = h + _ffn(cfg, layer, rmsnorm(h, layer.mlp_norm, eps))[0]
        cache["t"] += 1
        return _logits(params, h, cfg), cache

    return ModelApi(cfg, init_params, forward, _lm_loss(forward), init_cache,
                    prefill, decode_step)


def _init_mamba_layers(generator, cfg, n: int, dtype, device) -> list:
    """``n`` Mamba-2 layers drawn in float32 and cast, every leaf (A_log, D
    and dt_bias included), to ``dtype``, as the reference's ``_cast``."""
    layers = []
    for _ in range(n):
        ssm = init_ssm_params(generator, cfg, torch.float32, device)
        layers.append(Layer(
            norm=torch.ones(cfg.d_model, dtype=dtype, device=device),
            ssm={k: x.to(dtype) for k, x in ssm.items()}))
    return layers


def _mamba_prefill(cfg, layer: Layer, h: torch.Tensor, cache: dict,
                   index: tuple, use_kernel: bool) -> torch.Tensor:
    """One Mamba-2 block over the prompt; its final state and conv carry
    land in cache entry ``index`` of ``state`` and ``conv``."""
    out, carry = ssm_forward(layer.ssm, rmsnorm(h, layer.norm, cfg.norm_eps),
                             cfg, use_kernel=use_kernel)
    for name in ("state", "conv"):
        shp.write_cache(cache, name, index, carry[name])
    return h + out


def _mamba_decode(cfg, layer: Layer, h: torch.Tensor, cache: dict,
                  index: tuple) -> torch.Tensor:
    """One Mamba-2 block for one token, advancing cache entry ``index`` in
    place.  Under a mesh over a process group each rank steps its batch
    shard on the layout the reference's specs give, which the step reads
    from its shards' shapes: ``in_proj`` column-parallel and ``out_proj``
    row-parallel over "model", the state split by heads where "model"
    divides them (else whole, every rank stepping every head), the conv
    carry whole; only activations move, and each rank keeps its shard of
    the new carry."""
    if not shp.is_distributed(cache["state"]):
        out, _ = ssm_decode_step(layer.ssm,
                                 rmsnorm(h, layer.norm, cfg.norm_eps), cfg,
                                 {"state": cache["state"][index],
                                  "conv": cache["conv"][index]})
        return h + out
    names = list(layer.ssm.keys())
    mesh = shp.active_mesh()
    bat, _ = shp.split_elems(mesh, h.shape[0])

    def over_model(n: int):
        return shp.split_elems(mesh, 1, n)[1]
    cols = over_model(layer.ssm["in_proj"].shape[-1])
    heads = over_model(cfg.ssm_nheads)
    rows = over_model(cfg.d_inner)
    group = (mesh.device_mesh.get_group(shp.MODEL_AXIS) if cols or rows
             else None)
    specs = {"in_proj": (None, cols), "out_proj": (rows, None)}

    def step(h, state, conv, norm, *weights):
        carry = {"state": state.clone(), "conv": conv.clone()}
        out, _ = ssm_decode_step(dict(zip(names, weights)),
                                 rmsnorm(h, norm, cfg.norm_eps), cfg, carry,
                                 group)
        return h + out, carry["state"], carry["conv"]

    weights = [layer.ssm[n] for n in names]
    carried = (cache["state"][index], cache["conv"][index])
    state_spec = (bat, heads, None, None)
    h, *new = shp.local_call(
        step, (h, *carried, layer.norm, *weights),
        ((bat, None, None), state_spec, (bat, None, None), (None,),
         *(specs.get(n, (None,) * w.dim()) for n, w in zip(names, weights))),
        ((bat, None, None), state_spec, (bat, None, None)))
    for name, x in zip(("state", "conv"), new):
        shp.write_cache(cache, name, index, x)
    return h


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

    def block(layer: Layer, h: torch.Tensor, use_kernel: bool):
        out, _ = ssm_forward(layer.ssm, rmsnorm(h, layer.norm, cfg.norm_eps),
                             cfg, use_kernel=use_kernel)
        return h + out

    def forward(params: DecoderLM, tokens: torch.Tensor, extra=None, *,
                use_kernel: bool = True):
        _no_extra(cfg, extra)
        h = _embed_tokens(params, tokens)
        for layer in params.layers:
            h = _remat(cfg, block, layer, h, use_kernel)
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
        with tracing.span("prefill"):
            _no_extra(cfg, extra)
            h = _embed_tokens(params, tokens)
            cache = _placed(cfg, init_cache(tokens.shape[0], max_len,
                                            device=h.device))
            for i, layer in enumerate(params.layers):
                h = _mamba_prefill(cfg, layer, h, cache, (i,), use_kernel)
            cache["t"] = tokens.shape[1]
            return cache, _logits(params, h[:, -1:], cfg)

    def decode_step(params: DecoderLM, cache: dict, tokens: torch.Tensor, *,
                    use_kernel: bool = True):
        """One new token (B, 1) per sequence; advances every layer's state
        and conv carry in place.  No kernel runs here (``use_kernel`` is
        taken for a uniform API)."""
        h = _embed_tokens(params, tokens)
        for i, layer in enumerate(params.layers):
            h = _mamba_decode(cfg, layer, h, cache, (i,))
        cache["t"] += 1
        return _logits(params, h, cfg), cache

    return ModelApi(cfg, init_params, forward, _lm_loss(forward), init_cache,
                    prefill, decode_step)


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

    def super_block(params: DecoderLM, s: int, h: torch.Tensor,
                    positions: torch.Tensor, use_kernel: bool):
        """Super-block ``s``: its Mamba-2 layers, then the shared block."""
        for layer in _mamba(params, s):
            out, _ = ssm_forward(layer.ssm, rmsnorm(h, layer.norm, eps), cfg,
                                 use_kernel=use_kernel)
            h = h + out
        sh = params.shared
        h = h + gqa_attention(sh.attn, rmsnorm(h, sh.attn_norm, eps), cfg,
                              positions, use_kernel=use_kernel)
        return h + swiglu_mlp(sh.mlp, rmsnorm(h, sh.mlp_norm, eps))

    def forward(params: DecoderLM, tokens: torch.Tensor, extra=None, *,
                use_kernel: bool = True):
        _no_extra(cfg, extra)
        h = _embed_tokens(params, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=h.device)
        for s in range(n_super):
            h = _remat(cfg, super_block, params, s, h, positions, use_kernel)
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
        with tracing.span("prefill"):
            _no_extra(cfg, extra)
            h = _embed_tokens(params, tokens)
            b, s_len = tokens.shape
            positions = torch.arange(s_len, dtype=torch.int32,
                                     device=h.device)
            cache = _placed(cfg, init_cache(b, max_len, h.dtype, h.device))
            sh = params.shared
            for s in range(n_super):
                for j, layer in enumerate(_mamba(params, s)):
                    h = _mamba_prefill(cfg, layer, h, cache, (s, j),
                                       use_kernel)
                h = h + _attn_prefill(cfg, sh.attn,
                                      rmsnorm(h, sh.attn_norm, eps),
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
        h = _embed_tokens(params, tokens)
        sh = params.shared
        for s in range(n_super):
            for j, layer in enumerate(_mamba(params, s)):
                h = _mamba_decode(cfg, layer, h, cache, (s, j))
            h = h + _attn_decode(cfg, sh.attn, rmsnorm(h, sh.attn_norm, eps),
                                 cache, s, slot, use_kernel)
            h = h + swiglu_mlp(sh.mlp, rmsnorm(h, sh.mlp_norm, eps))
        cache["t"] += 1
        return _logits(params, h, cfg), cache

    return ModelApi(cfg, init_params, forward, _lm_loss(forward), init_cache,
                    prefill, decode_step)


def _init_encdec_layer(generator, cfg, dtype, device, cross: bool) -> Layer:
    """An encoder block (``cross=False``) or a decoder block with cross
    attention, drawn in float32 and cast to ``dtype`` (every leaf, as the
    reference's ``_cast``)."""
    d, f = cfg.d_model, cfg.d_ff
    f32 = torch.float32

    def norm(prefix):
        return {f"{prefix}_w": torch.ones(d, device=device),
                f"{prefix}_b": torch.zeros(d, device=device)}

    parts = {**norm("norm1"),
             "attn": init_gqa_params(generator, cfg, f32, device),
             **norm("norm2"),
             "mlp": {"w1": normal(generator, (d, f), d ** -0.5, f32, device),
                     "b1": torch.zeros(f, device=device),
                     "w2": normal(generator, (f, d), f ** -0.5, f32, device),
                     "b2": torch.zeros(d, device=device)}}
    if cross:
        parts["xattn"] = init_gqa_params(generator, cfg, f32, device)
        parts.update(norm("norm3"))
    return Layer(**{n: {k: a.to(dtype) for k, a in x.items()}
                    if isinstance(x, dict) else x.to(dtype)
                    for n, x in parts.items()})


def make_encdec_lm(cfg: ArchConfig) -> ModelApi:
    """whisper: ``n_encoder_layers`` pre-norm (LayerNorm) encoder blocks of
    non-causal self-attention over the frame embeddings ``extra``
    (B, T, D), with rope as the reference's ``gqa_project_qkv`` applies it
    there too, and a GELU MLP; then ``n_layers`` decoder blocks of causal
    self-attention, cross attention to the encoder's output (queries
    without rope) and a GELU MLP.  The frames are cast to the parameters'
    type (the reference takes them as given, and a float32 frame would run
    its bf16 encoder in float32 by type promotion).  The cache keeps each
    decoder layer's cross keys and values (``enc_k``, ``enc_v``
    (L, B, T, KH, hd)) beside the self-attention ring, and ``enc_pos``, a
    position table with every one of the T slots valid, so that a decode
    step's cross attention runs through the decode-attention kernel."""
    eps = cfg.norm_eps
    scale = cfg.d_head ** -0.5

    def init_params(generator: torch.Generator, dtype=torch.float32,
                    device=None) -> DecoderLM:
        dev = resolve_device(device)
        emb = _init_embed(generator, cfg, dtype, dev)
        enc = [_init_encdec_layer(generator, cfg, dtype, dev, cross=False)
               for _ in range(cfg.n_encoder_layers)]
        dec = [_init_encdec_layer(generator, cfg, dtype, dev, cross=True)
               for _ in range(cfg.n_layers)]
        return DecoderLM(emb["embed"], emb["lm_head"], emb["final_norm"],
                         dec, enc_layers=enc)

    def _frames(params: DecoderLM, extra):
        if extra is None:
            raise ValueError(f"{cfg.name}: the encoder-decoder needs its "
                             "frame embeddings as extra (B, T, D)")
        return extra.to(params.embed.dtype)

    def enc_block(layer: Layer, h: torch.Tensor, positions: torch.Tensor,
                  use_kernel: bool):
        hn = layernorm(h, layer.norm1_w, layer.norm1_b, eps)
        q, k, v = gqa_project_qkv(layer.attn, hn, cfg, positions)
        out = attention_full(q, k, v, positions, 0, scale, causal=False,
                             use_kernel=use_kernel)
        h = h + dense(shp.merge_heads(out), layer.attn["wo"])
        hn = layernorm(h, layer.norm2_w, layer.norm2_b, eps)
        return h + gelu_mlp(layer.mlp, hn)

    def encode(params: DecoderLM, frames: torch.Tensor, use_kernel=True):
        """The encoder over frames (B, T, D) → (B, T, D)."""
        h = constrain(frames, "batch", None, None)
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        for layer in params.enc_layers:
            h = _remat(cfg, enc_block, layer, h, positions, use_kernel)
        return h

    def _cross_kv(layer: Layer, enc_h: torch.Tensor):
        p = layer.xattn
        return tuple(shp.split_heads(dense(enc_h, p["w" + n], p.get("b" + n)),
                                     cfg.n_kv_heads, cfg.d_head)
                     for n in "kv")

    def _cross_q(layer: Layer, hn: torch.Tensor) -> torch.Tensor:
        p = layer.xattn
        return shp.split_heads(dense(hn, p["wq"], p.get("bq")), cfg.n_heads,
                               cfg.d_head)

    def _cross_out(layer: Layer, out: torch.Tensor) -> torch.Tensor:
        return dense(shp.merge_heads(out), layer.xattn["wo"])

    def _cross_full(layer, hn, enc_k, enc_v, use_kernel=True):
        """Every query of hn (B, S, D) over every encoder frame: flash
        attention, non-causal, S != T."""
        out = attention_full(_cross_q(layer, hn), enc_k, enc_v, None, 0,
                             scale, causal=False, use_kernel=use_kernel)
        return _cross_out(layer, out)

    def dec_block(layer: Layer, h: torch.Tensor, positions: torch.Tensor,
                  enc_h: torch.Tensor, use_kernel: bool):
        hn = layernorm(h, layer.norm1_w, layer.norm1_b, eps)
        h = h + gqa_attention(layer.attn, hn, cfg, positions,
                              use_kernel=use_kernel)
        hn = layernorm(h, layer.norm3_w, layer.norm3_b, eps)
        h = h + _cross_full(layer, hn, *_cross_kv(layer, enc_h), use_kernel)
        hn = layernorm(h, layer.norm2_w, layer.norm2_b, eps)
        return h + gelu_mlp(layer.mlp, hn)

    def forward(params: DecoderLM, tokens: torch.Tensor, extra=None, *,
                use_kernel: bool = True):
        """tokens: decoder ids (B, S); extra: frame embeddings (B, T, D)."""
        enc_h = encode(params, _frames(params, extra), use_kernel)
        h = _embed_tokens(params, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=h.device)
        for layer in params.layers:
            h = _remat(cfg, dec_block, layer, h, positions, enc_h, use_kernel)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return _logits(params, h, cfg), aux

    def _cache(batch, max_len, dtype, device, enc_len):
        cache = init_kv_cache(cfg, cfg.n_layers, batch,
                              cache_window(cfg, max_len), dtype, device,
                              quant=False)
        shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.d_head)
        cache["enc_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["enc_v"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["enc_pos"] = torch.arange(enc_len, dtype=torch.int32,
                                        device=device)
        return cache

    def init_cache(batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        return _cache(batch, max_len, dtype, resolve_device(device),
                      cfg.encoder_seq)

    def prefill(params: DecoderLM, tokens: torch.Tensor, max_len: int,
                extra=None, *, use_kernel: bool = True):
        """Encode the frames ``extra`` (B, T, D), then run the decoder
        prompt (B, S): self-attention and cross attention through flash
        attention, the self keys and values into the ring, each layer's
        cross keys and values into ``enc_k``/``enc_v``.  Returns the cache
        and the last logits (B, 1, V)."""
        enc_h = encode(params, _frames(params, extra), use_kernel)
        h = _embed_tokens(params, tokens)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=h.device)
        cache = _placed(cfg, _cache(b, max_len, h.dtype, h.device,
                                    enc_h.shape[1]))
        for i, layer in enumerate(params.layers):
            hn = layernorm(h, layer.norm1_w, layer.norm1_b, eps)
            h = h + _attn_prefill(cfg, layer.attn, hn, cache, i, positions,
                                  use_kernel)
            hn = layernorm(h, layer.norm3_w, layer.norm3_b, eps)
            enc_k, enc_v = _cross_kv(layer, enc_h)
            for name, x in (("enc_k", enc_k), ("enc_v", enc_v)):
                shp.write_cache(cache, name, i, x)
            h = h + _cross_full(layer, hn, enc_k, enc_v, use_kernel)
            hn = layernorm(h, layer.norm2_w, layer.norm2_b, eps)
            h = h + gelu_mlp(layer.mlp, hn)
        cache["t"] = s
        return cache, _logits(params, h[:, -1:], cfg)

    def decode_step(params: DecoderLM, cache: dict, tokens: torch.Tensor, *,
                    use_kernel: bool = True):
        """One new token (B, 1) per sequence: self-attention through the
        decode-attention kernel on the ring (slot t mod W written in
        place), cross attention through it on the layer's ``enc_k``/
        ``enc_v`` with every slot valid.  Two launches a layer."""
        slot = _advance_ring(cache)
        h = _embed_tokens(params, tokens)
        for i, layer in enumerate(params.layers):
            hn = layernorm(h, layer.norm1_w, layer.norm1_b, eps)
            h = h + _attn_decode(cfg, layer.attn, hn, cache, i, slot,
                                 use_kernel)
            hn = layernorm(h, layer.norm3_w, layer.norm3_b, eps)
            out = _decode_core(_cross_q(layer, hn), cache["enc_k"][i],
                               cache["enc_v"][i], cache["enc_pos"], scale,
                               use_kernel)
            h = h + _cross_out(layer, out)
            hn = layernorm(h, layer.norm2_w, layer.norm2_b, eps)
            h = h + gelu_mlp(layer.mlp, hn)
        cache["t"] += 1
        return _logits(params, h, cfg), cache

    return ModelApi(cfg, init_params, forward, _lm_loss(forward), init_cache,
                    prefill, decode_step)


_FAMILIES = {"dense": make_decoder_lm, "moe": make_decoder_lm,
             "vlm": make_decoder_lm, "ssm": make_ssm_lm,
             "hybrid": make_hybrid_lm, "encdec": make_encdec_lm}


def lm_from_numpy(cfg: ArchConfig, params: dict, dtype=torch.float32,
                  device=None) -> DecoderLM:
    """The reference's parameter pytree, as numpy arrays with the layers
    stacked on leading axes (``jax.tree.map(np.asarray, params)``), as the
    port's ``DecoderLM`` in ``dtype`` on ``device`` (MoE routers stay
    float32): ``layers`` (L, ...) for the dense, MoE, VLM and SSM families
    (MLA's wdq, wuq, wdkv, wkr, wuk, wuv, wo, q_norm, kv_norm under
    ``attn``; ``moe`` with ``router`` and ``experts`` w1, w3, w2 stacked
    (E, ...)); ``mamba`` (n_super, attn_every, ...) and ``shared`` for the
    hybrid family; ``enc_layers`` and ``dec_layers`` for the
    encoder-decoder."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    dev = resolve_device(device)

    def tensor(a, dt=dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dt)

    def layer(tree: dict, i) -> Layer:
        parts = {}
        for name, a in tree.items():
            if name == "moe":
                parts[name] = MoE(tensor(a["router"][i], torch.float32),
                                  {n: tensor(x[i])
                                   for n, x in a["experts"].items()})
            elif isinstance(a, dict):
                parts[name] = {n: tensor(x[i]) for n, x in a.items()}
            else:
                parts[name] = tensor(a[i])
        return Layer(**parts)

    shared = enc = None
    if cfg.family == "hybrid":
        stack = params["mamba"]
        n_super, inner = stack["norm"].shape[:2]
        layers = [layer(stack, (s, j))
                  for s in range(n_super) for j in range(inner)]
        shared = layer(params["shared"], ...)
    elif cfg.family == "encdec":
        enc = [layer(params["enc_layers"], i)
               for i in range(cfg.n_encoder_layers)]
        layers = [layer(params["dec_layers"], i) for i in range(cfg.n_layers)]
    else:
        layers = [layer(params["layers"], i) for i in range(cfg.n_layers)]
    return DecoderLM(tensor(params["embed"]), tensor(params["lm_head"]),
                     tensor(params["final_norm"]), layers, shared, enc)


def make_trainable(params: DecoderLM) -> DecoderLM:
    """Turn every parameter on for gradients, in place, the MoE routers
    made float32 parameters (serving holds them as frozen buffers).
    Returns ``params``."""
    for module in params.modules():
        if isinstance(module, MoE):
            module.make_trainable()
    for p in params.parameters():
        p.requires_grad_(True)
    return params


# the reference's name of each stack of layers, by family
_STACKS = {"hybrid": {"layers": "mamba"}, "encdec": {"layers": "dec_layers"}}


def _stack_name(cfg, name: str) -> str:
    return _STACKS.get(cfg.family, {}).get(name, name)


def ref_path(cfg: ArchConfig, name: str) -> tuple:
    """A port parameter's path in the reference's pytree: a layer's
    parameter under its stack's name, without the layer's index
    (``layers.3.attn.wq`` → ("layers", "attn", "wq"); ("mamba", ...) for
    the hybrid family, ("dec_layers", ...) for the encoder-decoder), any
    other name split at its dots."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc_layers"):
        return (_stack_name(cfg, parts[0]), *parts[2:])
    return tuple(parts)


def lm_tree(cfg: ArchConfig, named: Mapping[str, torch.Tensor]) -> dict:
    """Tensors by the port's parameter names (``named_parameters()``, or
    an optimizer state's dict of the same names) as the reference's
    parameter pytree: nested dicts under the reference's names, each stack
    of layers stacked on a leading axis ((n_super, attn_every, ...) for the
    hybrid's ``mamba``).  The inverse of ``lm_untree``."""
    tree: dict = {}
    stacks: dict[tuple, list] = {}
    for name, t in named.items():
        path = ref_path(cfg, name)
        if name.startswith(("layers.", "enc_layers.")):
            stacks.setdefault(path, []).append((int(name.split(".")[1]), t))
        else:
            _put(tree, path, t)
    for path, items in stacks.items():
        stacked = torch.stack([t for _, t in sorted(items,
                                                    key=lambda it: it[0])])
        if path[0] == "mamba":
            stacked = stacked.reshape(cfg.n_layers // cfg.attn_every,
                                      cfg.attn_every, *stacked.shape[1:])
        _put(tree, path, stacked)
    return tree


def _put(tree: dict, path: tuple, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def lm_untree(cfg: ArchConfig, tree: Mapping) -> dict:
    """The reference's parameter pytree (leaves numpy arrays or tensors)
    as leaves by the port's parameter names, each stacked leaf split into
    its layers (views).  The inverse of ``lm_tree``."""
    inverse = {ref: port for port, ref in _STACKS.get(cfg.family, {}).items()}
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, (*path, key))
            return
        top = path[0]
        if top in ("layers", "mamba", "dec_layers", "enc_layers"):
            if top == "mamba":
                node = node.reshape(-1, *node.shape[2:])
            port = inverse.get(top, top)
            for i in range(node.shape[0]):
                out[".".join((port, str(i), *path[1:]))] = node[i]
        else:
            out[".".join(path)] = node

    walk(tree, ())
    return out


def adamw_from_numpy(cfg: ArchConfig, state, device=None) -> AdamWState:
    """The reference's ``AdamWState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) as the port's, on ``device``:
    the step as an int32 scalar, master, m and v float32 by parameter
    name."""
    dev = resolve_device(device)

    def tensors(tree) -> dict:
        return {n: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
                for n, a in lm_untree(cfg, tree).items()}

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    return AdamWState(step, tensors(state.master), tensors(state.m),
                      tensors(state.v))
