"""Shape-and-type specs for every (architecture x input-shape) cell.

Counterpart of ``repro/launch/specs.py``.  Nothing here allocates: where
the reference takes ``jax.eval_shape`` over its init functions, the port
builds the same objects on the ``meta`` device (tensors with a shape and
a type and no storage); inputs are empty meta tensors of the reference's
shapes and types.
"""

from __future__ import annotations

import torch

from ..configs import SHAPES, get_arch
from ..models.transformer import DecoderLM, ModelApi
from ..optim import adamw

PARAM_DTYPE = torch.bfloat16
CACHE_DTYPE = torch.bfloat16
META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """An empty meta tensor: the ``jax.ShapeDtypeStruct`` counterpart."""
    return torch.empty(shape, dtype=dtype, device=META)


def n_microbatches(cfg, shape_name: str) -> int:
    """Grad-accumulation depth for train cells: bounds per-microbatch logits
    (B/n · S · V/model_shard fp32) and MoE dispatch buffers."""
    if shape_name != "train_4k":
        return 1
    return 8


def _extra_spec(cfg, batch):
    if cfg.family == "vlm":
        return sds((batch, cfg.n_patches, cfg.d_model), PARAM_DTYPE)
    if cfg.family == "encdec":
        return sds((batch, cfg.encoder_seq, cfg.d_model), PARAM_DTYPE)
    return None


def input_specs(arch: str, shape: str) -> dict:
    """Model-input meta tensors for one cell (no params/cache)."""
    cfg = get_arch(arch)
    seq, gbatch, kind = SHAPES[shape]
    if kind == "train":
        batch = {"tokens": sds((gbatch, seq), torch.int32),
                 "labels": sds((gbatch, seq), torch.int32)}
        extra = _extra_spec(cfg, gbatch)
        if extra is not None:
            batch["extra"] = extra
        return batch
    if kind == "prefill":
        batch = {"tokens": sds((gbatch, seq), torch.int32)}
        extra = _extra_spec(cfg, gbatch)
        if extra is not None:
            batch["extra"] = extra
        return batch
    # decode: one new token against a seq-length cache
    return {"tokens": sds((gbatch, 1), torch.int32)}


def param_specs(api: ModelApi) -> DecoderLM:
    """The model's parameters in PARAM_DTYPE on meta (its MoE routers
    float32, as in the reference)."""
    return api.init_params(torch.Generator().manual_seed(0), PARAM_DTYPE,
                           META)


def opt_specs(params: DecoderLM) -> adamw.AdamWState:
    """The AdamW state of ``params`` on meta; the MoE routers, buffers while
    serving, take a slot as the reference's parameter pytree gives them."""
    return adamw.init(params.state_dict(keep_vars=True))


def cache_specs(api: ModelApi, arch: str, shape: str) -> dict:
    seq, gbatch, kind = SHAPES[shape]
    if kind != "decode":
        raise ValueError(f"{shape} is a {kind} cell: no cache")
    return api.init_cache(gbatch, seq, CACHE_DTYPE, META)
