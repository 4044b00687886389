"""The steps: the train step (microbatched gradient accumulation and
AdamW), prefill and greedy decode.

Counterpart of ``repro/launch/steps.py`` (``make_train_step`` :19,
``make_prefill_step`` :75, ``make_decode_step`` :82).  ``grad_shardings``
places each float32 gradient by its parameter's sharding before it is
added up, where the reference pins it: on the one-card mesh every
sharding is replicated and the gradient passes through itself; under a
mesh over a process group it is redistributed (``launch.sharding``).
The steps run on a model placed by ``sharding.place_params`` under an
activated mesh as they run on one card: the parameters, the cache and
the tokens are DTensors there, and the accumulators and the optimizer's
moments are placed as the parameters are.
"""

from __future__ import annotations

import torch

from ..models.transformer import DecoderLM, ModelApi
from ..optim import adamw
from .sharding import constrain, sum_of_squares, with_sharding_constraint


def load_params(params: DecoderLM, new: dict) -> None:
    """Write tensors by parameter name into the model, in place; a tensor
    of another type (a float32 router after a bf16 step) replaces the
    parameter's data."""
    with torch.no_grad():
        for name, p in params.named_parameters():
            t = new[name]
            if t.dtype == p.dtype:
                p.copy_(t)
            else:
                p.data = t.detach().clone()


def make_train_step(api: ModelApi, n_micro: int, lr: float = 3e-4,
                    param_dtype=None, grad_shardings: dict | None = None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``, the reference's step.

    batch = {"tokens": (B, S), "labels": (B, S)[, "extra": (B, T, D)]} on
    the parameters' device; params a ``make_trainable`` model, updated in
    place with its AdamW state.  The batch is split into ``n_micro``
    microbatches along B; each one's gradient is cast to float32 and added
    up, the sum divided by ``n_micro`` (with bf16 parameters the
    gradients are bf16 before the cast, the reference's bf16 gradient
    path); the loss is the microbatches' mean and ``grad_norm`` the sqrt
    of the float32 sum of g·g over every leaf.  ``param_dtype`` casts the
    new parameters (None: they stay the master's float32).
    ``grad_shardings`` (parameter name → ``sharding.NamedSharding``, e.g.
    ``sharding.param_shardings``) places each microbatch's float32
    gradient by its parameter's sharding before it is added up."""
    def train_step(params: DecoderLM, opt_state: adamw.AdamWState,
                   batch: dict):
        tokens, labels = batch["tokens"], batch["labels"]
        extra = batch.get("extra")
        b = tokens.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             "microbatches")
        mb = b // n_micro
        named = dict(params.named_parameters())
        leaves = list(named.values())
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        losses = []
        for i in range(n_micro):
            part = slice(i * mb, (i + 1) * mb)

            def micro(x):
                # the whole batch as it is (a placed batch is not resliced)
                return x if x is None or mb == b else x[part]
            loss = api.loss(params, micro(tokens), micro(labels),
                            micro(extra))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for name, a, g in zip(named, acc, grads):
                if g is None:
                    continue
                g32 = g.float()
                if grad_shardings is not None:
                    g32 = with_sharding_constraint(g32, grad_shardings[name])
                a.add_(g32)
            losses.append(loss.detach())
        torch._foreach_div_(acc, n_micro)
        gnorm = torch.sqrt(torch.stack([sum_of_squares(g)
                                        for g in acc]).sum())
        new_params, opt_state = adamw.update(dict(zip(named, acc)), opt_state,
                                             lr=lr, param_dtype=param_dtype)
        load_params(params, new_params)
        return params, opt_state, {"loss": torch.stack(losses).mean(),
                                   "grad_norm": gnorm}
    return train_step


def make_prefill_step(api: ModelApi, max_len: int):
    def prefill_step(params, batch: dict):
        """batch {"tokens": (B, S)[, "extra"]} → (cache, last logits)."""
        return api.prefill(params, batch["tokens"], max_len,
                           batch.get("extra"))
    return prefill_step


def make_decode_step(api: ModelApi):
    def serve_step(params, cache: dict, tokens: torch.Tensor):
        """One new token for every sequence against the standing cache:
        returns the greedy next tokens (B, 1) int32 and the cache (updated
        in place)."""
        logits, cache = api.decode_step(params, cache, tokens)
        # under a mesh the vocabulary is gathered before the argmax
        logits = constrain(logits, "batch", None, None)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], cache
    return serve_step
