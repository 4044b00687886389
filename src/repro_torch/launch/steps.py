"""The steps: the train step (microbatched gradient accumulation and
AdamW), prefill and greedy decode.

Counterpart of ``repro/launch/steps.py`` (``make_train_step`` :19,
``make_prefill_step`` :75, ``make_decode_step`` :82).  ``grad_shardings``
pins each float32 gradient to its parameter's sharding before it is added
up, where the reference pins it; on one card every sharding is
replicated, so the pin passes the gradient through, and a sharding that
would split one raises (``launch.sharding``, ROADMAP A-11).
"""

from __future__ import annotations

import torch

from ..models.transformer import DecoderLM, ModelApi
from ..optim import adamw
from .sharding import with_sharding_constraint


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
    ``sharding.param_shardings``) pins each microbatch's float32 gradient
    to its parameter's layout before it is added up."""
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
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        losses = []
        for i in range(n_micro):
            part = slice(i * mb, (i + 1) * mb)
            loss = api.loss(params, tokens[part], labels[part],
                            None if extra is None else extra[part])
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
        gnorm = torch.sqrt(torch.stack([torch.vdot(g.reshape(-1),
                                                   g.reshape(-1))
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
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], cache
    return serve_step
