"""AdamW with float32 master weights, in PyTorch.

Counterpart of ``repro/optim/adamw.py`` (``init`` :26, ``update`` :41),
with its arithmetic in its order, one rounding per operation:

    m = b1·m + (1-b1)·g          v = b2·v + (1-b2)·g·g
    mhat = m / c1                vhat = v / c2      (c = 1 - b**t in float32)
    master = master - lr·(mhat / (sqrt(vhat) + eps) + wd·master)

on every trainable tensor (norms and biases decay too), by the parameter's
name.  ``torch.optim.AdamW`` orders the decay and eps differently, so it is
not used.  The model's parameters may be bf16: gradients are cast to
float32, the moments and the master stay float32, and the new parameters
are the master cast to ``param_dtype`` on every leaf, the MoE router
included (so a float32 router becomes bf16 after the first bf16 step, as
in the reference, ROADMAP C-R32).  The state is updated in place
(``torch._foreach_*``: one multi-tensor launch per operation on a card).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor                  # int32 scalar, steps taken
    master: dict[str, torch.Tensor]     # float32 copy of every parameter
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    """The state for ``params`` (name → tensor, e.g. ``dict(model.
    named_parameters())``): step 0, a float32 copy of each as the master,
    zero moments, on the parameters' device."""
    if not params:
        raise ValueError("adamw.init: no parameters")
    device = next(iter(params.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        master={n: p.detach().to(torch.float32, copy=True)
                for n, p in params.items()},
        m=zeros, v={n: z.clone() for n, z in zeros.items()})


def update(grads: Mapping[str, torch.Tensor], state: AdamWState, lr=3e-4,
           b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, param_dtype=None):
    """One AdamW step on ``grads`` (name → gradient, any float type, one for
    every name of the state).  Updates the state's tensors in place and
    returns (new params name → tensor, the state with its step advanced).
    The new params are the master itself when ``param_dtype`` is None,
    else fresh copies cast to it."""
    if set(grads) != set(state.master):
        raise ValueError("adamw.update: gradients and state name different "
                         f"parameters: {sorted(set(grads) ^ set(state.master))}")
    names = list(state.master)
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    g = [grads[n].float() for n in names]
    m = [state.m[n] for n in names]
    v = [state.v[n] for n in names]
    master = [state.master[n] for n in names]

    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - b2),
                                              g))
    del g
    upd = torch._foreach_div(m, c1)                       # mhat
    denom = torch._foreach_div(v, c2)                     # vhat
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(upd, denom)
    del denom
    torch._foreach_add_(upd, torch._foreach_mul(master, weight_decay))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(master, upd)

    new_state = AdamWState(step, state.master, state.m, state.v)
    if param_dtype is None:
        return dict(state.master), new_state
    return {n: p.to(param_dtype, copy=True)
            for n, p in state.master.items()}, new_state
