"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [--full]``.

Counterpart of ``repro/launch/train.py`` (``train`` :29, ``main`` :88): config
→ model → an AdamW loop over the token pipeline, with remat
(``cfg.remat``), microbatched gradient accumulation, bf16 parameters with
a float32 master (``param_dtype``), and atomic, step-numbered
checkpoints with resume (parameters, AdamW state and step).  It prints the
reference's ``[train]`` lines.

It runs on the card unless the caller passes ``device="cpu"``
(``--device cpu``).  On the card every GQA attention block's forward runs
through the flash-attention kernel and every Mamba-2 block's through the
SSD-scan kernel, each with the gradient of the reference's math as its
backward (``kernels.autograd``).  By default the configuration is cut to
``reduced()``; ``--full`` (``smoke=False``) trains it at full size.
``mesh`` (``launch.mesh``) trains under a device mesh, as the reference
does: the mesh is activated for the model code, and the step is built
without ``grad_shardings`` (each gradient is placed as its parameter's
DTensor propagation leaves it, where the reference leaves it to the
partitioner).  On the one-card mesh the parameters live on its device
and the run is the same, bit for bit, as without a mesh.  On a mesh over
a process group (``mesh.make_process_mesh``, in every rank) the
parameters, drawn alike on every rank, are placed by
``sharding.param_shardings``; every rank draws the same token stream, as
the reference's single program does, and takes its data shard.  Its
checkpoints are the one-card files (``serving.checkpoint``: each sharded
leaf gathered whole, rank 0 writes), so either layout resumes the
other's.  As in the reference, the CLI has no mesh flag (its docstring
names one, ROADMAP C-R35).
"""

from __future__ import annotations

import argparse
import time
from contextlib import nullcontext

import torch

from ..configs import get_arch
from ..data import Prefetcher, SyntheticTokens
from ..device import resolve_device
from ..models.transformer import (get_model, lm_tree, lm_untree,
                                  make_trainable)
from ..optim import adamw
from ..serving import checkpoint
from . import sharding as shp
from .steps import load_params, make_train_step


def train_state(cfg, params, opt_state: adamw.AdamWState,
                param_dtype=None) -> dict:
    """What a checkpoint holds, in the reference's layout: {"params": the
    parameters' pytree, "opt": AdamWState(step, master, m, v) as pytrees}
    (``lm_tree``), so either package restores the other's float32
    checkpoints.  ``param_dtype`` casts the parameters as a training step
    leaves them (the MoE router too), to restore a checkpoint into."""
    named = {n: p.detach() if param_dtype is None else p.detach().to(
        param_dtype) for n, p in params.named_parameters()}
    return {"params": lm_tree(cfg, named),
            "opt": adamw.AdamWState(opt_state.step,
                                    *(lm_tree(cfg, d) for d in opt_state[1:]))}


def load_train_state(cfg, params, opt_state: adamw.AdamWState,
                     state: dict) -> adamw.AdamWState:
    """Write a restored ``train_state`` into the model (in place) and
    return the AdamW state it holds."""
    load_params(params, lm_untree(cfg, state["params"]))
    opt = state["opt"]
    return adamw.AdamWState(opt.step.to(opt_state.step.device),
                            *(lm_untree(cfg, d) for d in opt[1:]))


def _to_device(batch: dict, device: torch.device) -> dict:
    """The pipeline's numpy batch on the device: pinned host memory and a
    non-blocking copy on a card."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def _scalar(x: torch.Tensor) -> float:
    """A 0-d tensor's value; a DTensor's as the mesh holds it whole."""
    return float(x.full_tensor() if shp.is_distributed(x) else x)


def train(arch: str, steps: int = 50, batch_size: int = 8, seq_len: int = 64,
          smoke: bool = True, n_micro: int = 1, lr: float = 3e-4,
          ckpt_dir: str | None = None, ckpt_every: int = 20,
          resume: bool = False, param_dtype=torch.float32, mesh=None,
          log_every: int = 10, seed: int = 0, device=None):
    """Train ``arch`` for ``steps`` steps from random weights (a
    ``torch.Generator`` on the device, seeded by ``seed``) on the
    synthetic token stream of ``seed``; returns (params, opt_state,
    losses).  Every ``ckpt_every`` steps an async checkpoint goes to
    ``ckpt_dir``; ``resume`` restarts from its latest one, the token
    stream fast-forwarded past the batches already taken (the reference
    restarts the stream from its seed, ROADMAP C-R34), so a resumed run
    repeats the uninterrupted run's steps.  Under a ``mesh`` the run takes
    the mesh's device (this rank's, on a mesh over a process group), so it
    takes no ``device``."""
    placed = getattr(mesh, "device_mesh", None) is not None
    if mesh is None:
        dev = resolve_device(device)
    elif device is not None:
        raise ValueError("train: pass a device or a mesh, not both")
    elif placed:
        dev = mesh.devices[torch.distributed.get_rank()]
    else:
        dev = mesh.devices[0]
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    api = get_model(cfg)

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = make_trainable(api.init_params(gen, param_dtype, dev))
    if placed:
        shp.place_params(params, shp.param_shardings(params, cfg, mesh))
    opt_state = adamw.init(dict(params.named_parameters()))
    cast = param_dtype if param_dtype != torch.float32 else None
    step0 = 0

    if ckpt_dir and resume:
        restored, got_step = checkpoint.restore(
            ckpt_dir, train_state(cfg, params, opt_state, cast))
        if restored is not None:
            opt_state = load_train_state(cfg, params, opt_state, restored)
            step0 = got_step
            print(f"[train] resumed from step {step0}")

    step_fn = make_train_step(api, n_micro=n_micro, lr=lr, param_dtype=cast)
    source = SyntheticTokens(cfg.vocab_size, seed=seed)
    for _ in range(step0):
        source.batch(batch_size, seq_len)
    pipe = Prefetcher(source, batch_size, seq_len)
    losses = []
    pending = []
    t0 = time.time()
    try:
        with nullcontext() if mesh is None else shp.activate(mesh):
            for step in range(step0, step0 + steps):
                batch = _to_device(pipe.next(), dev)
                if placed:
                    batch = {k: shp.place(v, shp.data_sharding(v.shape, mesh))
                             for k, v in batch.items()}
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                losses.append(_scalar(metrics["loss"]))
                if (step + 1) % log_every == 0:
                    dt = time.time() - t0
                    print(f"[train] step {step + 1} loss {losses[-1]:.4f} "
                          f"gnorm {_scalar(metrics['grad_norm']):.3f} "
                          f"({dt / log_every:.2f}s/step)")
                    t0 = time.time()
                if ckpt_dir and (step + 1) % ckpt_every == 0:
                    writer = checkpoint.save(
                        ckpt_dir, train_state(cfg, params, opt_state),
                        step=step + 1, async_write=True)
                    if writer is not None:      # rank 0's, under a mesh
                        pending.append(writer)
    finally:
        pipe.close()
        for writer in pending:
            writer.join()
    return params, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="full config (default reduced/smoke)")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    _, _, losses = train(args.arch, steps=args.steps, batch_size=args.batch,
                         seq_len=args.seq, smoke=not args.full,
                         n_micro=args.n_micro, lr=args.lr,
                         ckpt_dir=args.ckpt_dir, resume=args.resume,
                         device=args.device)
    print(f"[train] first loss {losses[0]:.4f} → last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
