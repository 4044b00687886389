"""Port parity: the training path (``repro_torch.models.transformer``'s
``loss``, ``kernels.autograd``, ``launch.steps.make_train_step``,
``optim.adamw``, ``data.pipeline``, ``launch.train``) against the JAX
reference on the same weights and batches, at ``reduced()`` sizes.

The reference's parameters (``init_params(PRNGKey(0))``) are carried across
with ``lm_from_numpy``, its AdamW state with ``adamw_from_numpy``; tokens,
labels and patch or frame embeddings come from a numpy seed.  On the CPU
the kernels' Functions run with the plain versions as their forward.
Tolerances:
* loss, fp32: 1e-5 relative (the same float32 operations summed in
  another order by another library);
* gradients, fp32: each leaf within 1e-4 x its max |g| (the reference's
  scan over layers and XLA's fusions reorder the sums), and a leaf whose
  max |g| is below 1e-3 x the model's largest within 1e-7 x that: the
  cross-attention key bias's gradient is zero in exact arithmetic (the
  softmax ignores a shift shared by every key), rounding noise in both
  packages;
* the Functions' backward: bit for bit against plain autograd through the
  reference's math (it is that math's gradient);
* train steps (three, lr 1e-3): fp32 loss 1e-5 relative; grad_norm 5e-4
  relative (the reference's ``jnp.vdot`` sums lie 1.2-1.6e-4 from the
  float64 norm of its own gradients, the port's within 1e-7); the moments
  within 1e-4 x each leaf's max |value| (seen 8e-6); parameters and
  master within 0.05 x lr at most (seen 0.033 x lr) and 1e-5 x lr on
  average (seen 3e-6 x lr): Adam's update g / (|g| + eps) has slope 1/eps
  at g = 0, so a gradient's rounding where |g| is near eps moves an
  element by a share of lr.  bf16: loss 1e-2 and grad_norm 2e-2 relative
  (seen 2.4e-3, 5.7e-3: bf16 activations round in other places in XLA and
  in PyTorch, and a bf16 router may route a token otherwise), parameters
  and master within 2 x lr a step plus one bf16 rounding at most (the
  most two Adam runs can part) and 0.1 x lr on average (seen 0.05 x lr);
* AdamW alone: within 1 float32 ulp (the same operations in the same
  order; ``1 - b ** t`` may round differently);
* data: bit for bit;
* the mesh: ``train(mesh=make_local_mesh("cpu"))`` repeats ``train()``
  bit for bit (losses, parameters, AdamW state); a step with
  ``grad_shardings`` (the local mesh's ``param_shardings``) repeats the
  step without them bit for bit, and the reference's step with its own
  ``grad_shardings`` under its 1 x 1 mesh within the fp32 tolerances
  above; a sharding that would split a gradient raises.
"""

import copy
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.launch.steps import make_train_step as ref_train_step  # noqa: E402
from repro.models.transformer import get_model as ref_get_model  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import autograd as kernel_autograd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch import train as train_module  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models.transformer import (adamw_from_numpy,  # noqa: E402
                                            get_model, lm_from_numpy,
                                            lm_untree, make_trainable)
from repro_torch.optim import adamw  # noqa: E402

BATCH, SEQ = 2, 16
# (label, architecture): every family, as the reference configures it
FAMILIES = [("dense", "qwen2.5-3b"), ("mla", "minicpm3-4b"),
            ("moe", "olmoe-1b-7b"), ("vlm", "internvl2-1b"),
            ("ssm", "mamba2-130m"), ("hybrid", "zamba2-2.7b"),
            ("encdec", "whisper-tiny")]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, dtype: str):
    """The reference's random weights for ``arch`` at ``reduced()`` in
    ``dtype`` (its init, jitted)."""
    ref = ref_get_model(REF_ARCHS[arch].reduced())
    return jax.jit(ref.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), DTYPES[dtype][1])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


class Pair:
    """One configuration in both packages on the reference's weights, in
    ``dtype`` (the reference's bf16 parameters keep the MoE router float32
    at init, as the port's do)."""

    def __init__(self, arch: str, dtype: str = "float32"):
        self.cfg, self.ref_cfg = ARCHS[arch].reduced(), \
            REF_ARCHS[arch].reduced()
        self.api, self.ref = get_model(self.cfg), ref_get_model(self.ref_cfg)
        tdt, jdt = DTYPES[dtype]
        self.tdt, self.jdt = tdt, jdt
        self.ref_params = _ref_params(arch, dtype)
        self.params = make_trainable(lm_from_numpy(
            self.cfg, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   self.ref_params), tdt, "cpu"))

    def batch(self, seed: int, batch: int = BATCH) -> dict:
        """tokens, labels (B, S) int32 and the family's extra input
        (patches or frames, N(0, 0.5^2)) as numpy."""
        rng = np.random.default_rng(seed)
        chunk = rng.integers(0, self.cfg.vocab_size,
                             (batch, SEQ + 1)).astype(np.int32)
        out = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
        n = {"vlm": self.cfg.n_patches,
             "encdec": self.cfg.encoder_seq}.get(self.cfg.family)
        if n:
            out["extra"] = (rng.standard_normal((batch, n, self.cfg.d_model))
                            * 0.5).astype(np.float32)
        return out

    def torch_batch(self, b: dict) -> dict:
        out = {k: torch.from_numpy(v) for k, v in b.items()}
        if "extra" in out:
            out["extra"] = out["extra"].to(self.tdt)
        return out

    def jax_batch(self, b: dict) -> dict:
        out = {k: jnp.asarray(v) for k, v in b.items()}
        if "extra" in out:
            out["extra"] = out["extra"].astype(self.jdt)
        return out

    def port_loss(self, b: dict, use_kernel: bool = True):
        t = self.torch_batch(b)
        return self.api.loss(self.params, t["tokens"], t["labels"],
                             t.get("extra"), use_kernel=use_kernel)

    def port_grads(self, b: dict, use_kernel: bool = True) -> dict:
        named = dict(self.params.named_parameters())
        loss = self.port_loss(b, use_kernel)
        grads = torch.autograd.grad(loss, list(named.values()))
        return dict(zip(named, grads))

    def ref_loss_and_grads(self, b: dict):
        j = self.jax_batch(b)
        loss, grads = jax.value_and_grad(self.ref.loss)(
            self.ref_params, j["tokens"], j["labels"], j.get("extra"))
        return float(loss), lm_untree(self.cfg, jax.tree.map(np.asarray,
                                                             grads))


@pytest.fixture(scope="module", params=FAMILIES, ids=lambda f: f[0])
def family(request):
    pair = Pair(request.param[1])
    b = pair.batch(0)
    return pair, b, pair.ref_loss_and_grads(b)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "plain"])
def test_loss_matches_reference(family, use_kernel):
    pair, b, (want, _) = family
    got = pair.port_loss(b, use_kernel)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "plain"])
def test_gradients_match_reference(family, use_kernel):
    pair, b, (_, want) = family
    got = pair.port_grads(b, use_kernel)
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_gradients_flow_through_an_opaque_kernel(arch, monkeypatch):
    """On the card the wrappers write the kernels' outputs through ctypes,
    out of autograd's sight.  With the plain versions made just as opaque
    (outputs detached), the Functions still give every parameter the
    gradient of the reference's math."""
    pair = Pair(arch)
    b = pair.batch(1)
    want = pair.port_grads(b, use_kernel=False)
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: flash_attention_ref(*a, **k).detach())
    monkeypatch.setattr(ops, "ssd_scan", lambda *a: tuple(
        t.detach() for t in ssd_scan_ref(*a)))
    got = pair.port_grads(b, use_kernel=True)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(_np(g), _np(want[name]), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


# (label, B, S, T, H, KH, D, causal, window)
FLASH_CASES = [("causal", 2, 24, 24, 4, 2, 16, True, 0),
               ("window", 1, 33, 33, 6, 3, 8, True, 5),
               ("cross", 2, 7, 19, 4, 4, 16, False, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: c[0])
def test_flash_function_backward_is_the_math_gradient(case, dtype):
    _, b, s, t, h, kh, d, causal, window = case
    tdt = DTYPES[dtype][0]
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(b, s, h, d, generator=gen).to(tdt)
    k, v = (torch.randn(b, t, kh, d, generator=gen).to(tdt)
            for _ in range(2))
    g = torch.randn(b, s, h, d, generator=gen).to(tdt)
    pos = torch.arange(s, dtype=torch.int32)
    outs = {}
    for use_kernel in (True, False):
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        out = layers.attention_full(*ins, pos, window, d ** -0.5,
                                    causal=causal, use_kernel=use_kernel)
        outs[use_kernel] = torch.autograd.grad(out, ins, g)
    for got, want in zip(outs[True], outs[False]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_function_backward_is_the_math_gradient(dtype):
    tdt = DTYPES[dtype][0]
    gen = torch.Generator().manual_seed(4)
    bsz, slen, h, p, g, n, chunk = 2, 24, 4, 8, 2, 8, 8
    x = torch.randn(bsz, slen, h, p, generator=gen).to(tdt)
    dt = torch.nn.functional.softplus(torch.randn(bsz, slen, h,
                                                  generator=gen))
    a_log = torch.log(torch.linspace(1.0, 4.0, h)).to(tdt)
    b, c = (torch.randn(bsz, slen, g, n, generator=gen).to(tdt)
            for _ in range(2))
    gy = torch.randn(bsz, slen, h, p, generator=gen).to(tdt)
    grads = {}
    for use_kernel in (True, False):
        ins = [t.clone().requires_grad_() for t in (x, dt, a_log, b, c)]
        if use_kernel:
            y, _ = kernel_autograd.ssd_scan(*ins, math=lambda *a: ssm.
                                            ssd_chunked(*a, chunk))
        else:
            y, _ = ssm.ssd_chunked(*ins, chunk)
        grads[use_kernel] = torch.autograd.grad(y, ins, gy)
    for got, want in zip(grads[True], grads[False]):
        assert torch.equal(got, want)


def test_ssd_function_refuses_a_gradient_into_the_final_state():
    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    dt = torch.full((1, 8, 2), 0.1)
    b = c = torch.randn(1, 8, 1, 4)
    _, state = kernel_autograd.ssd_scan(
        x, dt, torch.zeros(2), b, c,
        math=lambda *a: ssm.ssd_chunked(*a, 8))
    with pytest.raises(RuntimeError, match="final state"):
        state.sum().backward()


def test_remat_recomputes_the_kernels(monkeypatch):
    """With ``cfg.remat`` each block's forward, its kernel included, runs
    again in the backward (the reference's ``jax.checkpoint``); without it,
    and with no gradient recorded, once."""
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pair = Pair("qwen2.5-3b")
    n = pair.cfg.n_layers
    for remat, want in ((True, 2 * n), (False, n)):
        pair.cfg = dataclasses.replace(pair.cfg, remat=remat)
        pair.api = get_model(pair.cfg)
        calls.clear()
        pair.port_grads(pair.batch(0))
        assert len(calls) == want, remat
    pair.api = get_model(dataclasses.replace(pair.cfg, remat=True))
    calls.clear()
    with torch.no_grad():
        pair.port_loss(pair.batch(0))
    assert len(calls) == n


# (arch, dtype, n_micro)
STEP_CASES = [("qwen2.5-3b", "float32", 1), ("qwen2.5-3b", "float32", 2),
              ("qwen2.5-3b", "bfloat16", 1), ("qwen2.5-3b", "bfloat16", 2),
              ("mamba2-130m", "float32", 2), ("olmoe-1b-7b", "bfloat16", 1)]


def _gap(got: dict, want: dict) -> np.ndarray:
    """|got - want| of every element, by name, flattened."""
    assert set(got) == set(want)
    return np.concatenate([np.abs(_np(t) - np.asarray(want[n], np.float32))
                           .ravel() for n, t in got.items()])


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-micro{c[2]}")
def test_train_steps_match_reference(case):
    arch, dtype, n_micro = case
    pair = Pair(arch, dtype)
    fp32 = dtype == "float32"
    lr, steps = 1e-3, 3
    cast = (None, None) if fp32 else (pair.tdt, pair.jdt)
    step = make_train_step(pair.api, n_micro, lr=lr, param_dtype=cast[0])
    ref_step = jax.jit(ref_train_step(pair.ref, n_micro, lr=lr,
                                      param_dtype=cast[1]))
    opt = adamw.init(dict(pair.params.named_parameters()))
    ref_params, ref_opt = pair.ref_params, ref_adamw.init(pair.ref_params)
    source = pipeline.SyntheticTokens(pair.cfg.vocab_size, seed=5)
    for _ in range(steps):
        chunk = source.batch(4, SEQ)
        b = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
        params, opt, metrics = step(pair.params, opt, pair.torch_batch(b))
        assert params is pair.params
        ref_params, ref_opt, ref_metrics = ref_step(ref_params, ref_opt,
                                                    pair.jax_batch(b))
        for key, tol in (("loss", 1e-5 if fp32 else 1e-2),
                         ("grad_norm", 5e-4 if fp32 else 2e-2)):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(ref_metrics[key]), rtol=tol,
                                       err_msg=key)
    assert int(opt.step) == int(ref_opt.step) == steps
    ref_named = lm_untree(pair.cfg, jax.tree.map(np.asarray, ref_params))
    named = {n: p.detach() for n, p in pair.params.named_parameters()}
    for name, p in named.items():
        # every leaf in the parameter type after a step, the router too
        # (C-R32), in both packages
        assert p.dtype == pair.tdt, name
        assert str(ref_named[name].dtype) == dtype, name
    ref_state = adamw_from_numpy(pair.cfg, jax.tree.map(np.asarray, ref_opt),
                                 "cpu")
    for what, got, want in (("params", named, ref_named),
                            ("master", opt.master, ref_state.master)):
        gap = _gap(got, want)
        most = 0.05 * lr if fp32 else 2 * lr * steps + 2.0 ** -8 * max(
            float(np.abs(np.asarray(w, np.float32)).max())
            for w in want.values())
        assert gap.max() <= most, (what, gap.max())
        assert gap.mean() <= (1e-5 if fp32 else 0.1) * lr, (what, gap.mean())
    if fp32:
        for field in ("m", "v"):
            got, want = getattr(opt, field), getattr(ref_state, field)
            for name, t in got.items():
                scale = float(want[name].abs().max())
                np.testing.assert_allclose(_np(t), _np(want[name]), rtol=0,
                                           atol=1e-4 * scale,
                                           err_msg=f"{field} {name}")


def test_router_is_float32_until_a_bf16_step():
    """C-R32: the router is a float32 parameter at init in both packages
    (and ``Module.to`` leaves it alone); a bf16 step casts it to bf16
    (``test_train_steps_match_reference``)."""
    pair = Pair("olmoe-1b-7b", "bfloat16")
    assert pair.ref_params["layers"]["moe"]["router"].dtype == jnp.float32
    for layer in pair.params.layers:
        assert layer.moe.router.dtype == torch.float32
        assert layer.moe.router.requires_grad
        assert "router" in dict(layer.moe.named_parameters())
    pair.params.to(torch.bfloat16)
    assert all(layer.moe.router.dtype == torch.float32
               for layer in pair.params.layers)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(grad_dtype):
    rng = np.random.default_rng(6)
    shapes = {"a": (5, 7), "b": (13,), "c": (2, 3, 4)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    tdt, jdt = DTYPES[grad_dtype]
    state = adamw.init({n: torch.from_numpy(a) for n, a in params.items()})
    ref_state = ref_adamw.init({n: jnp.asarray(a) for n, a in params.items()})
    for _ in range(3):
        grads = {n: rng.standard_normal(s).astype(np.float32)
                 for n, s in shapes.items()}
        new, state = adamw.update(
            {n: torch.from_numpy(g).to(tdt) for n, g in grads.items()},
            state, lr=1e-2, param_dtype=torch.bfloat16)
        ref_new, ref_state = ref_adamw.update(
            {n: jnp.asarray(g).astype(jdt) for n, g in grads.items()},
            ref_state, lr=1e-2, param_dtype=jnp.bfloat16)
        for n in shapes:
            for got, want in ((state.master, ref_state.master),
                              (state.m, ref_state.m), (state.v, ref_state.v)):
                np.testing.assert_array_max_ulp(got[n].numpy(),
                                                np.asarray(want[n]), maxulp=1)
            assert new[n].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                new[n].float().numpy(),
                np.asarray(ref_new[n].astype(jnp.float32)))
    assert int(state.step) == int(ref_state.step) == 3


def test_adamw_fp32_params_are_the_master():
    p = {"w": torch.ones(3)}
    state = adamw.init(p)
    assert state.master["w"] is not p["w"]
    new, state = adamw.update({"w": torch.ones(3)}, state)
    assert new["w"] is state.master["w"]
    with pytest.raises(ValueError, match="different"):
        adamw.update({"x": torch.ones(3)}, state)


@pytest.mark.parametrize("seed", [0, 11])
def test_synthetic_tokens_match_reference(seed):
    ours = pipeline.SyntheticTokens(300, seed=seed)
    theirs = ref_pipeline.SyntheticTokens(300, seed=seed)
    for shape in ((4, 16), (3, 33), (1, 1)):
        a, b = ours.batch(*shape), theirs.batch(*shape)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_prefetcher_matches_reference():
    ours = pipeline.Prefetcher(pipeline.SyntheticTokens(97, seed=3), 2, 9)
    theirs = ref_pipeline.Prefetcher(ref_pipeline.SyntheticTokens(97, seed=3),
                                     2, 9)
    try:
        for _ in range(4):
            a, b = ours.next(), theirs.next()
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a["tokens"][:, 1:],
                                          a["labels"][:, :-1])
    finally:
        ours.close()
        theirs.close()
    assert not ours._thread.is_alive()


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_memmap_tokens_match_reference(tmp_path, dtype):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(8).integers(0, 1000, 500).astype(dtype).tofile(path)
    ours = pipeline.MemmapTokens(path, 1000, dtype=dtype, seed=2)
    theirs = ref_pipeline.MemmapTokens(path, 1000, dtype=dtype, seed=2)
    for _ in range(3):
        np.testing.assert_array_equal(ours.batch(4, 20), theirs.batch(4, 20))


def test_train_resumed_repeats_the_uninterrupted_losses(tmp_path, capsys):
    kw = dict(steps=4, batch_size=4, seq_len=SEQ, n_micro=2, log_every=1,
              device="cpu")
    _, state, whole = train_module.train("mamba2-130m", **kw)
    ck = tmp_path / "ck"
    train_module.train("mamba2-130m", **{**kw, "steps": 2}, ckpt_dir=ck,
                       ckpt_every=2)
    _, resumed_state, rest = train_module.train(
        "mamba2-130m", **{**kw, "steps": 2}, ckpt_dir=ck, ckpt_every=2,
        resume=True)
    assert rest == whole[2:]
    assert int(resumed_state.step) == int(state.step) == 4
    for name, t in state.master.items():
        assert torch.equal(resumed_state.master[name], t), name
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out
    assert "[train] step 4 loss" in out


def test_train_driver_runs_the_reference_cli(capsys):
    train_module.main(["--arch", "mamba2-130m", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "16"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("[train] first loss") and "→ last" in last


# ---------------------------------------------------------------------------
# the mesh: train(mesh=) and make_train_step(grad_shardings=)


def _state_equal(a, b) -> bool:
    (pa, oa, la), (pb, ob, lb) = a, b
    sa, sb = pa.state_dict(), pb.state_dict()
    return (la == lb and sa.keys() == sb.keys()
            and all(torch.equal(sa[n], sb[n]) for n in sa)
            and torch.equal(oa.step, ob.step)
            and all(torch.equal(x[n], y[n])
                    for x, y in zip(oa[1:], ob[1:]) for n in x))


@pytest.mark.parametrize("arch", ["mamba2-130m", "internvl2-1b"])
def test_train_under_the_local_mesh_is_the_same_run(arch):
    kw = dict(steps=3, batch_size=4, seq_len=SEQ, n_micro=2, log_every=3)
    plain = train_module.train(arch, device="cpu", **kw)
    meshed = train_module.train(arch, mesh=make_local_mesh("cpu"), **kw)
    assert _state_equal(plain, meshed)
    with pytest.raises(ValueError, match="not both"):
        train_module.train(arch, device="cpu", mesh=make_local_mesh("cpu"),
                           **kw)


def test_grad_shardings_step_matches_reference():
    """The port's step with the local mesh's ``param_shardings`` as
    ``grad_shardings`` equals its step without them bit for bit, and the
    reference's step with its own ``grad_shardings`` under its 1 x 1 mesh
    within the fp32 tolerances of ``test_train_steps_match_reference``."""
    pair = Pair("qwen2.5-3b")
    lr, n_micro = 1e-3, 2
    mesh = make_local_mesh("cpu")
    shardings = sharding.param_shardings(pair.params, pair.cfg, mesh)
    assert set(shardings) == set(dict(pair.params.named_parameters()))
    assert not any(any(s.spec) for s in shardings.values())
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"),
                             devices=jax.devices()[:1])
    with ref_sharding.activate(ref_mesh):
        ref_step = jax.jit(ref_train_step(
            pair.ref, n_micro, lr=lr,
            grad_shardings=ref_sharding.param_shardings(
                pair.ref_params, pair.ref_cfg, ref_mesh)))
        ref_params, ref_opt = pair.ref_params, ref_adamw.init(pair.ref_params)
        runs = {}
        for pinned in (False, True):
            params = copy.deepcopy(pair.params)
            opt = adamw.init(dict(params.named_parameters()))
            step = make_train_step(pair.api, n_micro, lr=lr,
                                   grad_shardings=shardings if pinned
                                   else None)
            source = pipeline.SyntheticTokens(pair.cfg.vocab_size, seed=5)
            metrics = []
            for _ in range(2):
                chunk = source.batch(4, SEQ)
                b = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
                params, opt, m = step(params, opt, pair.torch_batch(b))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                if pinned:
                    ref_params, ref_opt, ref_m = ref_step(
                        ref_params, ref_opt, pair.jax_batch(b))
                    np.testing.assert_allclose(metrics[-1][0],
                                               float(ref_m["loss"]),
                                               rtol=1e-5)
                    np.testing.assert_allclose(metrics[-1][1],
                                               float(ref_m["grad_norm"]),
                                               rtol=5e-4)
            runs[pinned] = (params, opt, metrics)
    assert _state_equal(runs[False], runs[True])
    ref_named = lm_untree(pair.cfg, jax.tree.map(np.asarray, ref_params))
    gap = _gap({n: p.detach() for n, p in runs[True][0].named_parameters()},
               ref_named)
    assert gap.max() <= 0.05 * lr and gap.mean() <= 1e-5 * lr


def test_grad_shardings_that_would_split_raise():
    pair = Pair("qwen2.5-3b")
    named = dict(pair.params.named_parameters())
    split = {n: sharding.NamedSharding(make_local_mesh("cpu"), (None,) *
                                       p.dim()) for n, p in named.items()}
    split["lm_head"] = sharding.NamedSharding(
        types.SimpleNamespace(axis_names=("data", "model"),
                              shape={"data": 1, "model": 2}),
        (None, "model"))
    step = make_train_step(pair.api, 1, grad_shardings=split)
    opt = adamw.init(named)
    with pytest.raises(NotImplementedError, match="no process group"):
        step(pair.params, opt, pair.torch_batch(pair.batch(0)))
