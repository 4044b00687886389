"""Port parity: the LM families beyond the dense GQA decoder — MLA
(minicpm3-4b), MoE (olmoe-1b-7b, mixtral-8x22b), VLM patch prefixes
(internvl2-1b), the encoder-decoder (whisper-tiny) and the int8 KV cache
(qwen2.5-3b with ``kv_quant_int8``) — against the JAX reference on the
same weights, tokens and extra inputs, at ``reduced()`` sizes.

The reference's parameters (``init_params(PRNGKey(0))``) are carried
across with ``lm_from_numpy``; tokens, patch and frame embeddings come
from a numpy seed.  On the CPU the port's attention runs the kernels'
plain versions.  mixtral-8x22b (141 B parameters, 282 GB in bf16) does not
fit on one 80 GB card, so it is held to the reference here only.
Tolerances, as in ``tests/test_torch_lm.py``:
* fp32, atol = rtol = 1e-4 on logits, the MoE loss and cache entries;
  int8 cache values may differ by one step where the float32 value lies
  on a rounding boundary (a 1e-7 difference moves it), the scales within
  1e-4;
* bf16, atol = rtol = 0.1 on logits of magnitude ~4 (see
  ``test_torch_lm.py``), greedy tokens compared only in fp32.
Units: ``quantize_kv``/``dequantize_kv`` bit for bit in fp32 and bf16;
``layernorm`` and ``gelu_mlp``; ``moe_layer`` with a capacity factor of 1
so that pairs are dropped; the router stays float32 under
``params.to(torch.bfloat16)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch.steps import make_decode_step as ref_decode_step  # noqa: E402
from repro.models import cache as ref_cache  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.transformer import get_model as ref_get_model  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.transformer import get_model, lm_from_numpy  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.1, atol=0.1)
BATCH, PROMPT, MAX_LEN, STEPS = 2, 12, 32, 6
# (label, architecture, config changes)
FAMILIES = [("minicpm3-4b", "minicpm3-4b", {}),
            ("olmoe-1b-7b", "olmoe-1b-7b", {}),
            ("mixtral-8x22b", "mixtral-8x22b", {}),
            ("internvl2-1b", "internvl2-1b", {}),
            ("whisper-tiny", "whisper-tiny", {}),
            ("qwen2.5-3b-int8kv", "qwen2.5-3b", {"kv_quant_int8": True})]
# cache entries compared per family (besides pos and t)
CACHE_KEYS = {"mla": ("ckv", "krope"), "encdec": ("k", "v", "enc_k", "enc_v"),
              "int8": ("k_scale", "v_scale"), "gqa": ("k", "v")}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _bf16_leaves(path, a):
    """The reference's bf16 serving weights: every leaf bf16 but the MoE
    router, which ``init_moe_params`` keeps float32."""
    names = [getattr(k, "key", None) for k in path]
    return a if "router" in names else a.astype(jnp.bfloat16)


class Pair:
    """One configuration in both packages, on the reference's weights."""

    def __init__(self, arch, changes, dtype="float32"):
        self.cfg = dataclasses.replace(ARCHS[arch].reduced(), **changes)
        self.ref_cfg = dataclasses.replace(REF_ARCHS[arch].reduced(),
                                           **changes)
        self.api, self.ref = get_model(self.cfg), ref_get_model(self.ref_cfg)
        ref_params = self.ref.init_params(jax.random.PRNGKey(0), jnp.float32)
        self.tdt = {"float32": torch.float32,
                    "bfloat16": torch.bfloat16}[dtype]
        self.jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
        self.params = lm_from_numpy(self.cfg,
                                    jax.tree.map(np.asarray, ref_params),
                                    self.tdt, "cpu")
        self.ref_params = ref_params if dtype == "float32" else \
            jax.tree_util.tree_map_with_path(_bf16_leaves, ref_params)

    @property
    def kind(self):
        if self.cfg.attention == "mla":
            return "mla"
        if self.cfg.family == "encdec":
            return "encdec"
        return "int8" if self.cfg.kv_quant_int8 else "gqa"

    def tokens(self, seed, length):
        rng = np.random.default_rng(seed)
        return rng.integers(0, self.cfg.vocab_size,
                            (BATCH, length)).astype(np.int32)

    def extra(self, seed):
        """Patch embeddings (VLM) or frame embeddings (encdec) from the
        seed, as (port tensor, reference array) in the serving type; None
        for the other families."""
        n = {"vlm": self.cfg.n_patches,
             "encdec": self.cfg.encoder_seq}.get(self.cfg.family)
        if n is None:
            return None, None
        rng = np.random.default_rng(100 + seed)
        x = rng.standard_normal((BATCH, n, self.cfg.d_model)).astype(
            np.float32) * 0.5
        return (torch.from_numpy(x).to(self.tdt),
                jnp.asarray(x).astype(self.jdt))

    @property
    def prefix(self):
        return self.cfg.n_patches if self.cfg.family == "vlm" else 0


@pytest.fixture(scope="module", params=FAMILIES, ids=lambda f: f[0])
def pair(request):
    _, arch, changes = request.param
    return Pair(arch, changes)


def test_forward_logits_and_aux_match_reference(pair):
    toks = pair.tokens(0, PROMPT)
    extra, ref_extra = pair.extra(0)
    want, want_aux = pair.ref.forward(pair.ref_params, jnp.asarray(toks),
                                      ref_extra)
    got, aux = pair.api.forward(pair.params, torch.from_numpy(toks), extra)
    assert got.shape == (BATCH, pair.prefix + PROMPT, pair.cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), **F32_TOL)
    assert (float(aux) > 0) == pair.cfg.is_moe


def _check_cache(pair, cache, want, t):
    keys = CACHE_KEYS[pair.kind]
    for name in keys:
        assert cache[name].shape == want[name].shape, name
        np.testing.assert_allclose(_np(cache[name]), _np(want[name]),
                                   **F32_TOL)
    if pair.kind == "int8":
        for name in ("k", "v"):
            assert cache[name].dtype == torch.int8
            diff = np.abs(cache[name].numpy().astype(np.int32)
                          - np.asarray(want[name]).astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3, name
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(want["pos"]))
    assert cache["t"] == int(want["t"]) == t


def test_prefill_cache_and_logits_match_reference(pair):
    toks = pair.tokens(1, PROMPT)
    extra, ref_extra = pair.extra(1)
    want_cache, want = pair.ref.prefill(pair.ref_params, jnp.asarray(toks),
                                        MAX_LEN, ref_extra)
    cache, got = make_prefill_step(pair.api, MAX_LEN)(
        pair.params, {"tokens": torch.from_numpy(toks), "extra": extra})
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    _check_cache(pair, cache, want_cache, pair.prefix + PROMPT)


def _decode(pair, seed, steps, tol):
    """Greedy decoding in both packages: the port teacher-forced on the
    reference's tokens (logits compared step by step) and on its own
    (``make_decode_step``'s tokens).  Returns both token lists and the
    port's own and the reference's final caches."""
    toks = pair.tokens(seed, PROMPT)
    extra, ref_extra = pair.extra(seed)
    rcache, rlogits = pair.ref.prefill(pair.ref_params, jnp.asarray(toks),
                                       MAX_LEN, ref_extra)
    prefill = make_prefill_step(pair.api, MAX_LEN)
    batch = {"tokens": torch.from_numpy(toks), "extra": extra}
    forced, logits = prefill(pair.params, batch)
    own, _ = prefill(pair.params, batch)
    np.testing.assert_allclose(_np(logits), _np(rlogits), **tol)
    rtok = jnp.argmax(rlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    ref_serve, serve = ref_decode_step(pair.ref), make_decode_step(pair.api)
    ref_toks, port_toks = [rtok], [tok]
    for _ in range(steps):
        want, _ = pair.ref.decode_step(pair.ref_params, rcache, rtok)
        got, forced = pair.api.decode_step(
            pair.params, forced, torch.from_numpy(np.array(rtok)))
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        rtok, rcache = ref_serve(pair.ref_params, rcache, rtok)
        tok, own = serve(pair.params, own, tok)
        ref_toks.append(rtok)
        port_toks.append(tok)
    return port_toks, ref_toks, own, rcache


def test_greedy_decode_matches_reference(pair):
    port_toks, ref_toks, cache, rcache = _decode(pair, 2, STEPS, F32_TOL)
    for got, want in zip(port_toks, ref_toks):
        assert got.dtype == torch.int32 and got.shape == (BATCH, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_cache(pair, cache, rcache, pair.prefix + PROMPT + STEPS)


def test_prefill_then_decode_equals_forward(pair):
    """prefill(prompt) + decode(next) ≡ forward(prompt + next) at the last
    position, in the port alone.  The int8 cache's decode reads keys and
    values rounded to int8, so there the step may lie from forward as far
    as the reference's own int8 step lies from its forward, and no
    farther."""
    toks = pair.tokens(3, PROMPT + 1)
    extra, ref_extra = pair.extra(3)
    full, _ = pair.api.forward(pair.params, torch.from_numpy(toks), extra)
    cache, last = pair.api.prefill(pair.params,
                                   torch.from_numpy(toks[:, :PROMPT]),
                                   MAX_LEN, extra)
    np.testing.assert_allclose(_np(last[:, 0]), _np(full[:, -2]), **F32_TOL)
    logits, _ = pair.api.decode_step(pair.params, cache,
                                     torch.from_numpy(toks[:, PROMPT:]))
    if pair.kind != "int8":
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, -1]),
                                   **F32_TOL)
        return
    rfull, _ = pair.ref.forward(pair.ref_params, jnp.asarray(toks), ref_extra)
    rcache, _ = pair.ref.prefill(pair.ref_params,
                                 jnp.asarray(toks[:, :PROMPT]), MAX_LEN)
    rlogits, _ = pair.ref.decode_step(pair.ref_params, rcache,
                                      jnp.asarray(toks[:, PROMPT:]))
    ref_gap = np.abs(_np(rlogits[:, 0]) - _np(rfull[:, -1])).max()
    gap = np.abs(_np(logits[:, 0]) - _np(full[:, -1])).max()
    assert 0 < ref_gap and gap <= ref_gap + 1e-4


@pytest.mark.parametrize("family", FAMILIES, ids=lambda f: f[0])
def test_bf16_serving_matches_reference(family):
    _, arch, changes = family
    pair = Pair(arch, changes, dtype="bfloat16")
    assert pair.params.lm_head.dtype == torch.bfloat16
    _decode(pair, 5, 3, BF16_TOL)


# ------------------------------------------------------------------ units
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_exact(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0] = 0.0                                  # an empty slot: scale 1e-8
    x[1, 1, 0, :4] = [127.0, -63.5, 0.5, 1.5]      # exact .5 ties
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = ref_cache.quantize_kv(jx)
    tq, ts = tcache.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == tx.dtype
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))
    for out in ("float32", "bfloat16"):
        want = ref_cache.dequantize_kv(jq, js, getattr(jnp, out))
        got = tcache.dequantize_kv(tq, ts, getattr(torch, out))
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(_np(got), _np(want))


def test_int8_cache_shapes_and_types():
    cfg = dataclasses.replace(ARCHS["qwen2.5-3b"].reduced(),
                              kv_quant_int8=True)
    cache = get_model(cfg).init_cache(2, 8, torch.bfloat16, "cpu")
    want = ref_get_model(dataclasses.replace(
        REF_ARCHS["qwen2.5-3b"].reduced(), kv_quant_int8=True)).init_cache(
        2, 8, jnp.bfloat16)
    assert set(cache) == set(want)
    for name in ("k", "v", "k_scale", "v_scale", "pos"):
        assert tuple(cache[name].shape) == want[name].shape
        assert str(cache[name].dtype).removeprefix("torch.") == \
            str(want[name].dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_gelu_mlp_match_reference(dtype):
    rng = np.random.default_rng(8)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 5, 32), (32,), (32,)))
    mlp = {"w1": rng.standard_normal((32, 48)).astype(np.float32) * 0.2,
           "b1": rng.standard_normal(48).astype(np.float32),
           "w2": rng.standard_normal((48, 32)).astype(np.float32) * 0.2,
           "b2": rng.standard_normal(32).astype(np.float32)}
    jt = lambda a: jnp.asarray(a).astype(getattr(jnp, dtype))  # noqa: E731
    tt = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    tol = F32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    want = ref_layers.layernorm(jt(x), jt(w), jt(b))
    got = tlayers.layernorm(tt(x), tt(w), tt(b))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    want = ref_layers.gelu_mlp({n: jt(a) for n, a in mlp.items()}, jt(x))
    got = tlayers.gelu_mlp({n: tt(a) for n, a in mlp.items()}, tt(x))
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    # the tanh approximation, not the exact erf form
    exact = torch.nn.functional.gelu(torch.tensor(1.0))
    approx = torch.nn.functional.gelu(torch.tensor(1.0), approximate="tanh")
    np.testing.assert_allclose(float(jax.nn.gelu(1.0)), float(approx),
                               rtol=1e-6)
    assert abs(float(exact) - float(approx)) > 1e-5


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x22b"])
def test_moe_layer_drops_pairs_as_the_reference(arch):
    """capacity_factor 1.0 (``reduced()`` sets 8.0, which drops none):
    some (token, expert) pairs overflow their expert's buffer."""
    cfg, ref_cfg = ARCHS[arch].reduced(), REF_ARCHS[arch].reduced()
    ref_params = ref_layers.init_moe_params(jax.random.PRNGKey(3), ref_cfg)
    moe = tlayers.MoE(torch.tensor(np.asarray(ref_params["router"])),
                      {n: torch.tensor(np.asarray(a))
                       for n, a in ref_params["experts"].items()})
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_layers.moe_layer(ref_params, jnp.asarray(x),
                                          ref_cfg, capacity_factor=1.0)
    got, aux = tlayers.moe_layer(moe, torch.from_numpy(x), cfg,
                                 capacity_factor=1.0)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32_TOL)
    # pairs were dropped: the dropless layer gives another output
    full, _ = tlayers.moe_layer(moe, torch.from_numpy(x), cfg,
                                capacity_factor=8.0)
    assert tlayers.moe_capacity(48, cfg, 1.0) == 48 * 2 // 4
    assert float((full - got).abs().max()) > 1e-3


def test_router_stays_float32_in_bf16_serving():
    pair = Pair("olmoe-1b-7b", {})
    routers = [layer.moe.router.clone() for layer in pair.params.layers]
    pair.params.to(torch.bfloat16)
    for layer, before in zip(pair.params.layers, routers):
        assert layer.moe.router.dtype == torch.float32
        assert torch.equal(layer.moe.router, before)
        assert layer.moe.experts["w1"].dtype == torch.bfloat16
    params = pair.api.init_params(torch.Generator().manual_seed(0),
                                  torch.bfloat16, "cpu")
    assert params.layers[0].moe.router.dtype == torch.float32
    assert params.layers[0].moe.experts["w2"].dtype == torch.bfloat16
    assert any(n.endswith("moe.router") for n, _ in params.named_buffers())


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b",
                                  "mamba2-130m"])
def test_extra_is_refused_by_a_family_that_takes_none(arch):
    api = get_model(ARCHS[arch].reduced())
    params = api.init_params(torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    extra = torch.zeros((1, 2, api.cfg.d_model))
    with pytest.raises(ValueError, match="takes no extra input"):
        api.forward(params, toks, extra)
    with pytest.raises(ValueError, match="takes no extra input"):
        api.prefill(params, toks, 8, extra)


def test_every_configuration_is_served():
    """``get_model`` builds every architecture, full size included (no
    weights are made)."""
    for name, cfg in ARCHS.items():
        assert get_model(cfg).cfg is cfg, name


# ------------------------------------------- the reference's int8 KV cases
# (tests/test_kv_quant.py, on the port)
def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8, 64)).astype(np.float32) * 3.0)
    q, s = tcache.quantize_kv(x)
    assert q.dtype == torch.int8
    err = (tcache.dequantize_kv(q, s, x.dtype) - x).abs()
    assert bool((err <= s[..., None] * 0.5 + 1e-6).all())


def test_quantize_zero_vector_safe():
    q, s = tcache.quantize_kv(torch.zeros((2, 4)))
    assert bool((q == 0).all()) and bool(torch.isfinite(s).all())


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b"])
def test_int8_kv_decode_approximates_forward(arch):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), kv_quant_int8=True)
    api = get_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(1), torch.float32,
                             "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32))
    full, _ = api.forward(params, tokens)
    cache, _ = api.prefill(params, tokens[:, :12], 20)
    assert cache["k"].dtype == torch.int8
    logits, _ = api.decode_step(params, cache, tokens[:, 12:13])
    want = full[:, -1]
    rel = float((logits[:, 0] - want).abs().max() / want.abs().max())
    assert rel < 0.05, f"int8 KV degraded logits: rel err {rel:.4f}"


def test_int8_kv_multi_step_consistency():
    """Several decode steps with the quantized ring pick the same last
    token as the float ring."""
    base = ARCHS["qwen2.5-3b"].reduced()
    api_fp = get_model(base)
    api_q8 = get_model(dataclasses.replace(base, kv_quant_int8=True))
    params = api_fp.init_params(torch.Generator().manual_seed(2),
                                torch.float32, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, base.vocab_size, (2, 16)).astype(np.int32))
    c_fp, _ = api_fp.prefill(params, tokens[:, :10], 24)
    c_q8, _ = api_q8.prefill(params, tokens[:, :10], 24)
    for i in range(10, 16):
        l_fp, c_fp = api_fp.decode_step(params, c_fp, tokens[:, i:i + 1])
        l_q8, c_q8 = api_q8.decode_step(params, c_q8, tokens[:, i:i + 1])
    assert torch.equal(l_fp.argmax(-1), l_q8.argmax(-1))
