"""Port parity: the dense decoder LM's serving path (``repro_torch.models.
transformer``, ``launch.steps``) against the JAX reference on the same
weights and tokens.

The reference's parameters (``init_params(PRNGKey(0))``) are carried
across with ``lm_from_numpy``; tokens come from a numpy seed.  On the CPU
the port's attention runs the kernels' plain versions.  Tolerances:
* fp32, atol = rtol = 1e-4 on logits and cache entries: the same
  operations in float32, summed in another order by another library;
* bf16, atol = rtol = 0.1 on logits of magnitude ~4 (bf16 keeps 8
  bits: one rounding of a logit is up to 0.016, and each of the ~20
  roundings per layer lands in another place in XLA and in PyTorch; the
  largest gap seen is 0.047), with the greedy tokens compared only in
  fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch.steps import make_decode_step as ref_decode_step  # noqa: E402
from repro.launch.steps import make_prefill_step as ref_prefill_step  # noqa: E402
from repro.models.transformer import get_model as ref_get_model  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models.transformer import get_model, lm_from_numpy  # noqa: E402

LM_ARCHS = ["qwen2.5-3b", "qwen2-7b"]
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.1, atol=0.1)
BATCH, PROMPT, MAX_LEN, STEPS = 2, 12, 24, 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


class Pair:
    """One configuration in both packages, on the reference's weights."""

    def __init__(self, cfg, ref_cfg, dtype="float32"):
        self.cfg, self.ref_cfg = cfg, ref_cfg
        self.api, self.ref = get_model(cfg), ref_get_model(ref_cfg)
        ref_params = self.ref.init_params(jax.random.PRNGKey(0), jnp.float32)
        tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
        self.params = lm_from_numpy(cfg, jax.tree.map(np.asarray, ref_params),
                                    tdt, "cpu")
        self.ref_params = jax.tree.map(
            lambda a: a.astype(jnp.bfloat16), ref_params) \
            if dtype == "bfloat16" else ref_params

    def tokens(self, seed, length):
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, self.cfg.vocab_size, (BATCH, length))
        return toks.astype(np.int32)


@pytest.fixture(scope="module", params=LM_ARCHS)
def pair(request):
    return Pair(ARCHS[request.param].reduced(),
                REF_ARCHS[request.param].reduced())


def _windowed(window):
    name = "qwen2.5-3b"
    return Pair(dataclasses.replace(ARCHS[name].reduced(),
                                    sliding_window=window),
                dataclasses.replace(REF_ARCHS[name].reduced(),
                                    sliding_window=window))


def test_forward_logits_match_reference(pair):
    toks = pair.tokens(0, PROMPT)
    want, _ = pair.ref.forward(pair.ref_params, jnp.asarray(toks))
    got, aux = pair.api.forward(pair.params, torch.from_numpy(toks))
    assert got.shape == (BATCH, PROMPT, pair.cfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_prefill_cache_and_logits_match_reference(pair):
    toks = pair.tokens(1, PROMPT)
    want_cache, want = ref_prefill_step(pair.ref, MAX_LEN)(
        pair.ref_params, {"tokens": jnp.asarray(toks)})
    cache, got = make_prefill_step(pair.api, MAX_LEN)(
        pair.params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    for name in ("k", "v"):
        assert cache[name].shape == want_cache[name].shape
        np.testing.assert_allclose(_np(cache[name]), _np(want_cache[name]),
                                   **F32_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(want_cache["pos"]))
    assert cache["t"] == int(want_cache["t"]) == PROMPT


def _ref_decode(pair, toks, steps, max_len):
    """Greedy decoding with the reference: each step's logits and tokens."""
    cache, logits = pair.ref.prefill(pair.ref_params, jnp.asarray(toks),
                                     max_len)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    serve = ref_decode_step(pair.ref)
    all_logits, all_toks = [], [tok]
    for _ in range(steps):
        step_logits, _ = pair.ref.decode_step(pair.ref_params, cache, tok)
        tok, cache = serve(pair.ref_params, cache, tok)
        all_logits.append(step_logits)
        all_toks.append(tok)
    return all_logits, all_toks, cache


def _port_decode(pair, toks, steps, max_len, ref_toks):
    """The port's logits teacher-forced on the reference's tokens, and its
    own greedy tokens from ``make_decode_step``."""
    prefill = make_prefill_step(pair.api, max_len)
    forced, logits = prefill(pair.params, {"tokens": torch.from_numpy(toks)})
    own, _ = prefill(pair.params, {"tokens": torch.from_numpy(toks)})
    serve = make_decode_step(pair.api)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    all_logits, all_toks = [], [tok]
    for i in range(steps):
        step_logits, forced = pair.api.decode_step(
            pair.params, forced, torch.from_numpy(np.array(ref_toks[i])))
        tok, own = serve(pair.params, own, tok)
        all_logits.append(step_logits)
        all_toks.append(tok)
    return all_logits, all_toks, own


def _check_decode(pair, toks, steps, max_len, tol):
    ref_logits, ref_toks, ref_cache = _ref_decode(pair, toks, steps, max_len)
    logits, port_toks, cache = _port_decode(pair, toks, steps, max_len,
                                            ref_toks)
    for got, want in zip(logits, ref_logits):
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    return port_toks, ref_toks, cache, ref_cache


def test_greedy_decode_matches_reference(pair):
    port_toks, ref_toks, cache, ref_cache = _check_decode(
        pair, pair.tokens(2, PROMPT), STEPS, MAX_LEN, F32_TOL)
    for got, want in zip(port_toks, ref_toks):
        assert got.dtype == torch.int32 and got.shape == (BATCH, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(_np(cache["k"]), _np(ref_cache["k"]),
                               **F32_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))
    assert cache["t"] == int(ref_cache["t"]) == PROMPT + STEPS


def test_prefill_then_decode_equals_forward(pair):
    """The port's own decode invariant: prefill(prompt) + decode(next) ≡
    forward(prompt + next) at the last position."""
    toks = torch.from_numpy(pair.tokens(3, PROMPT + 1))
    full, _ = pair.api.forward(pair.params, toks)
    cache, last = pair.api.prefill(pair.params, toks[:, :PROMPT], MAX_LEN)
    np.testing.assert_allclose(_np(last[:, 0]), _np(full[:, PROMPT - 1]),
                               **F32_TOL)
    logits, _ = pair.api.decode_step(pair.params, cache, toks[:, PROMPT:])
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, -1]),
                               **F32_TOL)


@pytest.mark.parametrize("window", [8, 5])
def test_sliding_window_ring_decodes_past_the_window(window):
    """A ring of ``window`` slots: the prompt overflows it and the decode
    steps wrap it; logits, tokens and the ring match the reference."""
    pair = _windowed(window)
    port_toks, ref_toks, cache, ref_cache = _check_decode(
        pair, pair.tokens(4, PROMPT), STEPS, MAX_LEN, F32_TOL)
    for got, want in zip(port_toks, ref_toks):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cache["k"].shape[2] == window
    np.testing.assert_allclose(_np(cache["v"]), _np(ref_cache["v"]),
                               **F32_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))


def test_bf16_serving_matches_reference():
    pair = Pair(ARCHS["qwen2.5-3b"].reduced(),
                REF_ARCHS["qwen2.5-3b"].reduced(), dtype="bfloat16")
    assert pair.params.lm_head.dtype == torch.bfloat16
    _check_decode(pair, pair.tokens(5, PROMPT), 3, MAX_LEN, BF16_TOL)


def test_decode_writes_the_cache_in_place(pair):
    cache, logits = pair.api.prefill(
        pair.params, torch.from_numpy(pair.tokens(6, PROMPT)), MAX_LEN)
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    _, out = pair.api.decode_step(pair.params, cache, tok)
    assert out is cache and out["k"] is k and out["v"] is v
    assert out["pos"] is pos and int(pos[PROMPT]) == PROMPT
    assert float(k[:, :, PROMPT].abs().sum()) > 0
    assert float(k[:, :, PROMPT + 1:].abs().sum()) == 0


def test_random_init_has_the_reference_shapes():
    cfg = ARCHS["qwen2.5-3b"].reduced()
    ref = ref_get_model(REF_ARCHS["qwen2.5-3b"].reduced())
    ref_params = ref.init_params(jax.random.PRNGKey(0), jnp.float32)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        torch.float32, "cpu")
    layer = params.layers[0]
    ref_layers = ref_params["layers"]
    assert len(params.layers) == cfg.n_layers
    assert params.embed.shape == ref_params["embed"].shape
    assert params.lm_head.shape == ref_params["lm_head"].shape
    for group, ref_group in ((layer.attn, ref_layers["attn"]),
                             (layer.mlp, ref_layers["mlp"])):
        assert set(group) == set(ref_group)
        for name, p in group.items():
            assert p.shape == ref_group[name].shape[1:]
            assert not p.requires_grad
    # the reference's scale: wq ~ N(0, 1 / d_model)
    std = float(layer.attn["wq"].std())
    assert abs(std - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_config_copy_matches_reference(name):
    assert dataclasses.asdict(ARCHS[name]) == \
        dataclasses.asdict(REF_ARCHS[name])
    assert dataclasses.asdict(ARCHS[name].reduced()) == \
        dataclasses.asdict(REF_ARCHS[name].reduced())


@pytest.mark.parametrize("cfg", [
    *(ARCHS[n] for n in sorted(ARCHS) if n not in
      ("qwen2.5-3b", "qwen2-7b", "stablelm-3b", "mamba2-130m",
       "zamba2-2.7b")),
    dataclasses.replace(ARCHS["qwen2.5-3b"], kv_quant_int8=True),
], ids=lambda c: c.name + ("-int8kv" if c.kv_quant_int8 else ""))
def test_other_families_are_refused_with_their_roadmap_item(cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP A-"):
        get_model(cfg)
