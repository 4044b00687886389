"""Port parity: the Mamba-2 layer (``repro_torch.models.ssm``) and the SSM
and hybrid LMs' serving paths (``models.transformer``, ``launch.steps``)
against the JAX reference on the same weights and tokens.

The reference's parameters (``init_params(PRNGKey(0))``) are carried across
with ``lm_from_numpy``; tokens and activations come from numpy seeds.  On
the CPU the port's SSD scan runs the kernel's plain version (the sequential
recurrence) and its attention the attention kernels' plain versions; the
reference model runs its chunked scan (``ssd_chunked``, one chunk of the
whole length when ``ssm_chunk`` does not divide it).  Tolerances:
* fp32, atol = rtol = 1e-4 on outputs, logits and caches: the same
  function in float32, the scan chunked in one and sequential in the other
  (the reference's own chunked-vs-sequential test allows 2e-4 on the bare
  scan; here the layer's norm and projections follow), summed in another
  order by another library; 5e-4 on the states carried through decode
  steps, as the reference's forward-then-decode test allows;
* bf16, atol = rtol = 0.1 on logits of magnitude ~4 (bf16 keeps 8 bits:
  one rounding of a logit is up to 0.016, and the roundings of each layer
  land in other places in XLA and in PyTorch), with the greedy tokens
  compared only in fp32.  The serving type rounds A_log, D and dt_bias to
  bf16 too, in both packages.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import get_model as ref_get_model  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.cache import init_ssm_cache  # noqa: E402
from repro_torch.models.transformer import get_model, lm_from_numpy  # noqa: E402

SSM_ARCHS = ["mamba2-130m", "zamba2-2.7b"]
F32_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=5e-4, atol=5e-4)
BF16_TOL = dict(rtol=0.1, atol=0.1)
BATCH, PROMPT, MAX_LEN, STEPS = 2, 12, 24, 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, tol=F32_TOL):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ------------------------------------------------------------ the layer

@pytest.fixture(scope="module")
def layer():
    """mamba2-130m's reduced layer on the reference's weights."""
    cfg = ARCHS["mamba2-130m"].reduced()
    ref_cfg = REF_ARCHS["mamba2-130m"].reduced()
    ref_p = jssm.init_ssm_params(jax.random.PRNGKey(2), ref_cfg, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    return cfg, ref_cfg, p, ref_p


def _activations(seed, length, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, length, d)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel-path", "plain-path"])
@pytest.mark.parametrize("slen", [16, 12], ids=["chunked", "one-chunk"])
def test_ssm_forward_matches_reference(layer, slen, use_kernel):
    cfg, ref_cfg, p, ref_p = layer
    x = _activations(0, slen, cfg.d_model)
    want, want_carry = jssm.ssm_forward(ref_p, jnp.asarray(x), ref_cfg)
    got, carry = ssm.ssm_forward(p, torch.from_numpy(x), cfg,
                                 use_kernel=use_kernel)
    _close(got, want)
    _close(carry["state"], want_carry["state"])
    _close(carry["conv"], want_carry["conv"])


def test_ssm_decode_step_matches_reference_in_place(layer):
    cfg, ref_cfg, p, ref_p = layer
    x = _activations(1, 9, cfg.d_model)
    _, ref_carry = jssm.ssm_forward(ref_p, jnp.asarray(x[:, :8]), ref_cfg)
    _, carry = ssm.ssm_forward(p, torch.from_numpy(x[:, :8]), cfg)
    cache = init_ssm_cache(cfg, 1, BATCH, "cpu")
    state, conv = cache["state"][0], cache["conv"][0]
    state.copy_(carry["state"])
    conv.copy_(carry["conv"])
    want, want_carry = jssm.ssm_decode_step(ref_p, jnp.asarray(x[:, 8:]),
                                            ref_cfg, ref_carry)
    got, out = ssm.ssm_decode_step(p, torch.from_numpy(x[:, 8:]), cfg,
                                   {"state": state, "conv": conv})
    assert out["state"] is state and out["conv"] is conv
    _close(got, want)
    _close(cache["state"][0], want_carry["state"], STATE_TOL)
    _close(cache["conv"][0], want_carry["conv"])


def test_forward_then_decode_continuity(layer):
    """Prefill carry + token-by-token decode ≡ one long forward (the
    reference's ``test_ssm.py::test_forward_then_decode_continuity``)."""
    cfg, _, p, _ = layer
    x = torch.from_numpy(_activations(2, 20, cfg.d_model))
    full, _ = ssm.ssm_forward(p, x, cfg)
    pre, carry = ssm.ssm_forward(p, x[:, :16], cfg)
    _close(pre, full[:, :16])
    carry = {"state": carry["state"].clone(), "conv": carry["conv"].float()}
    outs = [ssm.ssm_decode_step(p, x[:, i:i + 1], cfg, carry)[0]
            for i in range(16, 20)]
    _close(torch.cat(outs, dim=1), full[:, 16:], STATE_TOL)


# ------------------------------------------------------------ the LMs

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


def _pair(name, dtype="float32", **changes):
    return Pair(dataclasses.replace(ARCHS[name].reduced(), **changes),
                dataclasses.replace(REF_ARCHS[name].reduced(), **changes),
                dtype)


@pytest.fixture(scope="module", params=SSM_ARCHS)
def pair(request):
    return _pair(request.param)


def _cache_names(pair):
    names = ["state", "conv"]
    return names + ["k", "v"] if pair.cfg.family == "hybrid" else names


@pytest.mark.parametrize("length", [PROMPT, 16])
def test_forward_logits_match_reference(pair, length):
    toks = pair.tokens(0, length)
    want, _ = pair.ref.forward(pair.ref_params, jnp.asarray(toks))
    got, aux = pair.api.forward(pair.params, torch.from_numpy(toks))
    assert got.shape == (BATCH, length, pair.cfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want)


def test_prefill_cache_and_logits_match_reference(pair):
    toks = pair.tokens(1, PROMPT)
    want_cache, want = ref_prefill_step(pair.ref, MAX_LEN)(
        pair.ref_params, {"tokens": jnp.asarray(toks)})
    cache, got = make_prefill_step(pair.api, MAX_LEN)(
        pair.params, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    for name in _cache_names(pair):
        assert cache[name].dtype == (torch.float32 if name in ("state", "conv")
                                     else pair.params.embed.dtype)
        _close(cache[name], want_cache[name])
    if pair.cfg.family == "hybrid":
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
    for name in _cache_names(pair):
        _close(cache[name], ref_cache[name], STATE_TOL)
    assert cache["t"] == int(ref_cache["t"]) == PROMPT + STEPS


def test_prefill_then_decode_equals_forward(pair):
    """The port's own decode invariant: prefill(prompt) + decode(next) ≡
    forward(prompt + next) at the last position."""
    toks = torch.from_numpy(pair.tokens(3, PROMPT + 1))
    full, _ = pair.api.forward(pair.params, toks)
    cache, last = pair.api.prefill(pair.params, toks[:, :PROMPT], MAX_LEN)
    _close(last[:, 0], full[:, PROMPT - 1])
    logits, _ = pair.api.decode_step(pair.params, cache, toks[:, PROMPT:])
    _close(logits[:, 0], full[:, -1])


def test_plain_path_matches_kernel_path(pair):
    """``use_kernel=False`` (the reference's chunked scan and masked
    attention) against the kernel path (on the CPU, the kernels' plain
    versions): the comparison the card runs at full size."""
    toks = torch.from_numpy(pair.tokens(4, 16))
    cache_k, logits_k = pair.api.prefill(pair.params, toks, MAX_LEN)
    cache_p, logits_p = pair.api.prefill(pair.params, toks, MAX_LEN,
                                         use_kernel=False)
    _close(logits_k, logits_p)
    tok = torch.argmax(logits_k[:, -1], dim=-1).to(torch.int32)[:, None]
    for _ in range(3):
        logits_k, _ = pair.api.decode_step(pair.params, cache_k, tok)
        logits_p, _ = pair.api.decode_step(pair.params, cache_p, tok,
                                           use_kernel=False)
        _close(logits_k, logits_p)
        tok = torch.argmax(logits_k[:, -1], dim=-1).to(torch.int32)[:, None]


def test_decode_writes_the_cache_in_place(pair):
    cache, logits = pair.api.prefill(
        pair.params, torch.from_numpy(pair.tokens(5, PROMPT)), MAX_LEN)
    before = {n: cache[n] for n in _cache_names(pair)}
    old_state = cache["state"].clone()
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    _, out = pair.api.decode_step(pair.params, cache, tok)
    assert out is cache
    for name, tensor in before.items():
        assert out[name] is tensor
    assert not torch.equal(cache["state"], old_state)
    if pair.cfg.family == "hybrid":
        assert int(cache["pos"][PROMPT]) == PROMPT
        assert float(cache["k"][:, :, PROMPT].abs().sum()) > 0
        assert float(cache["k"][:, :, PROMPT + 1:].abs().sum()) == 0


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_bf16_serving_matches_reference(name):
    pair = _pair(name, "bfloat16")
    for layer in pair.params.layers:
        for leaf in ("A_log", "D", "dt_bias"):
            assert layer.ssm[leaf].dtype == torch.bfloat16
    _check_decode(pair, pair.tokens(6, PROMPT), 3, MAX_LEN, BF16_TOL)


@pytest.mark.parametrize("window", [8, 5])
def test_hybrid_ring_decodes_past_the_window(window):
    """A ring of ``window`` slots: the prompt overflows it and the decode
    steps wrap it; logits, tokens, the ring and the states match the
    reference."""
    pair = _pair("zamba2-2.7b", sliding_window=window)
    port_toks, ref_toks, cache, ref_cache = _check_decode(
        pair, pair.tokens(7, PROMPT), STEPS, MAX_LEN, F32_TOL)
    for got, want in zip(port_toks, ref_toks):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cache["k"].shape[2] == window
    _close(cache["v"], ref_cache["v"], STATE_TOL)
    _close(cache["state"], ref_cache["state"], STATE_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_serving_steps_serve_the_family(name):
    """``make_prefill_step`` and ``make_decode_step`` are generic over the
    ``ModelApi``: a few greedy steps from random weights give valid tokens
    and advance the cache."""
    api = get_model(ARCHS[name].reduced())
    params = api.init_params(torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    toks = torch.randint(0, api.cfg.vocab_size, (BATCH, PROMPT),
                         generator=torch.Generator().manual_seed(1))
    cache, logits = make_prefill_step(api, MAX_LEN)(params, {"tokens": toks})
    assert logits.shape == (BATCH, 1, api.cfg.vocab_size)
    serve = make_decode_step(api)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    for _ in range(3):
        tok, cache = serve(params, cache, tok)
        assert tok.shape == (BATCH, 1) and tok.dtype == torch.int32
        assert ((tok >= 0) & (tok < api.cfg.vocab_size)).all()
    assert cache["t"] == PROMPT + 3
    assert torch.isfinite(cache["state"]).all()


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_random_init_has_the_reference_shapes(name):
    cfg = ARCHS[name].reduced()
    ref_params = ref_get_model(REF_ARCHS[name].reduced()).init_params(
        jax.random.PRNGKey(0), jnp.float32)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        torch.bfloat16, "cpu")
    stack = ref_params["layers" if cfg.family == "ssm" else "mamba"]
    lead = 1 if cfg.family == "ssm" else 2
    n_layers = int(np.prod(stack["norm"].shape[:lead]))
    assert len(params.layers) == n_layers == cfg.n_layers
    assert params.embed.shape == ref_params["embed"].shape
    ssm_p = params.layers[0].ssm
    assert set(ssm_p) == set(stack["ssm"])
    for leaf, p in ssm_p.items():
        assert p.shape == stack["ssm"][leaf].shape[lead:]
        assert p.dtype == torch.bfloat16 and not p.requires_grad
    np.testing.assert_allclose(ssm_p["A_log"].float().numpy(),
                               np.asarray(stack["ssm"]["A_log"][(0,) * lead]),
                               rtol=1e-2)
    if cfg.family == "hybrid":
        shared = ref_params["shared"]
        assert set(params.shared.attn) == set(shared["attn"])
        for leaf, p in params.shared.mlp.items():
            assert p.shape == shared["mlp"][leaf].shape
    else:
        assert params.shared is None
