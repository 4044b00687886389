"""The port's spans and counters (``repro_torch.tracing``) on the CPU.

Tracing off is a no-op: a prefill's logits and cache are the same bit for
bit with it on and off, and a profile taken with it off holds no ``rt.``
event.  On, each span of a prefill appears once a call of its layer,
inside its parent, and ``moe.pairs_kept`` equals a plain count of the
pairs the capacity keeps.  The MoE and hybrid models are the benchmark's
tiny cuts of olmoe-1b-7b and zamba2-2.7b (``portbench/test_portbench_run.py``);
the SSM model is mamba2-130m's ``reduced()``.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import ARCHS
from repro_torch.models import layers
from repro_torch.models.transformer import get_model

TINY = {"olmoe-1b-7b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            d_head=16, vocab_size=1024, n_experts=8, top_k=2,
                            d_expert=32),
        "zamba2-2.7b": dict(n_layers=4, attn_every=2, d_model=64, n_heads=4,
                            n_kv_heads=4, d_head=16, d_ff=128,
                            vocab_size=1024, ssm_state=16, ssm_headdim=16,
                            ssm_chunk=8)}
LENGTH = 24


def _cfg(arch: str):
    if arch in TINY:
        return dataclasses.replace(ARCHS[arch], **TINY[arch])
    return ARCHS[arch].reduced()


def _model(arch: str):
    cfg = _cfg(arch)
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(7)
    params = api.init_params(gen, torch.float32, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, LENGTH), generator=gen)
    return cfg, api, params, tokens


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.read_counters()
    yield
    tracing.disable()
    tracing.read_counters()


def _spans(arch: str, on: bool):
    """The prefill's outputs and its ``rt.`` events (name, start, end)
    under a CPU profile, with tracing on or off."""
    cfg, api, params, tokens = _model(arch)
    if on:
        tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = api.prefill(params, tokens, LENGTH + 8)
    tracing.disable()
    found = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(tracing.PREFIX)]
    return cfg, out, found


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-2.7b"])
def test_a_prefill_is_the_same_bit_for_bit_with_tracing_on(arch):
    cfg, api, params, tokens = _model(arch)
    cache_off, logits_off = api.prefill(params, tokens, LENGTH + 8)
    tracing.enable()
    cache_on, logits_on = api.prefill(params, tokens, LENGTH + 8)
    tracing.disable()
    assert torch.equal(logits_on, logits_off)
    assert cache_on.keys() == cache_off.keys()
    for key, value in cache_off.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(cache_on[key], value), key
        else:
            assert cache_on[key] == value, key


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-2.7b",
                                  "mamba2-130m"])
def test_no_span_is_recorded_with_tracing_off(arch):
    _, _, found = _spans(arch, on=False)
    assert found == []


def _parent(event, found):
    """The innermost other ``rt.`` event that holds ``event``."""
    holders = [f for f in found if f is not event and f[1] <= event[1]
               and event[2] <= f[2]]
    return min(holders, key=lambda f: f[2] - f[1])[0] if holders else None


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-2.7b",
                                  "mamba2-130m"])
def test_each_span_appears_once_a_call_inside_its_parent(arch):
    cfg, _, found = _spans(arch, on=True)
    n = cfg.n_layers
    if arch == "olmoe-1b-7b":
        want = {"rt.prefill": (1, None), "rt.moe": (n, "rt.prefill"),
                "rt.moe.dispatch": (n, "rt.moe"),
                "rt.moe.experts": (n, "rt.moe"),
                "rt.moe.combine": (n, "rt.moe"),
                "rt.count": (2 * n, "rt.moe.dispatch")}
    else:
        want = {"rt.prefill": (1, None), "rt.mamba": (n, "rt.prefill"),
                "rt.mamba.conv": (n, "rt.mamba"),
                "rt.mamba.gate": (n, "rt.mamba")}
    got = {}
    for event in found:
        count, parents = got.get(event[0], (0, set()))
        got[event[0]] = (count + 1, parents | {_parent(event, found)})
    assert got == {name: (count, {parent})
                   for name, (count, parent) in want.items()}


def test_pairs_kept_is_the_plain_count_under_the_capacity():
    """A capacity factor of 0.5 drops pairs; the counter keeps, for each
    expert, the pairs routed to it up to the capacity."""
    cfg = _cfg("olmoe-1b-7b")
    gen = torch.Generator().manual_seed(11)
    moe = layers.init_moe_params(gen, cfg, torch.float32, "cpu")
    x = torch.randn(3, 20, cfg.d_model, generator=gen)
    t = x.shape[0] * x.shape[1]
    tracing.enable()
    out, _ = layers.moe_layer(moe, x, cfg, capacity_factor=0.5)
    tracing.disable()
    got = tracing.read_counters()
    _, _, topk_e = layers.moe_route(moe.router, x.reshape(t, -1), cfg.top_k)
    cap = layers.moe_capacity(t, cfg, 0.5)
    per_expert = torch.bincount(topk_e.reshape(-1), minlength=cfg.n_experts)
    kept = int(per_expert.clamp(max=cap).sum())
    assert got == {"moe.pairs_routed": t * cfg.top_k, "moe.pairs_kept": kept}
    assert kept < t * cfg.top_k
    assert torch.equal(out, layers.moe_layer(moe, x, cfg,
                                             capacity_factor=0.5)[0])


def test_off_is_one_shared_no_op_and_computes_nothing():
    assert not tracing.on()
    assert tracing.span("moe") is tracing.span("mamba.conv")
    with tracing.span("moe") as inside:
        assert inside is None

    def never():
        raise AssertionError("a counter's value was computed with "
                             "tracing off")
    tracing.count("c", never)
    assert tracing.read_counters() == {}


def test_counters_add_host_ints_and_tensors_then_clear():
    tracing.enable()
    assert tracing.on()
    tracing.count("a", 3)
    tracing.count("a", lambda: 4)
    tracing.count("b", torch.tensor(5))
    tracing.count("b", torch.tensor([True, False, True]).sum)
    assert tracing.read_counters() == {"a": 7, "b": 7}
    assert tracing.read_counters() == {}
