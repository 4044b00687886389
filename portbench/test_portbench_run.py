"""``run.py`` refuses to run without a card, and a run whose timed path is
broken underneath comes out not correct.

The second drives all of a run but the look for a card (``harness.run``)
on the CPU at a tiny size, with the port's steps wrapped to plant each
fault a cell can have: a token altered where it is produced, a decode
step that leaves the cache as it was, and half of a prefill's batch left
out (the other half's results copied in).  Each must read ``correct``
false against the limits of its cell file (``workloads/<cell>.json``;
the decode mix against the decode cell's file, which PERF.md keeps for a
later cell).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.traffic import Traffic

ROOT = Path(__file__).resolve().parents[1]

TINY = {"decoder": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_head=16, vocab_size=1024, n_experts=8, top_k=2,
                        d_expert=32),
        "hybrid": dict(n_layers=4, attn_every=2, d_model=64, n_heads=4,
                       n_kv_heads=4, d_head=16, d_ff=128, vocab_size=1024,
                       ssm_state=16, ssm_headdim=16, ssm_chunk=8)}


def test_run_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "olmoe-prefill-b4",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "no CUDA card" in proc.stderr


def tiny_cell(config: str, workload: str, traffic: Traffic, arch: dict,
              requests: int) -> harness.Cell:
    """The cell file ``workload``'s check on configuration ``config`` cut
    to ``arch``, under ``traffic``, with ``requests`` to check."""
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json")
                     .read_text())
    cfg["arch"] = {**cfg["arch"], **arch}
    spec = json.loads((ROOT / "portbench" / "workloads" / f"{workload}.json")
                      .read_text())
    spec["check"].update(requests=requests, min_tokens=1)
    return harness.Cell(workload, cfg, traffic, spec, [], [])


DECODE = Traffic("t", 4, "fixed", 24, 24, 8, 6, 2, True)
PREFILL = Traffic("t", 4, "uniform", 16, 32, 8, 1, 4, False)
CELLS = {"olmoe-decode": ("olmoe-1b-7b", "olmoe-decode-b64", DECODE),
         "olmoe-prefill": ("olmoe-1b-7b", "olmoe-prefill-b4", PREFILL),
         "zamba2-prefill": ("zamba2-2.7b", "zamba2-prefill-b2", PREFILL),
         "zamba2-decode": ("zamba2-2.7b", "zamba2-prefill-b2", DECODE)}


def _tiny(name: str) -> harness.Cell:
    config, workload, traffic = CELLS[name]
    kind = "hybrid" if config.startswith("zamba2") else "decoder"
    return tiny_cell(config, workload, traffic, TINY[kind], 3)


def _bump(logits: torch.Tensor) -> torch.Tensor:
    """Logits whose argmax has moved to the next word."""
    out = logits.clone()
    top = out[:, -1].argmax(-1)
    out[:, -1].scatter_(1, ((top + 1) % out.shape[-1])[:, None], 1e4)
    return out


def _altered_decode(make):
    def build(api):
        step = make(api)

        def broken(params, cache, tokens):
            tok, cache = step(params, cache, tokens)
            return (tok + 1) % api.cfg.vocab_size, cache
        return broken
    return build


def _stale_decode(make):
    def build(api):
        step = make(api)

        def broken(params, cache, tokens):
            kept = {k: v.clone() for k, v in cache.items()
                    if isinstance(v, torch.Tensor)}
            tok, cache = step(params, cache, tokens)
            for k, v in kept.items():
                cache[k].copy_(v)
            return tok, cache
        return broken
    return build


def _altered_prefill(make):
    def build(api, max_len):
        step = make(api, max_len)

        def broken(params, batch):
            cache, logits = step(params, batch)
            return cache, _bump(logits)
        return broken
    return build


def _half_prefill(make):
    def build(api, max_len):
        step = make(api, max_len)

        def broken(params, batch):
            tokens = batch["tokens"]
            half = tokens.shape[0] // 2
            cache, logits = step(params, {"tokens": tokens[:half]})
            whole = {k: (torch.cat([v, v], dim=v.dim() - 4)
                         if isinstance(v, torch.Tensor) and v.dim() >= 4
                         else v) for k, v in cache.items()}
            return whole, torch.cat([logits, logits], 0)
        return broken
    return build


SEED = 2**35 + 17


@pytest.fixture(scope="module")
def sound_runs():
    """Each tiny cell's run with nothing broken, once a module."""
    return {}


@pytest.mark.parametrize("cell,entry,fault", [
    ("olmoe-decode", "make_decode_step", _altered_decode),
    ("olmoe-decode", "make_decode_step", _stale_decode),
    ("olmoe-decode", "make_prefill_step", _half_prefill),
    ("olmoe-prefill", "make_prefill_step", _altered_prefill),
    ("olmoe-prefill", "make_prefill_step", _half_prefill),
    ("zamba2-prefill", "make_prefill_step", _altered_prefill),
    ("zamba2-prefill", "make_prefill_step", _half_prefill),
    ("zamba2-decode", "make_decode_step", _stale_decode),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, sound_runs, cell,
                                            entry, fault):
    from repro_torch.launch import steps
    c = _tiny(cell)
    if cell not in sound_runs:
        sound_runs[cell] = harness.run(c, SEED, 0.1, False, "cpu",
                                       time.perf_counter())
    sound, compared = sound_runs[cell]
    assert sound["correct"], json.dumps(compared)
    monkeypatch.setattr(steps, entry, fault(getattr(steps, entry)))
    broken, compared = harness.run(c, SEED, 0.1, False, "cpu",
                                   time.perf_counter())
    assert not broken["correct"], json.dumps(compared)


def test_every_request_sends_new_prompts():
    """Each request's prompts come from the seed and its index alone: the
    same pair gives the same tokens, and no two indices of a window, nor a
    warm-up index (negative), give the same."""
    cfg = {"arch": {"vocab_size": 50304}}
    seed = 2**33 + 5
    seen = set()
    for index in list(range(64)) + [-1 - i for i in range(13)]:
        p = harness.request_prompts(cfg, 2, 16, seed, index, "cpu")
        assert torch.equal(p, harness.request_prompts(cfg, 2, 16, seed,
                                                      index, "cpu"))
        seen.add(tuple(p.flatten().tolist()))
    assert len(seen) == 64 + 13


def test_a_run_checks_distinct_requests_and_their_logits_rows():
    """A tiny run samples requests of distinct indices, each with the
    port's logits rows kept on the host, and reports the rows' errors."""
    c = _tiny("olmoe-prefill")
    loop_records = []
    real = harness.sample

    def spy(loop, n, seed):
        chosen = real(loop, n, seed)
        loop_records.extend(chosen)
        return chosen
    import unittest.mock as mock
    with mock.patch.object(harness, "sample", spy):
        result, compared = harness.run(c, SEED, 0.1, False, "cpu",
                                       time.perf_counter())
    assert result["correct"], json.dumps(compared)
    assert len({r.index for r in loop_records}) == len(loop_records) >= 2
    assert all(r.logits is not None and r.logits.device.type == "cpu"
               for r in loop_records)


def test_row_errors_by_hand():
    from portbench import check
    ref = torch.tensor([[1.0, -1.0, 1.0, -1.0], [0.0, 2.0, 0.0, -2.0]])
    rows = ref + torch.tensor([[0.0, 0.0, 0.0, 0.4], [0.2, 0.2, 0.2, 0.2]])
    err = check.row_errors(rows, ref)
    s0, s1 = ref[0].std(), ref[1].std()
    assert torch.allclose(err, torch.stack([
        torch.stack([0.4 / s0, 0.2 / s0]),
        torch.stack([0.2 / s1, 0.2 / s1])]))


@pytest.mark.parametrize("cell", ["olmoe-prefill", "zamba2-prefill"])
def test_the_control_in_the_port_s_place_is_not_correct(cell):
    """``run(control=True)`` holds the fp8 control to the cell's limits
    with the same rule as ``correct``, and it fails them."""
    c = _tiny(cell)
    result, compared = harness.run(c, SEED, 0.1, False, "cpu",
                                   time.perf_counter(), control=True)
    assert result["correct"], json.dumps(compared)
    assert compared["control_correct"]["value"] is False, \
        json.dumps(compared)
