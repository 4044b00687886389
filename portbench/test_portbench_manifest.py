"""BENCHMARK.json against the benchmark's contract, and every cell against
its files: each resolves to a configuration, a traffic mix, a cell file and
a reader for each per-layer metric it reports, by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import harness
from portbench.traffic import Traffic

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer"):
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200
                    assert "\n" not in text and "\t" not in text
    assert len(names) == len(set(names))
    for cfg in BENCH["configs"]:
        assert all(NAME.match(k) for k in cfg["reduced"])


def test_metrics_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert harness._reports(e2e[m["moves"]], cell), (m, cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.load_cell(cell, ROOT)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert c.config["name"] == entry["config"]
    assert c.config["precision"] == "bfloat16"
    assert isinstance(c.traffic, Traffic)
    check = c.spec["check"]
    assert {"requests", "min_tokens"} <= set(check)
    assert {"max_logit_gap", "mean_logit_gap"} & set(check)
    assert int(c.spec["trace"]["units"]) >= 1
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"], ROOT))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    path = ROOT / cfg["file"]
    assert path.parts[len(ROOT.parts)] == "portbench"
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_weights_name_every_leaf_of_the_port(cfg):
    """The benchmark's leaves are the port's, name, shape and type, at the
    configuration's full size (the port's model built on the meta
    device)."""
    import torch
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.transformer import get_model

    from portbench import reference
    data = json.loads((ROOT / cfg["file"]).read_text())
    model = get_model(ArchConfig(name=data["name"], **data["arch"])) \
        .init_params(None, torch.bfloat16, "meta")
    held = {n: (tuple(t.shape), t.dtype) for n, t in
            list(model.named_parameters()) + list(model.named_buffers())}
    leaves = reference.load(data["reference"]).params(data["arch"])
    made = {leaf.name: (leaf.shape, torch.float32 if leaf.dtype == "float32"
                        else torch.bfloat16) for leaf in leaves}
    assert made == held


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "workloads")
                                        .glob("*.json")), ids=lambda p: p.stem)
def test_every_cell_file(path):
    from portbench import check
    spec = json.loads(path.read_text())
    assert {"requests", "min_tokens"} <= set(spec["check"])
    assert {"max_logit_gap", "mean_logit_gap"} & set(spec["check"])
    assert set(spec["check"]) <= {"requests", "min_tokens", *check.COMPARED}
    assert int(spec["trace"]["units"]) >= 1


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "traffic")
                                        .glob("*.json")), ids=lambda p: p.stem)
def test_every_traffic_mix(path):
    t = Traffic.load(path.stem, ROOT / "portbench")
    assert len(t.lengths()) == t.cycle
    assert all(t.len_min <= n <= t.len_max for n in t.lengths())


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "traffic")
                                        .glob("*.json")), ids=lambda p: p.stem)
def test_every_order_is_stratified(path):
    """Each cycle's order is a permutation of its lengths, and any 2^j
    requests aligned in a cycle hold one length of each 2^j-th of the
    sorted lengths, whatever the seed's mask."""
    t = Traffic.load(path.stem, ROOT / "portbench")
    for mask in range(t.cycle):
        order = t.order(mask)
        assert sorted(order) == list(range(t.cycle))
        size = 1
        while size <= t.cycle:
            stratum = t.cycle // size
            for start in range(0, t.cycle, size):
                got = sorted(p // stratum for p in order[start:start + size])
                assert got == list(range(size)), (mask, size, start)
            size *= 2


def test_a_partial_cycle_does_nearly_the_same_work_for_every_seed():
    """The prompt tokens of a window's first n requests differ between
    seeds by less than the longest prompt less the shortest, at any n (a
    random order of each cycle differs by several requests' worth)."""
    import itertools
    t = Traffic.load("prefill_b2_1k_4k", ROOT / "portbench")
    runs = []
    for seed in (2**33 + 1, 2**40 + 7, 12345, 2**31 + 99):
        lens = [r.prompt_len for r in
                itertools.islice(t.requests(seed), 3 * t.cycle)]
        runs.append(list(itertools.accumulate(lens)))
    for n in range(3 * t.cycle):
        spread = max(r[n] for r in runs) - min(r[n] for r in runs)
        assert spread < t.len_max - t.len_min, n
    assert [r.index for r in itertools.islice(t.requests(5), 70)] == \
        list(range(70))
