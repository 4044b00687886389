"""One run of one cell: set-up, the measured window, the check, the result.

Set-up builds the port's model (``repro_torch.models.transformer``) with
the benchmark's weights and warms every prompt length the mix sends (and
the decode step, if it decodes) on prompts the window never sends.  The
window then drives the port's entry (``repro_torch.launch.steps``:
``make_prefill_step`` and ``make_decode_step``) in a closed loop for
``seconds``, each request's prompts drawn anew from the seed and its index,
copying every token to the host as it is served.  After the window the
port's state is freed and the plain reference judges a sample of the
requests the window finished (``check.py``).

Traced runs (``trace=True``) profile a fixed slice at the window's start
and report the per-layer metrics that the readers in ``metrics/`` take
from it; untraced runs report the end-to-end metrics.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from . import check, trace as tracing
from .reference import load as load_reference
from .traffic import Traffic
from .weights import load_into_port, make, prompt_seed

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_STEPS = 2          # decode steps of the first request run in set-up


@dataclass
class Cell:
    name: str
    config: dict
    traffic: Traffic
    spec: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    here = root / "portbench"
    config = json.loads((here / "configs" / f"{entry['config']}.json")
                        .read_text())
    return Cell(name, config, Traffic.load(entry["traffic"], here),
                json.loads((here / "workloads" / f"{name}.json").read_text()),
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Record:
    """One request: its index and prompt length, when it was issued, when
    each of its token rows reached the host, the rows, and the port's
    logits (B, V) at the last prompt position."""
    index: int
    prompt_len: int
    gen_len: int
    issue: float = 0.0
    arrivals: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    in_window: bool = True
    logits: torch.Tensor | None = None

    @property
    def done(self) -> bool:
        return len(self.tokens) == self.gen_len


class Port:
    """The system under test: the port's model with the benchmark's
    weights, and its prefill and decode entries."""

    def __init__(self, config: dict, traffic: Traffic, seed: int, device):
        from repro_torch.configs.base import ArchConfig
        from repro_torch.launch import steps
        from repro_torch.models.transformer import get_model
        self.dtype = getattr(torch, config["precision"])
        arch = ArchConfig(name=config["name"], **config["arch"])
        self.api = get_model(arch)
        self.params = self.api.init_params(None, self.dtype, "meta")
        leaves = load_reference(config["reference"]).params(config["arch"])
        load_into_port(self.params, make(leaves, seed, self.dtype, device))
        self.prefill = {s: steps.make_prefill_step(self.api,
                                                   traffic.max_len(s))
                        for s in traffic.shapes()}
        self.decode = steps.make_decode_step(self.api)


def request_prompts(config: dict, batch: int, length: int, seed: int,
                    index: int, device, gen=None) -> torch.Tensor:
    """Request ``index``'s prompts (B, L) int32, drawn on the device from
    the seed and the index alone."""
    if gen is None:
        gen = torch.Generator(device=device)
    gen.manual_seed(prompt_seed(seed, index))
    return torch.randint(0, config["arch"]["vocab_size"], (batch, length),
                         generator=gen, device=device, dtype=torch.int32)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The closed loop over the port's entries, one request at a time."""

    def __init__(self, port: Port, config: dict, traffic: Traffic, seed: int,
                 device):
        self.port, self.config, self.traffic = port, config, traffic
        self.seed, self.device = seed, device
        self.gen = torch.Generator(device=device)
        self.requests = traffic.requests(seed)
        self.records: list[Record] = []
        self.cache = self.tok = self.cur = None
        self.host_issue: list = []            # (seconds, profiled) a step
        self.host_prefill: list = []          # the same, a prefill
        self.units: list = []                 # what the first slice ran
        self.tracing = 0                      # the slice running, 1 or 2

    def start_request(self, in_window: bool = True) -> None:
        req = next(self.requests)
        rec = Record(req.index, req.prompt_len, req.gen_len,
                     in_window=in_window)
        self.records.append(rec)
        self.cache = self.tok = None
        tokens = request_prompts(self.config, req.batch, req.prompt_len,
                                 self.seed, req.index, self.device, self.gen)
        rec.issue = time.perf_counter()
        with record_function("pb.prefill"):
            self.cache, logits = self.port.prefill[req.prompt_len](
                self.port.params, {"tokens": tokens})
        self.host_prefill.append((time.perf_counter() - rec.issue,
                                  bool(self.tracing)))
        with record_function("pb.first_token"):
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            host = tok.cpu()
        self._arrive(rec, host)
        rec.logits = logits[:, -1]
        if self.tracing == 1:
            self.units.append(("prefill", req.batch, req.prompt_len))
        self.tok = tok[:, None]
        self.cur = rec
        if rec.done:
            self._finish()

    def step(self) -> None:
        rec = self.cur
        n_valid = rec.prompt_len + len(rec.tokens)
        t = time.perf_counter()
        with record_function("pb.decode_step"):
            self.tok, self.cache = self.port.decode(self.port.params,
                                                    self.cache, self.tok)
        self.host_issue.append((time.perf_counter() - t,
                                bool(self.tracing)))
        with record_function("pb.token_copy"):
            host = self.tok.cpu()
        self._arrive(rec, host[:, 0])
        if self.tracing == 1:
            self.units.append(("decode", host.shape[0], n_valid))
        if rec.done:
            self._finish()

    def _arrive(self, rec: Record, host: torch.Tensor) -> None:
        rec.arrivals.append(time.perf_counter())
        rec.tokens.append(host.numpy())

    def _finish(self) -> None:
        self.cur = self.cache = self.tok = None

    def next_unit(self) -> None:
        """One step of the current request, or a new request."""
        if self.cur is None:
            self.start_request()
        else:
            self.step()


def warm_up(loop: Loop, device) -> None:
    """Run every shape the window will use once.  A mix whose first
    request is prefilled in set-up starts it here and runs its first
    decode steps; otherwise each prompt length is prefilled once (and
    decoded once, if the mix decodes) on prompts of that length that the
    window never sends (negative indices)."""
    tr = loop.traffic
    if tr.prefill_first_in_setup:
        loop.start_request(in_window=False)
        for _ in range(min(WARM_STEPS, tr.gen_len - 1)):
            loop.step()
    else:
        for i, s in enumerate(tr.shapes()):
            tokens = request_prompts(loop.config, tr.batch, s, loop.seed,
                                     -1 - i, loop.device, loop.gen)
            cache, logits = loop.port.prefill[s](loop.port.params,
                                                 {"tokens": tokens})
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            if tr.gen_len > 1:
                tok, cache = loop.port.decode(loop.port.params, cache, tok)
            tok.cpu()
            del cache, logits, tok, tokens
    _sync(device)
    loop.host_issue.clear()
    loop.host_prefill.clear()


def window(loop: Loop, seconds: float, slice_units: int | None):
    """Drive the loop for ``seconds``.  With ``slice_units``, profile that
    many requests or decode steps from the window's start (the device's
    operations), then a quarter as many with the host's operations too.
    Returns (start, the last arrival in the window, the two slices)."""
    slices = []
    plan = [] if not slice_units else [
        (tracing.Slice(host=False), slice_units),
        (tracing.Slice(host=True), max(1, slice_units // 4))]
    t0 = time.perf_counter()
    deadline = t0 + seconds
    left = 0
    while time.perf_counter() < deadline:
        if not left and plan:
            current, left = plan.pop(0)
            current.start()
            slices.append(current)
            loop.tracing = len(slices)
        loop.next_unit()
        if left:
            left -= 1
            if not left:
                current.stop()
                loop.tracing = 0
    if left:
        current.stop()
        loop.tracing = 0
    last = max((a for r in loop.records for a in r.arrivals if a >= t0),
               default=t0)
    return t0, last, slices


def finish_in_flight(loop: Loop, limit_s: float = 60.0) -> None:
    """If the window finished no request, run the one it left in flight to
    its end, untimed, for at most ``limit_s``: late is not wrong, and the
    check needs a finished request."""
    if any(r.done for r in loop.records) or loop.cur is None:
        return
    end = time.perf_counter() + limit_s
    while loop.cur is not None and time.perf_counter() < end:
        loop.step()


def end_to_end(loop: Loop, t0: float, last: float) -> dict:
    """Every end-to-end quantity the window gives (the cell reports those
    ``BENCHMARK.json`` names for it)."""
    span = max(last - t0, 1e-9)
    recs = [r for r in loop.records if r.arrivals]
    ttft = [(r.arrivals[0] - r.issue) * 1e3 for r in recs if r.in_window]
    gaps, generated = [], 0
    for r in recs:
        times = [a for a in r.arrivals if t0 <= a <= last]
        generated += len(times) * r.tokens[0].shape[0]
        gaps += [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    prompt_tokens = sum(r.prompt_len * r.tokens[0].shape[0]
                        for r in recs if r.in_window)
    out = {"prefill_tok_s": prompt_tokens / span,
           "decode_tok_s": generated / span}
    if ttft:
        out["ttft_p95_ms"] = float(np.percentile(ttft, 95))
    if gaps:
        out["tpot_p95_ms"] = float(np.percentile(gaps, 95))
    return out


def sample(loop: Loop, n: int, seed: int) -> list[Record]:
    """Up to n finished requests, drawn from the seed, one of the longest
    among them; each keeps its logits rows, on the host, and no other."""
    recs = [r for r in loop.records if r.done]
    chosen = []
    if recs:
        longest = max(recs, key=lambda r: (r.prompt_len + r.gen_len,
                                           -r.index))
        rest = [r for r in recs if r is not longest]
        rng = np.random.default_rng(seed)
        pick = rng.permutation(len(rest))[:max(n - 1, 0)]
        chosen = [longest] + [rest[i] for i in sorted(pick)]
    keep = {id(r) for r in chosen}
    for r in loop.records:
        r.logits = r.logits.float().cpu() if id(r) in keep else None
    return chosen


def judge(cell: Cell, seed: int, chosen: list, device,
          control: bool = False) -> dict:
    """Run the reference over the sampled requests (their prompts drawn
    again from the seed and their indices): the logit gaps of the served
    tokens, how many were compared, and the error of the port's logits row
    at each prompt's last position against the reference's; with
    ``control``, the same of the fp8 control in the port's place."""
    j = check.Judge(cell.config, seed, device)
    batch = cell.traffic.batch
    ours, theirs = [], []
    for rec in chosen:
        prompts = request_prompts(cell.config, batch, rec.prompt_len, seed,
                                  rec.index, device)
        served = torch.from_numpy(np.stack(rec.tokens, axis=1)).to(device)
        got = j.gaps(prompts, served, control)
        ours.append((got["gaps"], check.row_errors(rec.logits.to(device),
                                                   got["rows"])))
        if control:
            theirs.append((got["control_gaps"],
                           check.row_errors(got["control_rows"],
                                            got["rows"])))
    found = {"tokens_checked": sum(g.numel() for g, _ in ours),
             "tokens_off_best": sum(int((g > 0).sum()) for g, _ in ours)}
    for prefix, pairs in (("", ours), ("control_", theirs)):
        if pairs:
            g = torch.cat([g for g, _ in pairs])
            err = torch.cat([e for _, e in pairs])
            found[prefix + "max_logit_gap"] = float(g.max())
            found[prefix + "mean_logit_gap"] = float(g.mean())
            found[prefix + "max_row_err"] = float(err[:, 0].max())
            found[prefix + "rms_row_err"] = float(err[:, 1].max())
            found[prefix + "mid_row_err"] = float(err[:, 1].median())
    return found


def device_info(device) -> dict:
    d = torch.device(device)
    info = {"platform": "gpu" if d.type == "cuda" else d.type,
            "kind": torch.cuda.get_device_name(d) if d.type == "cuda"
            else "cpu", "count": 1,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    if d.type == "cuda":
        try:
            out = subprocess.run(
                ["nvidia-smi", "-i", str(d.index or 0),
                 "--query-gpu=power.limit,clocks.sm,clocks.max.sm,"
                 "power.draw,temperature.gpu",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=20).stdout
            vals = [v.strip() for v in out.strip().split(",")]
            for key, v in zip(("power_limit_w", "sm_clock_mhz",
                               "sm_clock_max_mhz", "power_draw_w",
                               "temperature_c"), vals):
                info[key] = float(v)
        except (OSError, ValueError, subprocess.SubprocessError):
            pass
    return info


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def within(compared: dict) -> bool:
    """``correct``: enough tokens checked, and every other number at or
    under its limit."""
    return compared["tokens_checked"]["value"] >= \
        compared["tokens_checked"]["limit"] and all(
            c["value"] <= c["limit"] for n, c in compared.items()
            if n != "tokens_checked")


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False) -> tuple[dict, dict]:
    """One run.  Returns the result (without its ``checks`` key) and the
    numbers compared with their limits; ``control`` (for
    ``calibrate.py`` only) adds the control's readings to the latter."""
    marks = [time.perf_counter()]
    port = Port(cell.config, cell.traffic, seed, device)
    loop = Loop(port, cell.config, cell.traffic, seed, device)
    _sync(device)
    marks.append(time.perf_counter())
    warm_up(loop, device)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    print(f"portbench: set-up: start to harness {marks[0] - t_start:.3f} s, "
          f"model {marks[1] - marks[0]:.3f} s, warm-up "
          f"{marks[2] - marks[1]:.3f} s", file=sys.stderr, flush=True)
    slice_units = int(cell.spec["trace"]["units"]) if traced else None
    t0, last, slices = window(loop, seconds, slice_units)
    _sync(device)
    finish_in_flight(loop)
    dev = device_info(device)
    if torch.device(device).type == "cuda":
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    else:
        dev["memory_peak_bytes"] = 0
    metrics = {}
    breakdown = None
    if traced:
        reading = slices[0].reading(cell.config["arch"], loop.units)
        reading.host_issue_ms = [1e3 * s for s, tr in loop.host_issue
                                 if not tr]
        reading.host_prefill_ms = [1e3 * s for s, tr in loop.host_prefill
                                   if not tr]
        dev["busy_s"] = reading.busy_s
        dev["window_s"] = reading.window_s
        breakdown = {"device_ops": reading.top_ops,
                     "idle_gaps": slices[-1].idle_gaps()}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = end_to_end(loop, t0, last)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    attempted = cell.traffic.batch * sum(
        1 for r in loop.records if r.in_window or r.arrivals[-1] >= t0)
    host_ms = [1e3 * s for s, tr in loop.host_prefill if not tr]
    print(f"portbench: window: {len(loop.records)} requests, host issue "
          f"{np.mean(host_ms) if host_ms else float('nan'):.3f} ms a prefill "
          f"(mean)", file=sys.stderr, flush=True)
    chosen = sample(loop, int(cell.spec["check"]["requests"]), seed)
    del port, loop, slices
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    found = judge(cell, seed, chosen, device, control)
    print(f"portbench: set-up {setup_s:.3f} s, window {last - t0:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s over "
          f"{len(chosen)} requests; readings {json.dumps(found)}",
          file=sys.stderr, flush=True)
    limits = cell.spec["check"]
    compared = {"tokens_checked": {"value": found["tokens_checked"],
                                   "limit": int(limits["min_tokens"])}}
    for name in check.COMPARED:
        if name in limits:
            compared[name] = {"value": found.get(name, float("inf")),
                              "limit": float(limits[name])}
    correct = within(compared)
    if control:
        # the control in the port's place, held to the same limits
        ctrl = {n: {"value": found.get("control_" + n, float("inf")),
                    "limit": c["limit"]} for n, c in compared.items()
                if n != "tokens_checked"}
        ctrl["tokens_checked"] = compared["tokens_checked"]
        compared["control_correct"] = {"value": within(ctrl), "limit": None}
        for name, value in found.items():
            if name != "tokens_off_best":
                compared.setdefault(name, {"value": value, "limit": None})
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": 0, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, compared
