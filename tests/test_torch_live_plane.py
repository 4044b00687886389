"""Port parity: ``LivePlane`` (the scenario engine's measured plane), the
live serve driver (``repro_torch.launch.serve``) and recovery on the live
engine, against the reference.

``ServingCell.execute`` is replaced in both packages by the same
deterministic service time per (model, cell type, batch bucket), the bucket
read from the batch's leading dimension whatever the model's input names.
The plane's episode clock, carries and probes are the same float64 host
code in both, so with equal streams every measurement, carry and probe rate
is equal bit for bit.  The streams are the port's, handed to the reference
as its ``Workload`` (``repro_torch``'s threefry arrivals lie within 4e-6
relative of the reference's, ROADMAP C-R8).  The serve driver realises its
own stream in each package; under the patched times its samples must
still be the reference's.  The reference's ``repro.serving`` is imported
inside a fixture with the temporary ``enable_x64`` alias, as in
``tests/test_torch_engine.py``.  Also here, ported: the reference's two
``LivePlane`` tests (``tests/test_scenario.py::
test_live_plane_episode_accounting_matches_engine_records`` with the real
smoke forwards on the CPU, and ``tests/test_plane_differential.py``
against the port's own ``SimulatorPlane``).
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import scenario as ts  # noqa: E402
from repro_torch.core import SearchSpace  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.scenario.planes import slice_stream  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pool as tpool  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402
from repro_torch.serving.instance import InstanceType, ModelProfile  # noqa: E402

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
MODELS = ["candle", "resnet50", "vgg19", "mtwnd", "dien"]
NAMES = ("cell1", "cell4", "cell8")
PRICES = (1.2, 4.8, 9.6)
SPEEDS = (1.0, 3.4, 6.0)
# Service-time scale per model: the conv nets slower than the recommenders.
MODEL_SCALE = {"candle": 0.5, "resnet50": 3.0, "vgg19": 6.0, "mtwnd": 1.0,
               "dien": 2.0}


@pytest.fixture(scope="module")
def ref():
    """The reference's modules this file holds the port to."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.launch import serve
        from repro.scenario import engine, planes, registry
        from repro.serving import engine as serving_engine
        from repro.serving import fault, workload
    from repro.core.search_space import SearchSpace as JSpace
    return {"serve": serve, "engine": engine, "planes": planes,
            "registry": registry, "eng": serving_engine, "fault": fault,
            "wl": workload, "Space": JSpace}


def _service_time(self, batch):
    """3 ms at batch 1 (scaled per model), growing with the bucket, divided
    by the cell's speed."""
    if self.failed:
        raise RuntimeError(f"cell {self.cell_type.name} is failed")
    bucket = int(next(iter(batch.values())).shape[0])
    self.n_served += 1
    return (0.003 * MODEL_SCALE[self.model_name]
            * (1.0 + 0.25 * np.log2(bucket)) / self.cell_type.speed)


@pytest.fixture
def patched(ref, monkeypatch):
    monkeypatch.setattr(ref["eng"].ServingCell, "execute", _service_time)
    monkeypatch.setattr(teng.ServingCell, "execute", _service_time)
    # The serve driver's cells at the smoke preset, as the reference's
    # DEFAULT_TPU_CELLS are (ROADMAP C-R6): the same names, prices, speeds.
    monkeypatch.setattr(tserve, "DEFAULT_CELLS", _cells(teng.CellType))
    return ref


def _cells(cls, n=3):
    return [cls(name, price=p, chips=1, preset="smoke", speed=s)
            for name, p, s in list(zip(NAMES, PRICES, SPEEDS))[:n]]


def _ref_workload(ref, w):
    return ref["wl"].Workload(arrivals=w.arrivals, batches=w.batches,
                              rate_qps=w.rate_qps)


def _stream(n=200, rate=300.0):
    return twl.WorkloadSpec(seed=0, rate_qps=rate, median_batch=8,
                            max_batch=32).realize(n)


def _planes(ref, wl, model="mtwnd", **kw):
    jeng = ref["eng"].ClusterEngine(model, _cells(ref["eng"].CellType, 2))
    teng_ = teng.ClusterEngine(model, _cells(teng.CellType, 2), device=CPU)
    jp = ref["planes"].LivePlane(jeng, {"lognormal": _ref_workload(ref, wl)},
                                 **kw)
    tp = ts.LivePlane(teng_, {"lognormal": wl}, **kw)
    return jp, tp


def _state(plane):
    s = plane._state
    return (None if s is None else (np.asarray(s.free).tolist(),
                                    float(s.clock)),
            plane._local_now, plane.last_carried_wait, plane._deployed)


CANDS = [(1, 0), (0, 1), (1, 1), (2, 1), (3, 2)]


@pytest.mark.parametrize("time_scale", [1.0, 0.5])
def test_measure_commit_and_oracles_equal_the_reference(patched, time_scale):
    wl = _stream()
    jp, tp = _planes(patched, wl, qos_latency=0.01, time_scale=time_scale,
                     probe_queries=40)
    jw = jp.workloads["lognormal"]
    for p in (jp, tp):
        p.begin_episode(carry=True)
        p.deploy((1, 1))
    got = tp.measure("lognormal", slice_stream(wl, 0, 120), (1, 1))
    want = jp.measure("lognormal", patched["planes"].slice_stream(jw, 0, 120),
                      (1, 1))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert _state(tp) == _state(jp)
    # A probe between measure and commit must not disturb the commit.
    assert tp.oracle("lognormal", 1.0)((2, 1)) == jp.oracle(
        "lognormal", 1.0)((2, 1))
    for p in (jp, tp):
        p.commit(90)
    assert _state(tp) == _state(jp)
    rates = {}
    for name, p in (("port", tp), ("ref", jp)):
        cold, warm = p.oracle("lognormal", 1.3), p.warm_oracle("lognormal",
                                                               1.3)
        rates[name] = ([cold(c) for c in CANDS], [warm(c) for c in CANDS])
    assert rates["port"] == rates["ref"]
    assert rates["port"][0] != rates["port"][1]        # a real backlog
    assert tp.n_evals == jp.n_evals == 2 * len(CANDS) + 1
    got_cs, want_cs = tp.candidate_state(), jp.candidate_state()
    assert got_cs[1] == want_cs[1]
    np.testing.assert_array_equal(got_cs[0].free, want_cs[0].free)
    assert got_cs[0].clock == want_cs[0].clock
    # Redeploy (the carry remapped), the next segment, commit it all.
    for p in (jp, tp):
        p.deploy((2, 1))
        p.advance_clock(0.0)
    got = tp.measure("lognormal", slice_stream(wl, 90, 200), (2, 1))
    want = jp.measure("lognormal",
                      patched["planes"].slice_stream(jw, 90, 200), (2, 1))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tp.last_carried_wait == jp.last_carried_wait > 0.0
    for p in (jp, tp):
        p.commit(110)
    assert _state(tp) == _state(jp)


def test_empty_pool_serves_nothing_and_keeps_the_carry(patched):
    wl = _stream(60)
    jp, tp = _planes(patched, wl, qos_latency=0.01)
    for p in (jp, tp):
        p.begin_episode(carry=True)
        p.deploy((1, 0))
        p.measure("lognormal", slice_stream(wl, 0, 30)
                  if p is tp else patched["planes"].slice_stream(
                      p.workloads["lognormal"], 0, 30), (1, 0))
        p.commit(30)
    before = _state(tp)
    assert before == _state(jp)
    lat, waits = tp.measure("lognormal", slice_stream(wl, 30, 60), (0, 0))
    assert np.isinf(lat).all() and np.isinf(waits).all() and len(lat) == 30
    tp.commit(30)
    assert _state(tp) == before


def test_live_plane_protocol_without_a_fast_path(patched):
    """No grid evaluator, no phase sweep, no window telemetry; routing
    policies are refused (the live plane dispatches FCFS)."""
    wl = _stream(40)
    _, tp = _planes(patched, wl, qos_latency=0.01)
    assert tp.name == "live" and tp.grid_evaluator("lognormal") is None
    assert tp.phase_sweep((1, 1), []) is None
    assert tp.window_telemetry(0, 10) is None
    assert tp.type_tiers == ("on_demand", "on_demand")
    assert tp.base_rate == wl.rate_qps
    tp.begin_episode(carry=True)
    with pytest.raises(ValueError, match="routing"):
        tp.measure("lognormal", wl, (1, 1), policy="hedged")
    with pytest.raises(ValueError, match="routing"):
        tp.oracle("lognormal", 1.0, policy="hedged")
    tp.apply_price(0, 2.0)
    assert tp.engine.cell_types[0].price == 2.0
    # the engine's own copy: the caller's cell types keep their prices
    assert teng.DEFAULT_CELLS[0].price == 1.2
    cells = _cells(teng.CellType, 2)
    engine = teng.ClusterEngine("mtwnd", cells, device=CPU)
    ts.LivePlane(engine, {"lognormal": wl}, 0.01).apply_price(1, 7.0)
    assert engine.pool_price((0, 1)) == 7.0 and cells[1].price == 4.8
    tp.configure((2, 1))
    tp.apply_capacity_loss(0, 1)
    assert tp.engine.active_config() == (1, 1)


class _Served:
    """The latencies of every segment the plane measured, as the engine's
    own records held them right after its serve, cut to the prefix the
    scenario engine committed (the first ``commit`` after each
    ``measure``).  Concatenated, they are the episode's served queries in
    order; search probes, which serve but never commit, stay out."""

    def __init__(self, plane):
        self.segments = []
        measure, commit = plane.measure, plane.commit

        def spy_measure(*args, **kwargs):
            out = measure(*args, **kwargs)
            lat = plane.engine.served_arrays()[0]
            # an empty pool serves nothing: the plane's +inf latencies
            self.segments.append([lat if len(lat) == len(out[0])
                                  else out[0], None])
            return out

        def spy_commit(n):
            if self.segments and self.segments[-1][1] is None:
                self.segments[-1][1] = int(n)
            return commit(n)

        plane.measure, plane.commit = spy_measure, spy_commit

    def latencies(self) -> np.ndarray:
        return np.concatenate([lat[:n] for lat, n in self.segments])


def check_accounting(rep, served: _Served, qos_latency: float) -> None:
    """The report's QoS, per window, per phase and overall, equals the
    share of the engine's records within ``qos_latency``, exactly."""
    lat = served.latencies()
    d = rep.to_dict()
    assert len(lat) == d["total_queries"]
    hit = lat <= qos_latency
    for w in d["windows"]:
        assert w["qos_rate"] == float(np.mean(hit[w["start"]:w["end"]]))
    assert rep.phases[-1].qos_rate == float(
        np.mean(hit[-rep.phases[-1].n_queries:]))
    assert d["qos_rate"] == float(np.mean(hit))


@pytest.mark.parametrize("model,qos_latency", [("mtwnd", 0.009),
                                               ("vgg19", 0.1)])
def test_spot_churn_report_equals_the_reference(patched, model, qos_latency):
    """``examples/run_scenario.py --live``'s set-up at a small size: the
    first two cell types, bounds (3, 2), streams at 40 qps, 30-query
    probes; the same ``EpisodeReport`` in both packages, its QoS the
    engine's records'."""
    spec = ts.build_episode("spot-churn", n=120, window=40)
    rspec = patched["registry"].build_episode("spot-churn", n=120, window=40)
    wls = {d: tpool.paper_workload(model, seed=spec.seed,
                                   n_queries=spec.n_base_queries,
                                   rate_qps=40.0, batch_dist=d)
           for d in spec.batch_dists}
    jeng = patched["eng"].ClusterEngine(
        model, _cells(patched["eng"].CellType, 2))
    teng_ = teng.ClusterEngine(model, _cells(teng.CellType, 2), device=CPU)
    jp = patched["planes"].LivePlane(
        jeng, {d: _ref_workload(patched, w) for d, w in wls.items()},
        qos_latency=qos_latency, probe_queries=30)
    tp = ts.LivePlane(teng_, wls, qos_latency=qos_latency, probe_queries=30)
    served = _Served(tp)
    want = patched["engine"].ScenarioEngine(
        rspec, jp, patched["Space"](bounds=(3, 2), prices=PRICES[:2])).run()
    got = ts.ScenarioEngine(spec, tp, SearchSpace(bounds=(3, 2),
                                                  prices=PRICES[:2]),
                            device=CPU).run()
    assert got.to_dict() == want.to_dict()
    d = got.to_dict()
    assert d["plane"] == "live" and tp.n_evals == jp.n_evals >= 1
    assert {"recover_preemption", "reprice"} <= {a["kind"]
                                                 for a in d["actions"]}
    assert len({w["qos_rate"] for w in d["windows"]}) > 1
    check_accounting(got, served, qos_latency)
    assert got.final_qos_by_phase is None
    assert (teng_.served_arrays()[1] >= 0).all()


@pytest.mark.parametrize("model", MODELS)
def test_serve_driver_and_recovery_match_the_reference(patched, monkeypatch,
                                                       model):
    """``serve`` with the reference's defaults (60 queries at 40 qps, QoS
    within 200 ms against 0.9, bounds (4, 3, 2), budget 12) gives the
    reference's samples and best pool; then the end of
    ``examples/serve_cluster.py`` (lose the incumbent's type past its
    count, ``recover_from_failure(budget=10)``) gives its event and
    samples.  The reference's ``warmup`` is a no-op here: it only compiles
    the smoke models eagerly, and nothing it does reaches a record."""
    monkeypatch.setattr(patched["eng"].ClusterEngine, "warmup",
                        lambda self, max_batch=32: None)
    jopt, jeng = patched["serve"].serve(model, verbose=False)
    topt, teng_ = tserve.serve(model, verbose=False, device=CPU)

    def samples(opt):
        return [(e.config, e.qos_rate, e.cost, e.feasible)
                for e in opt.trace.evaluations]

    assert samples(topt) == samples(jopt)
    assert len(samples(topt)) >= 3
    jbest = jopt.trace.best_feasible()
    assert vars(topt.trace.best_feasible()) == vars(jbest)

    lost_type = max(range(3), key=lambda i: jbest.config[i])
    lost = (4, 3, 2)[lost_type] - jbest.config[lost_type] + 1
    jwl = patched["wl"].WorkloadSpec(seed=0, rate_qps=40.0, median_batch=8,
                                     max_batch=32).realize(60)

    def evaluate(cfg):
        jeng.configure(cfg)
        return jeng.serve(jwl, qos_latency=0.2)

    jnew, jev = patched["fault"].recover_from_failure(
        jopt, evaluate, failed_type=lost_type, lost=lost, budget=10)
    tnew, tev, t_type, t_lost = tserve.recover(topt, teng_)
    assert (t_type, t_lost) == (lost_type, lost)
    assert vars(tev) == vars(jev)
    assert samples(tnew) == samples(jnew)
    if tev.new_best is not None:
        reduced = list(topt.space.bounds)
        reduced[lost_type] -= lost
        assert all(c <= b for c, b in zip(tev.new_best, reduced))
        assert tnew.trace.best_feasible().qos_rate >= 0.9


def test_recover_needs_an_incumbent(patched):
    topt, teng_ = tserve.serve("mtwnd", verbose=False, device=CPU,
                               qos_latency=1e-6, budget=3)
    assert topt.trace.best_feasible() is None
    with pytest.raises(ValueError, match="no feasible pool"):
        tserve.recover(topt, teng_)


def test_cli_offers_the_five_models():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "{candle,resnet50,vgg19,mtwnd,dien}" in out.stdout
    assert "--qos-ms" in out.stdout and "--budget" in out.stdout


# --------------------------------------------- the reference's own tests
def test_live_plane_episode_accounting_matches_engine_records():
    """``tests/test_scenario.py``'s test on the port: real smoke forwards
    on the CPU; the last serve of the episode is the final phase segment,
    so the plane's accounting must match the engine's own records."""
    cells = [teng.CellType("cell1", price=1.2, chips=1, speed=1.0,
                           preset="smoke"),
             teng.CellType("cell4", price=4.8, chips=4, speed=3.0,
                           preset="smoke")]
    engine = teng.ClusterEngine("mtwnd", cells, seed=0, device=CPU)
    wl = twl.generate_workload(0, 60, rate_qps=50.0, median_batch=4,
                               max_batch=16)
    plane = ts.LivePlane(engine, {"lognormal": wl}, qos_latency=30.0,
                         probe_queries=15)
    space = SearchSpace(bounds=(2, 1), prices=(1.2, 4.8))
    spec = ts.ScenarioSpec(name="live", qos_target=0.5, window=30,
                           init_budget=4,
                           phases=(ts.PhaseSpec("only", 60, 1.0),))
    rep = ts.ScenarioEngine(spec, plane, space, allow_downscale=False,
                            device=CPU).run()
    lat, waits = engine.served_arrays()
    assert len(lat) == 60
    assert rep.phases[0].qos_rate == float(np.mean(lat <= 30.0))
    assert rep.plane == "live"
    assert rep.final_qos_by_phase is None
    assert (waits >= 0).all()
    # bo accounting counted the probe serves
    assert plane.n_evals >= 1


FAST = InstanceType("fast", price=1.0, flops=1e9, mem_bw=1e9, overhead=1e-3)
SLOW = InstanceType("slow", price=0.3, flops=2e8, mem_bw=5e8, overhead=2e-3)
PROF = ModelProfile("toy", flops_per_sample=1e6, act_bytes_per_sample=1e4,
                    weight_bytes=1e5, qos_latency=0.05)
N, HEAD, DEPLOYED = 120, 60, (1, 1)
DIFF_CANDS = [(1, 0), (1, 1), (2, 1), (3, 2)]
QOS_TARGET = 0.9


def _choose(rates):
    """Cheapest candidate meeting target, else the highest-QoS one."""
    rates = np.asarray(rates)
    feasible = rates >= QOS_TARGET
    cost = np.asarray(DIFF_CANDS) @ np.array([1.0, 0.3])
    if feasible.any():
        return int(np.argmin(np.where(feasible, cost, np.inf)))
    return int(np.argmax(rates))


def test_differential_warm_adaptation_sim_vs_live(monkeypatch):
    """``tests/test_plane_differential.py`` on the port: one mid-episode
    adaptation moment replayed on the port's ``SimulatorPlane`` (warm
    candidate lanes) and ``LivePlane`` (measured ``initial_busy`` probes)
    with the simulator's analytical service times; they agree within the
    float32 scan's tolerance and pick the same pool."""
    svc = {"fast": float(FAST.latency(PROF, 8)),
           "slow": float(SLOW.latency(PROF, 8))}

    def fake_execute(self, batch):
        if self.failed:
            raise RuntimeError(f"cell {self.cell_type.name} is failed")
        self.n_served += 1
        return svc[self.cell_type.name] / self.cell_type.speed

    monkeypatch.setattr(teng.ServingCell, "execute", fake_execute)
    rng = np.random.default_rng(0)
    wl = twl.Workload(arrivals=np.cumsum(rng.exponential(1.0 / 160.0,
                                                         size=N)),
                      batches=np.full(N, 8, dtype=np.int64), rate_qps=160.0)
    sim_plane = ts.SimulatorPlane(PROF, [FAST, SLOW], {"lognormal": wl},
                                  max_instances=8, device=CPU)
    cells = [teng.CellType("fast", price=1.0, chips=1, speed=1.0,
                           preset="smoke"),
             teng.CellType("slow", price=0.3, chips=1, speed=1.0,
                           preset="smoke")]
    engine = teng.ClusterEngine("mtwnd", cells, seed=0, device=CPU)
    live_plane = ts.LivePlane(engine, {"lognormal": wl},
                              qos_latency=PROF.qos_latency, probe_queries=N)
    measured, scores = {}, {}
    for name, plane in (("sim", sim_plane), ("live", live_plane)):
        plane.begin_episode(carry=True)
        plane.deploy(DEPLOYED)
        lat, waits = plane.measure("lognormal", slice_stream(wl, 0, HEAD),
                                   DEPLOYED)
        assert len(lat) == HEAD
        measured[name] = (lat, waits)
        plane.commit(HEAD)
        oracle = plane.warm_oracle("lognormal", 1.0)
        scores[name] = np.array([oracle(c) for c in DIFF_CANDS])
    np.testing.assert_allclose(measured["sim"][0], measured["live"][0],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(measured["sim"][1], measured["live"][1],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(scores["sim"], scores["live"], atol=0.05)
    assert _choose(scores["sim"]) == _choose(scores["live"])
    assert sim_plane.last_carried_wait >= 0.0
    idle = np.array([sim_plane.oracle("lognormal", 1.0)(c)
                     for c in DIFF_CANDS])
    assert np.abs(scores["sim"] - idle).max() > 0.0
