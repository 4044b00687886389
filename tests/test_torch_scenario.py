"""Port parity: the scenario engine (ROADMAP A-13), ``repro_torch.scenario``
against ``repro.scenario``.

* Pure data: spec validation and compiled timelines, the event registry,
  every registry episode's spec, and the Chrome-trace export (wall-clock
  durations aside).
* ``SimulatorPlane``: ``measure`` with and without ``stream_chunk`` equals
  the reference's monolithic plane bit for bit (latencies, waits, window
  telemetry, carried wait, the committed carry).
* Every ``EPISODES`` entry at n 500, window 100 (``diurnal-day`` at 2000 /
  400), run on both packages' simulator planes from the same streams (the
  port's, handed to the reference as its ``Workload``): the same
  ``EpisodeReport`` (the two tiered episodes in
  ``tests/test_torch_tier_episodes.py``, so that a parallel run can take
  them apart).  Where an adaptation search meets an EI near-tie
  (float32 noise at EI ~1e-8, ROADMAP C-R20) the two runs part there;
  those episodes are held by replay: every plane and evaluator call the
  reference's run made (its configs, segments, commits, deploys, what-if
  sweeps) is made again on the port's plane, and every result and carry
  must be equal bit for bit.  ``LivePlane`` refuses, naming its item.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import scenario as ts  # noqa: E402
from repro_torch.scenario import engine as tengine  # noqa: E402
from repro_torch.serving import from_fields  # noqa: E402
from repro_torch.serving import pool as tpool  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

CPU = "cpu"
MODEL = "mtwnd"
EPISODES = ["diurnal", "flash-crowd", "spot-churn", "failure-storm",
            "dist-drift", "dist-drift-bucketed", "composite", "diurnal-day"]
TIERED = {"spot-storm", "tier-outage"}
SIZE = {"diurnal-day": dict(n=2000, window=400)}
# Episodes whose runs part at an EI near-tie (C-R20): the first differing
# ask and the EI of the two candidates there, reference / port.
NEAR_TIE = {
    # the first rescale's last ask: (6, 0, 0) / (6, 0, 3), EI -2.0e-8 and
    # -2.2e-8 / 2.7e-13 and 8.2e-13 (z ~ -7: the reference's saturated erf)
    "diurnal",
    # a recovery's sequential ask: (1, 1, 9) / (4, 0, 1), EI 9.5e-9 and
    # -2.4e-8 / -1.6e-9 and 8.9e-9
    "failure-storm",
    # a recovery's sequential ask: (0, 1, 0, 3) / (2, 3, 0, 0), EI 3.39e-7
    # and 3.14e-7 / 3.13e-7 and 3.14e-7; the same pools after it, one
    # evaluation more (111 against 110)
    "tier-outage",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its GP fits and scans
    are small ops that torch would spread over every core, and in a
    parallel test run the workers' threads then fight for the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.scenario`` and ``repro.serving`` modules,
    imported with the ``enable_x64`` alias ``repro.serving`` needs on jax
    0.9, as in ``tests/test_torch_engine.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro import scenario
        from repro.scenario import engine, planes, registry, spec, trace
        from repro.serving import instance, pool, tiers, workload
    from repro.core.search_space import SearchSpace
    return {"scenario": scenario, "engine": engine, "planes": planes,
            "registry": registry, "spec": spec, "trace": trace,
            "inst": instance, "pool": pool, "tiers": tiers, "wl": workload,
            "SearchSpace": SearchSpace}


def _ref_workload(ref, w):
    """A port ``Workload`` as the reference's."""
    buckets = None if w.buckets is None else tuple(
        ref["wl"].RequestBucket(**vars(b)) for b in w.buckets)
    return ref["wl"].Workload(arrivals=w.arrivals, batches=w.batches,
                              rate_qps=w.rate_qps, bucket_of=w.bucket_of,
                              buckets=buckets)


def _port_workload(w):
    buckets = None if w.buckets is None else tuple(
        twl.RequestBucket(**vars(b)) for b in w.buckets)
    return twl.Workload(arrivals=np.asarray(w.arrivals),
                        batches=np.asarray(w.batches), rate_qps=w.rate_qps,
                        bucket_of=None if w.bucket_of is None
                        else np.asarray(w.bucket_of), buckets=buckets)


def _ref_plane(ref, spec, tiered, stream_chunk=None):
    """The reference's plane for ``spec`` on mtwnd, bound to the port's
    streams (the reference's ``paper_simulator_plane`` /
    ``tiered_simulator_plane`` with the port's ``paper_workload``)."""
    wls = {d: _ref_workload(ref, tpool.paper_workload(
        MODEL, seed=spec.seed, n_queries=spec.n_base_queries, batch_dist=d))
        for d in spec.batch_dists}
    prof = ref["inst"].MODEL_PROFILES[MODEL]
    if tiered:
        types, bounds = ref["tiers"].tiered_pool(MODEL)
        plane = ref["planes"].SimulatorPlane(
            prof, types, wls, catalog=ref["tiers"].TierCatalog(types),
            stream_chunk=stream_chunk)
    else:
        types = [ref["inst"].AWS_INSTANCES[n]
                 for n in ref["inst"].PAPER_POOLS[MODEL]["diverse"]]
        bounds = ref["pool"].DEFAULT_BOUNDS[MODEL]
        plane = ref["planes"].SimulatorPlane(prof, types, wls,
                                             stream_chunk=stream_chunk)
    return plane, ref["SearchSpace"](bounds=bounds,
                                     prices=tuple(t.price for t in types))


def _port_plane(spec, tiered, stream_chunk=None):
    make = ts.tiered_simulator_plane if tiered else ts.paper_simulator_plane
    return make(MODEL, spec, stream_chunk=stream_chunk, device=CPU)


def _asdict(x):
    return dataclasses.asdict(x)


# ------------------------------------------------------------ pure data
def test_event_registry(ref):
    rs = ref["spec"]
    assert ts.EVENT_KINDS == rs.EVENT_KINDS
    assert ts.BATCH_DISTS == rs.BATCH_DISTS
    assert {k: _asdict(v) for k, v in ts.EVENT_KIND_SPECS.items()} == {
        k: _asdict(v) for k, v in rs.EVENT_KIND_SPECS.items()}
    for tiered in (False, True):
        assert ts.fuzz_kinds(tiered=tiered) == rs.fuzz_kinds(tiered=tiered)
    assert set(tengine.ScenarioEngine._EVENT_HANDLERS) == set(ts.EVENT_KINDS)


@pytest.mark.parametrize("name", sorted(set(EPISODES) | TIERED))
@pytest.mark.parametrize("kw", [{}, dict(n=300, window=60, seed=3)])
def test_registry_specs_and_timelines(ref, name, kw):
    """Each builder's spec, its compiled timeline and its derived facts
    equal the reference's."""
    got = ts.build_episode(name, **kw)
    want = ref["registry"].build_episode(name, **kw)
    assert _asdict(got) == _asdict(want)
    assert (got.n_base_queries, got.batch_dists) == (want.n_base_queries,
                                                     want.batch_dists)
    tl, rl = ts.Timeline.compile(got), ref["spec"].Timeline.compile(want)
    assert [[(i, _asdict(e)) for i, e in c] for c in tl.cuts] == [
        [(i, _asdict(e)) for i, e in c] for c in rl.cuts]


def test_unknown_episode_raises(ref):
    with pytest.raises(KeyError, match="unknown episode"):
        ts.build_episode("no-such-episode")


def _bad_specs(mod):
    P, E, S = mod.PhaseSpec, mod.EventSpec, mod.ScenarioSpec
    ok = (P("a", 100, 1.0), P("b", 100, 1.0))
    return [
        S(name="x", phases=()),
        S(name="x", phases=(P("a", 0, 1.0),)),
        S(name="x", phases=(P("a", 10, 0.0),)),
        S(name="x", phases=(P("a", 10, 1.0, batch_dist="zipf"),)),
        S(name="x", phases=ok, events=(E("meteor", phase=0, at_frac=0.5),)),
        S(name="x", phases=ok, events=(E("load_spike", phase=2, at_frac=0.5,
                                         factor=1.5),)),
        S(name="x", phases=ok, events=(E("load_spike", phase=0, at_frac=1.5,
                                         factor=1.5),)),
        S(name="x", phases=ok, events=(E("cell_failure", phase=0,
                                         at_frac=0.5, type_index=-1),)),
        S(name="x", phases=ok, events=(E("cell_failure", phase=0,
                                         at_frac=0.5, count=0),)),
        S(name="x", phases=ok, events=(E("preemption_storm", phase=0,
                                         at_frac=0.5, tier="moon",
                                         factor=0.5),)),
        S(name="x", phases=ok, events=(E("preemption_storm", phase=0,
                                         at_frac=0.5, tier="spot",
                                         factor=1.5),)),
        S(name="x", phases=ok, events=(E("price_change", phase=0,
                                         at_frac=0.5, tier="spot",
                                         factor=1.2),)),
        S(name="x", phases=ok, window=0),
        S(name="x", phases=ok, provision_queries=-1),
        S(name="x", phases=ok, qos_target=0.0),
    ]


def test_spec_validation(ref):
    """The reference's validation errors, message for message."""
    for got, want in zip(_bad_specs(ts), _bad_specs(ref["spec"])):
        msgs = []
        for spec in (got, want):
            with pytest.raises(ValueError) as err:
                spec.validate()
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_live_plane_is_refused_with_its_item():
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        ts.LivePlane(None, {}, 0.05)


# ---------------------------------------------------- the simulator plane
def _tel(t):
    return {f.name: np.asarray(getattr(t, f.name)).tolist()
            for f in dataclasses.fields(t)}


def test_plane_measure_with_and_without_stream_chunk(ref):
    """The port's plane, monolithic and in blocks of 97 queries (a chunk
    that divides nothing), against the reference's monolithic plane:
    latencies, waits, carried wait, window telemetry, the committed
    carry (a commit inside the third block) and the next warm segment."""
    spec = ts.build_episode("dist-drift", n=400, window=100)
    rp, _ = _ref_plane(ref, spec, False)
    mono, _ = _port_plane(spec, False)
    chunked, _ = _port_plane(spec, False, stream_chunk=97)
    cfg = (3, 1, 1)
    for pl in (rp, mono, chunked):
        pl.begin_episode(carry=True)
        pl.deploy(cfg)
    out = []
    for pl in (rp, mono, chunked):
        wl = pl.phase_stream("lognormal", 300, 1.2)
        lat, waits = pl.measure("lognormal", wl, cfg)
        tel = [_tel(pl.window_telemetry(lo, hi))
               for lo, hi in ((30, 170), (5, 5), (0, 300))]
        carried = pl.last_carried_wait
        pl.commit(250)
        state = (np.asarray(pl._state.free).tolist(), pl._state.clock,
                 pl._local_now)
        wl2 = pl.phase_stream("gaussian", 200, 1.0)
        lat2, _ = pl.measure("gaussian", wl2, cfg)
        out.append((lat.tolist(), waits.tolist(), tel, carried, state,
                    lat2.tolist(), pl.last_carried_wait))
    assert out[1] == out[0]
    assert out[2] == out[0]
    assert chunked.n_dispatches == 4 + 3 and mono.n_dispatches == 2


def test_phase_sweep_states(ref):
    """``phase_sweep`` cold and warm per phase row (``states=``), the
    reference's rates bit for bit, on the tiered plane (cold starts)."""
    spec = ts.build_episode("tier-outage", n=300, window=100)
    phases = list(spec.phases)
    rp, _ = _ref_plane(ref, spec, True)
    tp, _ = _port_plane(spec, True)
    cfg = (2, 2, 1, 0)
    got = []
    for pl in (rp, tp):
        pl.begin_episode(carry=True)
        pl.deploy(cfg)
        wl = pl.phase_stream("lognormal", 300, 1.0)
        pl.measure("lognormal", wl, cfg)
        pl.commit(200)
        cs = pl.candidate_state()
        states = [None, cs, cs, None]
        got.append((pl.phase_sweep((3, 2, 1, 1), phases),
                    pl.phase_sweep((3, 2, 1, 1), phases, states=states)))
    assert got[1] == got[0]


# ------------------------------------------------------------- episodes
def _carry(plane):
    """The plane's carried episode state."""
    st = plane._state
    return (None if st is None else np.asarray(st.free).tolist(),
            None if st is None else st.clock, plane._local_now)


class _Recorder:
    """Logs every call the engine makes into a reference plane (and, through
    its evaluators, every what-if sweep) with its result, so the port's
    plane can be driven through the same calls.  A measure's result holds
    the carried wait too, a commit's the carry it leaves."""

    PLANE = ("begin_episode", "deploy", "advance_clock", "measure", "commit",
             "window_telemetry")

    def __init__(self, plane):
        self.log = []
        for name in self.PLANE:
            setattr(plane, name, self._wrap(("plane", name),
                                            getattr(plane, name), plane))
        for dist, ev in plane.evaluators.items():
            for name in ("grid", "grid_from"):
                setattr(ev, name, self._wrap(("ev", dist, name),
                                             getattr(ev, name)))
            ev.sim.qos = self._wrap(("sim", dist, "qos"), ev.sim.qos)

    def _wrap(self, key, fn, plane=None):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.log.append((key, args, kwargs, _after(key, plane, out)))
            return out
        return call


def _after(key, plane, out):
    if key == ("plane", "measure"):
        return out, plane.last_carried_wait
    if key == ("plane", "commit"):
        return _carry(plane)
    return out


def _port_arg(x):
    """A reference argument handed across: states, policies, workloads,
    phases, and lists or tuples of them."""
    name = type(x).__name__
    if name in ("PoolState", "RoutingPolicy"):
        return from_fields(name, vars(x))
    if name == "Workload":
        return _port_workload(x)
    if name == "PhaseSpec":
        return ts.PhaseSpec(**_asdict(x))
    if isinstance(x, (list, tuple)):
        return type(x)(_port_arg(v) for v in x)
    return x


def _result(x):
    if x is None or isinstance(x, (int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return [_result(v) for v in x]
    if hasattr(x, "rates"):          # QosResult
        return _result(np.asarray(x.rates))
    if hasattr(x, "served"):         # Telemetry
        return _tel(x)
    return np.asarray(x).tolist()


def _replay(log, plane):
    """Drive the port's ``plane`` through a reference run's calls: every
    result, carried wait and carry equal."""
    for key, args, kwargs, want in log:
        args = tuple(_port_arg(a) for a in args)
        kwargs = {k: _port_arg(v) for k, v in kwargs.items()}
        if key[0] == "plane":
            out = getattr(plane, key[1])(*args, **kwargs)
        elif key[0] == "ev":
            out = getattr(plane.evaluators[key[1]], key[2])(*args, **kwargs)
        else:
            out = plane.evaluators[key[1]].sim.qos(*args, **kwargs)
        assert _result(_after(key, plane, out)) == _result(want), key


def _report(rep):
    return rep.to_dict()


@pytest.mark.parametrize("name", EPISODES)
def test_episode_reports_equal_the_reference(ref, name):
    """The port's episode report equals the reference's on the same
    streams; a C-R20 episode is held by replay instead past its first
    near-tie."""
    check_episode(ref, name)


def check_episode(ref, name):
    """Run registry episode ``name`` on both packages' planes and hold the
    port's report to the reference's (or, for a C-R20 episode, its
    windows up to the first differing action and a replay of the rest)."""
    kw = SIZE.get(name, dict(n=500, window=100))
    tiered = name in TIERED
    rspec = ref["registry"].build_episode(name, **kw)
    rplane, rspace = _ref_plane(ref, rspec, tiered)
    rec = _Recorder(rplane) if name in NEAR_TIE else None
    want = _report(ref["engine"].ScenarioEngine(rspec, rplane, rspace).run())
    tspec = ts.build_episode(name, **kw)
    tplane, tspace = _port_plane(tspec, tiered)
    got = _report(ts.ScenarioEngine(tspec, tplane, tspace,
                                    device=CPU).run())
    assert tplane.n_dispatches > 0
    if name not in NEAR_TIE:
        assert got == want
        return
    assert got != want
    # Up to the first action that differs, the same windows.
    acts = [a for a, b in zip(got["actions"], want["actions"]) if a != b]
    cut = acts[0]["at_query"] if acts else got["total_queries"]
    assert ([w for w in got["windows"] if w["end"] <= cut]
            == [w for w in want["windows"] if w["end"] <= cut])
    fresh, _ = _port_plane(tspec, tiered)
    _replay(rec.log, fresh)
    assert len(rec.log) > 20


def test_diurnal_day_small_anchor():
    """diurnal-day at n 2000, window 400 from the seed alone: the anchors
    of the reference fed the port's stream."""
    spec = ts.build_episode("diurnal-day", n=2000, window=400)
    plane, space = _port_plane(spec, False)
    rep = ts.ScenarioEngine(spec, plane, space, device=CPU).run()
    d = rep.to_dict()
    assert (d["qos_rate"], d["total_cost"], d["bo_evals"], len(rep.windows),
            d["violation_windows"], tuple(rep.final_config)) == (
        0.9984, 0.013242827912236889, 25, 25, 0, (6, 0, 1))


def test_trace_export_equals_the_reference(ref):
    """spot-churn with a TraceRecorder in both packages: the same trace
    events but the wall-clock durations of searches and event handlers."""
    kw = dict(n=300, window=100)
    traces = []
    for mod, make in ((ref["scenario"], lambda s: _ref_plane(ref, s, False)),
                      (ts, lambda s: _port_plane(s, False))):
        spec = mod.build_episode("spot-churn", **kw)
        plane, space = make(spec)
        rec = mod.TraceRecorder()
        extra = {"device": CPU} if mod is ts else {}
        mod.ScenarioEngine(spec, plane, space, trace=rec, **extra).run()
        events = []
        for e in rec.to_dict()["traceEvents"]:
            e = dict(e, args=dict(e.get("args", {})))
            e["args"].pop("wall_ms", None)
            if e["name"].startswith(("search:", "handle:")):
                e.pop("dur")
            events.append(e)
        traces.append((events, rec.n_events))
    assert traces[1] == traces[0]
    assert traces[0][1] > 20
