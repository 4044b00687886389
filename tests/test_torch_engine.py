"""Port parity: the live serving plane (``ClusterEngine``, ``Workload``,
``WorkloadSpec``) in PyTorch against ``repro.serving``, for each of the
paper's five models, and the whole slice: RIBBON choosing a pool from the
engine's measured QoS.

``ServingCell.execute`` is replaced in both packages by the same
deterministic service time per (model, cell type, batch bucket), the bucket
read from the batch's leading dimension whatever the model's input names,
so the FCFS
dispatch, hedging and QoS counting, which are the same float64 host code,
must give identical records.  The reference's ``serving`` package is
imported inside a fixture: on jax versions without
``jax.experimental.enable_x64`` its workload module needs that alias for
the duration of the import, and no other test module sees it.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import RibbonOptimizer, SearchSpace  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

CPU = "cpu"
PRICES = (1.2, 4.8, 9.6)
SPEEDS = (1.0, 3.4, 6.0)
NAMES = ("cell1", "cell4", "cell8")


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving.engine`` and ``.workload`` modules."""
    import jax
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import engine, workload
    return engine, workload


# Service-time scale per model: the conv nets slower than the recommenders.
MODEL_SCALE = {"candle": 0.5, "resnet50": 3.0, "vgg19": 6.0, "mtwnd": 1.0,
               "dien": 2.0}


def _service_time(self, batch):
    """Deterministic stand-in for a measured execution: 3 ms at batch 1
    (scaled per model), growing with the bucket, divided by the cell's
    speed."""
    if self.failed:
        raise RuntimeError(f"cell {self.cell_type.name} is failed")
    bucket = int(next(iter(batch.values())).shape[0])
    self.n_served += 1
    return (0.003 * MODEL_SCALE[self.model_name]
            * (1.0 + 0.25 * np.log2(bucket)) / self.cell_type.speed)


@pytest.fixture
def patched(ref, monkeypatch):
    monkeypatch.setattr(ref[0].ServingCell, "execute", _service_time)
    monkeypatch.setattr(teng.ServingCell, "execute", _service_time)
    return ref


def _cells(cls):
    return [cls(n, price=p, chips=1, preset="smoke", speed=s)
            for n, p, s in zip(NAMES, PRICES, SPEEDS)]


def _engines(ref, model="mtwnd", **kw):
    jeng = ref[0].ClusterEngine(model, _cells(ref[0].CellType), **kw)
    teng_ = teng.ClusterEngine(model, _cells(teng.CellType), device=CPU,
                               **kw)
    return jeng, teng_


def _workloads(ref, n=80, rate=150.0):
    jw = ref[1].WorkloadSpec(seed=0, rate_qps=rate, median_batch=8,
                             max_batch=32).realize(n)
    return jw, twl.Workload(arrivals=jw.arrivals, batches=jw.batches,
                            rate_qps=jw.rate_qps)


def _records(engine):
    return [vars(r) for r in engine.records]


@pytest.mark.parametrize("hedge", [None, 0.0, 0.004])
@pytest.mark.parametrize("config", [(1, 0, 0), (2, 1, 0), (1, 1, 1),
                                    (0, 0, 2)])
def test_serve_matches_reference_record_for_record(patched, config, hedge):
    jeng, teng_ = _engines(patched, hedge_threshold=hedge)
    jw, tw = _workloads(patched, rate=400.0)
    jeng.configure(config)
    teng_.configure(config)
    assert teng_.serve(tw, qos_latency=0.01) == jeng.serve(jw, qos_latency=0.01)
    assert _records(teng_) == _records(jeng)
    for a, b in zip(teng_.served_arrays(), jeng.served_arrays()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", ["candle", "resnet50", "vgg19", "mtwnd",
                                   "dien"])
def test_serve_matches_reference_for_every_paper_model(patched, model):
    """Each paper model's engine: batches of its own inputs per bucket, the
    same records as the reference's, hedging on."""
    jeng, teng_ = _engines(patched, model=model, hedge_threshold=0.004)
    jw, tw = _workloads(patched, rate=200.0)
    for e in (jeng, teng_):
        e.configure((2, 1, 1))
    assert teng_.serve(tw, qos_latency=0.02) == jeng.serve(jw,
                                                           qos_latency=0.02)
    assert _records(teng_) == _records(jeng)
    assert len({r["latency"] for r in _records(teng_)}) > 10
    buckets = {int(next(iter(teng_._batch("smoke", b).values())).shape[0])
               for b in (1, 8, 32)}
    assert buckets == {1, 8, 32}


@pytest.mark.parametrize("time_scale", [1.0, 0.5])
def test_serve_with_initial_busy_matches(patched, time_scale):
    jeng, teng_ = _engines(patched)
    jw, tw = _workloads(patched)
    busy = [0.02, 0.0, 0.05, 0.01]
    for e in (jeng, teng_):
        e.configure((2, 1, 1))
    assert teng_.serve(tw, 0.012, time_scale=time_scale,
                       initial_busy=busy) == jeng.serve(
        jw, 0.012, time_scale=time_scale, initial_busy=busy)
    assert _records(teng_) == _records(jeng)
    with pytest.raises(ValueError):
        teng_.serve(tw, 0.012, initial_busy=[0.0])


def test_pool_operations_match(patched):
    jeng, teng_ = _engines(patched)
    jw, tw = _workloads(patched)
    for e in (jeng, teng_):
        e.configure((3, 2, 2))
    assert teng_.active_config() == jeng.active_config() == (3, 2, 2)
    assert teng_.fail_cell(4).name == jeng.fail_cell(4).name
    assert teng_.preempt(0, 2) == jeng.preempt(0, 2)
    assert teng_.preempt(2, 5) == jeng.preempt(2, 5)
    assert teng_.active_config() == jeng.active_config()
    assert teng_.pool_price() == jeng.pool_price()
    assert teng_.pool_price((1, 2, 3)) == jeng.pool_price((1, 2, 3))
    assert teng_.serve(tw, 0.01) == jeng.serve(jw, 0.01)
    assert _records(teng_) == _records(jeng)
    with pytest.raises(RuntimeError):
        teng_.cells[4].execute({"dense": np.zeros((1, 8))})
    for e in (jeng, teng_):
        e.configure((0, 0, 0))
    assert teng_.serve(tw, 0.01) == jeng.serve(jw, 0.01) == 0.0


@pytest.mark.parametrize("kwargs", [
    dict(chunk=0), dict(rate_qps=0.0), dict(rate_qps=-1.0), dict(scale=0.0),
    dict(batch_dist="uniform"),
])
def test_workload_spec_validation_matches(ref, kwargs):
    base = dict(seed=0, rate_qps=10.0)
    with pytest.raises(ValueError):
        ref[1].WorkloadSpec(**{**base, **kwargs})
    with pytest.raises(ValueError):
        twl.WorkloadSpec(**{**base, **kwargs})


def test_workload_spec_fields_and_scaling_match(ref):
    js = ref[1].WorkloadSpec(seed=3, rate_qps=20.0).scaled(1.5).scaled(2.0)
    ts = twl.WorkloadSpec(seed=3, rate_qps=20.0).scaled(1.5).scaled(2.0)
    assert vars(ts) == vars(js)
    assert ts.effective_rate == js.effective_rate
    for spec in (js, ts):
        with pytest.raises(ValueError):
            spec.scaled(0.0)
        with pytest.raises(ValueError):
            spec.realize(-1)


def test_workload_scaled_matches(ref):
    jw, tw = _workloads(ref)
    for f in (0.5, 1.5, 3.0):
        js, ts = jw.scaled(f), tw.scaled(f)
        np.testing.assert_array_equal(ts.arrivals, js.arrivals)
        np.testing.assert_array_equal(ts.batches, js.batches)
        assert ts.rate_qps == js.rate_qps and ts.n_queries == js.n_queries


@pytest.mark.parametrize("dist", ["lognormal", "gaussian"])
def test_realize_draws_the_reference_distributions(dist):
    spec = twl.WorkloadSpec(seed=5, rate_qps=200.0, batch_dist=dist,
                            chunk=1000, max_batch=64)
    wl = spec.realize(20_000)
    gaps = np.diff(np.concatenate([[0.0], wl.arrivals]))
    # float32 accumulation, as in the reference: a gap below half an ulp of
    # the clock rounds to 0, so arrivals are sorted but not strictly
    assert wl.arrivals.dtype == np.float64 and np.all(gaps >= 0)
    assert abs(gaps.mean() * 200.0 - 1.0) < 0.03        # exponential, 1/rate
    assert wl.batches.min() >= 1 and wl.batches.max() <= 64
    assert np.all(wl.batches == np.round(wl.batches))
    if dist == "lognormal":
        assert abs(np.median(wl.batches) - 24.0) <= 1.0
    else:
        assert abs(np.median(wl.batches) - 48.0) <= 1.5
    # a shorter realisation is a prefix; the same seed is the same stream
    short = spec.realize(1500)
    np.testing.assert_array_equal(short.arrivals, wl.arrivals[:1500])
    np.testing.assert_array_equal(short.batches, wl.batches[:1500])
    scaled = spec.scaled(2.0).realize(1500)
    np.testing.assert_array_equal(scaled.arrivals, short.arrivals / 2.0)


@pytest.mark.parametrize("qos_target,latency", [(0.9, 0.012), (0.95, 0.008)])
def test_ribbon_over_live_engine_matches_reference(patched, qos_target,
                                                   latency):
    """The whole slice: RIBBON's ask/tell loop over the live pool, as in
    ``examples/serve_cluster.py``, lands on the same pool in both."""
    jeng, teng_ = _engines(patched)
    jw, tw = _workloads(patched, rate=300.0)
    from repro.core import RibbonOptimizer as JOpt
    from repro.core import SearchSpace as JSpace
    jopt = JOpt(JSpace((4, 3, 3), PRICES), qos_target=qos_target, patience=6)
    topt = RibbonOptimizer(SearchSpace((4, 3, 3), PRICES),
                           qos_target=qos_target, patience=6, device=CPU)
    for _ in range(16):
        cj, ct = jopt.ask(), topt.ask()
        assert ct == cj
        if cj is None or jopt.done:
            assert topt.done == jopt.done
            break
        jeng.configure(cj)
        teng_.configure(ct)
        rj, rt = jeng.serve(jw, latency), teng_.serve(tw, latency)
        assert rt == rj
        jopt.tell(cj, rj)
        topt.tell(ct, rt)
    assert len({e.qos_rate for e in topt.trace.evaluations}) > 2
    best_t, best_j = topt.trace.best_feasible(), jopt.trace.best_feasible()
    assert best_j is not None and vars(best_t) == vars(best_j)


def test_unpatched_smoke_serve_on_cpu():
    _unpatched_serve("mtwnd")


@pytest.mark.parametrize("model", ["candle", "resnet50", "vgg19", "dien"])
def test_unpatched_smoke_serve_of_the_other_paper_models(model):
    _unpatched_serve(model)


def _unpatched_serve(model):
    eng = teng.ClusterEngine(model, _cells(teng.CellType), device=CPU)
    eng.warmup(max_batch=8)
    eng.configure((1, 1, 0))
    wl = twl.WorkloadSpec(seed=0, rate_qps=150.0, median_batch=8,
                          max_batch=32).realize(40)
    rate = eng.serve(wl, qos_latency=0.03)
    assert 0.0 <= rate <= 1.0
    lat, waits = eng.served_arrays()
    assert len(lat) == 40 and np.all(lat >= waits) and np.all(waits >= 0)
    assert sum(c.n_served for c in eng.cells) == 40


def test_default_cells_keep_reference_prices(ref):
    assert [(c.name, c.price, c.chips, c.speed) for c in teng.DEFAULT_CELLS] \
        == [(c.name, c.price, c.chips, c.speed)
            for c in ref[0].DEFAULT_TPU_CELLS]
    assert all(c.preset == "full" for c in teng.DEFAULT_CELLS)
