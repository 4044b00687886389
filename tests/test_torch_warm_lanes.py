"""Port parity: the simulator's warm-start lanes (ROADMAP A-7) in
``repro_torch.serving.simulator`` against ``repro.serving.simulator``.

``PoolState`` (``remap``, ``remap_batch``), ``segment_from`` and its
prefix carries (``SegmentResult.state_at``), the warm batch and grid lanes
(``state=`` with ``deployed=``, ``now=`` and ``warmup=``), the per-row
``states=`` grid, ``carried_wait`` and the horizon guard, on the
reference's own arrays for the five paper models.  States cross from the
reference as their fields (``repro_torch.serving.from_fields``).  Every
comparison is bit for bit.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving import from_fields  # noqa: E402
from repro_torch.serving import instance as tinst  # noqa: E402
from repro_torch.serving import simulator as tsim  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

CPU = "cpu"
MODELS = ["mtwnd", "dien", "candle", "resnet50", "vgg19"]
N_QUERIES = 1500
CONFIG = {"mtwnd": (4, 0, 1), "dien": (3, 2, 1), "candle": (2, 3, 2),
          "resnet50": (3, 3, 3), "vgg19": (2, 2, 2)}


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving`` simulator and pool, imported with
    the ``enable_x64`` alias its import needs on jax 0.9, as in
    ``tests/test_torch_simulator.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import pool, simulator
    return {"sim": simulator, "pool": pool}


def _port_sim(jsim, model, workload=None):
    w = jsim.workload if workload is None else workload
    tw = twl.Workload(arrivals=w.arrivals, batches=w.batches,
                      rate_qps=w.rate_qps)
    types = [tinst.AWS_INSTANCES[t.name] for t in jsim.types]
    return tsim.PoolSimulator(tinst.MODEL_PROFILES[model], types, tw,
                              device=CPU)


@pytest.fixture(scope="module")
def setups(ref):
    """Per paper model: the reference's simulator on its standard stream
    and the port's on the same arrays, on the CPU."""
    out = {}
    for model in MODELS:
        jev, _, _ = ref["pool"].make_paper_setup(model, n_queries=N_QUERIES)
        out[model] = (jev.sim, _port_sim(jev.sim, model))
    return out


def _state(jstate):
    return from_fields("PoolState", vars(jstate))


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def _equal_state(t, j):
    _equal(t.free, j.free)
    assert t.clock == j.clock


def _live(jsim, tsim_, model, k=700):
    """A live carry mid-stream: the model's pool served ``k`` queries,
    rebased to the ``k``-th arrival (reference's and port's)."""
    cfg = CONFIG[model]
    jseg = jsim.segment_from(jsim.initial_state(), cfg)
    tseg = tsim_.segment_from(tsim_.initial_state(), cfg)
    clock = float(jsim.workload.arrivals[k])
    return jseg.state_at(k).rebased(clock), tseg.state_at(k).rebased(clock)


# ---------------------------------------------------------------- PoolState
@pytest.mark.parametrize("warmup", [None, (0.5, 0.0, 2.0)])
def test_remap_and_remap_batch_equal(ref, warmup):
    rng = np.random.default_rng(3)
    free = np.sort(rng.uniform(5.0, 9.0, 40))
    jst = ref["sim"].PoolState(free=free, clock=4.0)
    tst = _state(jst)
    old = (3, 4, 2)
    news = rng.integers(0, 8, (24, 3))
    news[0] = old
    news[1] = 0
    for new in news:
        _equal_state(tst.remap(old, new, 6.5, warmup=warmup),
                     jst.remap(old, new, 6.5, warmup=warmup))
    _equal(tst.remap_batch(old, news, 6.5, warmup=warmup),
           jst.remap_batch(old, news, 6.5, warmup=warmup))
    _equal_state(tst.rebased(1.25), jst.rebased(1.25))
    _equal_state(tsim.PoolState.idle(40, 2.0),
                 ref["sim"].PoolState.idle(40, 2.0))
    for bad in (dict(old_config=(1, 2), new_config=(1, 2, 3)),
                dict(old_config=(40, 1, 0), new_config=(1, 1, 1))):
        for st in (tst, jst):
            with pytest.raises(ValueError):
                st.remap(now=1.0, **bad)
    for st in (tst, jst):
        with pytest.raises(ValueError, match="warmup"):
            st.remap_batch(old, news, 1.0, warmup=(1.0, 2.0))


# -------------------------------------------------------------- segments
@pytest.mark.parametrize("model", MODELS)
def test_segment_from_idle_equals_cold_and_reference(setups, model):
    jsim, tsim_ = setups[model]
    cfg = CONFIG[model]
    tseg = tsim_.segment_from(tsim_.initial_state(), cfg)
    jseg = jsim.segment_from(jsim.initial_state(), cfg)
    cold = tsim_.simulate(cfg)
    _equal(tseg.lat, cold.lat)
    _equal(tseg.waits, cold.waits)
    for name in ("lat", "waits", "_slots", "_fin", "_final_rel", "_rel0",
                 "_start", "_active"):
        _equal(getattr(tseg, name), getattr(jseg, name))
    for k in (0, 1, 499, 1000, N_QUERIES - 1, N_QUERIES):
        _equal_state(tseg.state_at(k), jseg.state_at(k))
    _equal_state(tseg.state, jseg.state)
    with pytest.raises(ValueError):
        tseg.state_at(N_QUERIES + 1)


def test_segment_of_empty_pool_passes_the_carry_through(setups):
    jsim, tsim_ = setups["dien"]
    jst, tst = _live(jsim, tsim_, "dien")
    tseg = tsim_.segment_from(tst, (0, 0, 0), telemetry=True)
    jseg = jsim.segment_from(jst, (0, 0, 0), telemetry=True)
    _equal(tseg.lat, jseg.lat)
    _equal_state(tseg.state, jseg.state)
    assert tseg.telemetry.n == 0


@pytest.mark.parametrize("model", ["mtwnd", "candle", "vgg19"])
def test_two_chained_segments_equal_the_whole_stream(ref, setups, model):
    """The stream cut at query 900: the second half served from the first
    half's final carry, rebased to the cut's arrival, gives the
    reference's bits; from the idle carry, the first half's prefix carry
    at the cut equals the whole stream's."""
    jsim, tsim_ = setups[model]
    cfg = CONFIG[model]
    w = jsim.workload
    cut = 900
    halves = []
    for lo, hi in ((0, cut), (cut, N_QUERIES)):
        arr = np.asarray(w.arrivals[lo:hi] - (w.arrivals[lo] if lo else 0.0))
        part = type(w)(arrivals=arr, batches=w.batches[lo:hi],
                       rate_qps=w.rate_qps)
        halves.append((ref["sim"].PoolSimulator(jsim.model, jsim.types,
                                                part),
                       _port_sim(jsim, model, part)))
    (j1, t1), (j2, t2) = halves
    js, ts = j1.initial_state(), t1.initial_state()
    jseg1, tseg1 = j1.segment_from(js, cfg), t1.segment_from(ts, cfg)
    clock = float(w.arrivals[cut])
    jseg2 = j2.segment_from(jseg1.state.rebased(clock), cfg)
    tseg2 = t2.segment_from(tseg1.state.rebased(clock), cfg)
    for a, b in ((tseg1, jseg1), (tseg2, jseg2)):
        _equal(a.lat, b.lat)
        _equal(a.waits, b.waits)
        _equal_state(a.state, b.state)
    whole = tsim_.segment_from(tsim_.initial_state(), cfg)
    _equal(tseg1.lat, whole.lat[:cut])
    _equal_state(tseg1.state, whole.state_at(cut))


# ------------------------------------------------- warm batch and grid lanes
@pytest.mark.parametrize("model", MODELS)
def test_warm_batch_lane_equal(setups, model):
    jsim, tsim_ = setups[model]
    jst, tst = _live(jsim, tsim_, model)
    rng = np.random.default_rng(5)
    cfgs = rng.integers(0, 6, (12, 3))
    cfgs[0] = 0
    cfgs[1] = CONFIG[model]
    dep = CONFIG[model]
    for kw in (dict(), dict(deployed=dep), dict(deployed=dep, now=tst.clock
                                                + 0.01),
               dict(deployed=dep, warmup=(0.03, 0.0, 0.1))):
        t = tsim_.simulate(cfgs, state=tst, **kw)
        j = jsim.simulate(cfgs, state=jst, **kw)
        _equal(t.lat, j.lat)
        for a, b in zip(t.state, j.state):
            _equal_state(a, b)
        _equal(tsim_.qos(cfgs, state=tst, **kw).rates,
               jsim.qos(cfgs, state=jst, **kw).rates)
    # row i equals the warm single lane on that candidate's remapped state
    remapped = tst.remap(dep, cfgs[3], tst.clock)
    _equal(tsim_.simulate(cfgs, state=tst, deployed=dep).lat[3],
           tsim_.simulate(cfgs[3], state=remapped).lat)


@pytest.mark.parametrize("model", ["mtwnd", "dien", "resnet50"])
def test_warm_grid_lane_equal(setups, model):
    jsim, tsim_ = setups[model]
    jst, tst = _live(jsim, tsim_, model)
    rng = np.random.default_rng(6)
    cfgs = rng.integers(0, 6, (10, 3))
    cfgs[0] = 0
    factors = [0.9, 1.0, 1.5]
    dep = CONFIG[model]
    for kw in (dict(), dict(deployed=dep),
               dict(deployed=dep, now=tst.clock + 0.02,
                    warmup=(0.0, 0.05, 0.0))):
        _equal(tsim_.simulate(cfgs, workloads=factors, state=tst, **kw).lat,
               jsim.simulate(cfgs, workloads=factors, state=jst, **kw).lat)
        _equal(tsim_.qos(cfgs, workloads=factors, state=tst, **kw).rates,
               jsim.qos(cfgs, workloads=factors, state=jst, **kw).rates)


@pytest.mark.parametrize("model", ["mtwnd", "candle"])
def test_idle_carry_equals_the_cold_lanes(setups, model):
    _, tsim_ = setups[model]
    idle = tsim_.initial_state()
    cfgs = np.random.default_rng(7).integers(0, 5, (8, 3))
    _equal(tsim_.simulate(cfgs, state=idle).lat, tsim_.simulate(cfgs).lat)
    _equal(tsim_.qos(cfgs, workloads=[1.0, 1.4], state=idle).rates,
           tsim_.qos(cfgs, workloads=[1.0, 1.4]).rates)


def test_states_grid_equal(setups):
    jsim, tsim_ = setups["mtwnd"]
    jst, tst = _live(jsim, tsim_, "mtwnd", 600)
    jst2, tst2 = _live(jsim, tsim_, "mtwnd", 1100)
    cfgs = np.random.default_rng(8).integers(0, 6, (9, 3))
    factors = [1.0, 1.2, 1.5]
    jstates = [None, (jst, (4, 0, 1)), (jst2, None)]
    tstates = [None, (tst, (4, 0, 1)), (tst2, None)]
    t = tsim_.qos(cfgs, workloads=factors, states=tstates)
    _equal(t.rates, jsim.qos(cfgs, workloads=factors, states=jstates).rates)
    # each row equals a separate warm grid call on that row's carry
    _equal(t.rates[1], tsim_.qos(cfgs, workloads=[1.2], state=tst,
                                 deployed=(4, 0, 1)).rates[0])
    for bad in (dict(states=tstates), dict(states=tstates[:2],
                                           workloads=factors),
                dict(states=tstates, workloads=factors, state=tst),
                dict(states=tstates, workloads=factors, telemetry=True)):
        with pytest.raises(ValueError):
            tsim_.qos(cfgs, **bad)


def test_carried_wait_equal(setups):
    jsim, tsim_ = setups["dien"]
    jst, tst = _live(jsim, tsim_, "dien")
    for at in (0.0, 0.001, 0.01):
        assert tsim_.carried_wait(tst, (3, 2, 1), at) == \
            jsim.carried_wait(jst, (3, 2, 1), at)


def test_horizon_guard_raises_on_the_same_inputs(ref, setups):
    jsim, tsim_ = setups["mtwnd"]
    far = np.zeros(40)
    far[:5] = 2.0e5
    jst = ref["sim"].PoolState(free=far, clock=0.0)
    tst = _state(jst)
    for sim, st in ((jsim, jst), (tsim_, tst)):
        with pytest.raises(ValueError, match="horizon"):
            sim.simulate((4, 0, 1), state=st)
        with pytest.raises(ValueError, match="horizon"):
            sim.qos(np.ones((2, 3), np.int64), state=st)
        with pytest.raises(ValueError, match="horizon"):
            sim.qos(np.ones((2, 3), np.int64), workloads=[1.0], state=st)
        with pytest.raises(ValueError, match="slots"):
            sim.simulate((1, 1, 1), state=type(st)(free=np.zeros(8)))
