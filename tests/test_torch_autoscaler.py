"""Port parity: RIBBON's load-change adaptation (paper §5.5),
``repro_torch.serving.autoscaler``, against ``repro.serving.autoscaler``,
both run in the same test on the reference's mtwnd stream (1500 queries,
seed 0) handed across as arrays.

* ``LoadMonitor``: ``window_stats``, ``observe``, ``downshift`` and
  ``reset`` on the same windows.
* The example (``examples/autoscale_loadchange.py``): converge on the base
  load from (5, 0, 0), detect the 1.5x load, re-measure the incumbent,
  then the sequential ``rescale(budget=40)``.  The base search, the
  detection and the incumbent's QoS are the reference's; the rescale finds
  the reference's pool at its price.  Its sample count is not compared:
  late in the warm-restarted search every open candidate's EI is float32
  rounding noise (it cancels about 20x), so the picks follow the GP
  posterior's last bits, which no two linear-algebra backends share
  (ROADMAP C-R19).
* The warm anchor: the base pool's segment (with telemetry) under the
  policy, its carry after 1000 queries rebased to the 1000th arrival, and
  ``rescale(budget=40, load_factors=[1.0, 1.5], warm_state=...,
  deployed=base, policy=...)``: every ``ScaleEvent`` field equal to the
  reference's, and the segment's telemetry and ``tail_latency``.
"""

import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import RibbonOptimizer, SearchSpace  # noqa: E402
from repro_torch.serving import autoscaler as tas  # noqa: E402
from repro_torch.serving import instance as tinst  # noqa: E402
from repro_torch.serving import pool as tpool  # noqa: E402
from repro_torch.serving import routing as troute  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

CPU = "cpu"
FIELDS = ("served", "miss", "busy_ms", "lat_hist", "wait_hist", "depth_sum",
          "depth_peak")


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving`` (pool, autoscaler, routing) and
    ``repro.core``, imported with the ``enable_x64`` alias its import needs
    on jax 0.9, as in ``tests/test_torch_simulator.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import autoscaler, pool, routing
    import repro.core as core
    return {"pool": pool, "as": autoscaler, "route": routing, "core": core}


@pytest.fixture(scope="module")
def mtwnd(ref):
    """(reference evaluator, port evaluator on its arrays, reference
    space, port space)."""
    jev, jspace, _ = ref["pool"].make_paper_setup("mtwnd", seed=0,
                                                  n_queries=1500)
    w = jev.workload
    tw = twl.Workload(arrivals=w.arrivals, batches=w.batches,
                      rate_qps=w.rate_qps)
    types = [tinst.AWS_INSTANCES[t.name] for t in jev.types]
    tev = tpool.PoolEvaluator(tinst.MODEL_PROFILES["mtwnd"], types, tw,
                              device=CPU)
    return jev, tev, jspace, SearchSpace(jspace.bounds, jspace.prices)


def _converge(opt, ev):
    """The example's base-load search: ask/tell until done."""
    while not opt.done:
        cfg = opt.ask()
        if cfg is None:
            break
        opt.tell(cfg, ev(cfg))
    return opt


@pytest.fixture(scope="module")
def converged(ref, mtwnd):
    """Both packages' optimizers converged on the base load, once."""
    jev, tev, jspace, tspace = mtwnd
    jopt = _converge(ref["core"].RibbonOptimizer(jspace, qos_target=0.99,
                                                 start=(5, 0, 0)), jev)
    topt = _converge(RibbonOptimizer(tspace, qos_target=0.99,
                                     start=(5, 0, 0), device=CPU), tev)
    return jopt, topt


def _base(converged):
    """Fresh copies of the converged optimizers (``rescale`` restarts the
    one it is given)."""
    return copy.deepcopy(converged)


def test_load_monitor_equal(ref):
    rng = np.random.default_rng(0)
    windows = []
    for scale in (1.0, 1.0, 1.6, 0.7, 2.5, 0.5):
        lat = rng.exponential(0.01 * scale, 200)
        waits = np.where(rng.uniform(size=200) < 0.3 * scale,
                         rng.exponential(0.004, 200), 0.0)
        windows.append((lat, waits))
    for kw in (dict(), dict(qos_target=0.9, window=100),
               dict(qos_drop_threshold=0.01, queue_growth_threshold=1.5)):
        tm, jm = tas.LoadMonitor(**kw), ref["as"].LoadMonitor(**kw)
        assert tm.downshift(*windows[0], 0.03) == jm.downshift(
            *windows[0], 0.03) is False
        for lat, waits in windows:
            assert tas.LoadMonitor.window_stats(lat, waits, 0.03) == \
                ref["as"].LoadMonitor.window_stats(lat, waits, 0.03)
            assert tm.observe(lat, waits, 0.03) == jm.observe(lat, waits,
                                                              0.03)
            assert tm.downshift(lat, waits, 0.03) == jm.downshift(lat, waits,
                                                                  0.03)
            assert (tm._baseline_rate, tm._baseline_queue) == \
                (jm._baseline_rate, jm._baseline_queue)
        tm.reset()
        jm.reset()
        assert tm._baseline_rate is None is jm._baseline_rate
    idle = (np.full(200, 0.001), np.zeros(200))
    tm, jm = tas.LoadMonitor(), ref["as"].LoadMonitor()
    for m in (tm, jm):
        m.observe(*idle, 0.03)
    assert tm.downshift(*idle, 0.03) is jm.downshift(*idle, 0.03) is False


def test_example_sequential_rescale(ref, mtwnd, converged):
    """``examples/autoscale_loadchange.py``, both packages side by side."""
    jev, tev, _, _ = mtwnd
    jopt, topt = _base(converged)
    jb, tb = jopt.trace.best_feasible(), topt.trace.best_feasible()
    assert (tb.config, tb.cost, tb.qos_rate) == (jb.config, jb.cost,
                                                 jb.qos_rate) == \
        ((4, 0, 1), 2.253, tb.qos_rate)
    assert topt.trace.n_samples == jopt.trace.n_samples == 38
    jhot = ref["pool"].PoolEvaluator(jev.model, jev.types,
                                     jev.workload.scaled(1.5))
    thot = tpool.PoolEvaluator(tev.model, tev.types, tev.workload.scaled(1.5),
                               device=CPU)
    detected = []
    for ev, hot, mon in ((jev, jhot, ref["as"].LoadMonitor(0.99)),
                         (tev, thot, tas.LoadMonitor(0.99))):
        lat0 = ev.sim.simulate(jb.config).lat
        mon.observe(lat0, np.zeros_like(lat0), ev.model.qos_latency)
        lat1 = hot.sim.simulate(jb.config).lat
        detected.append((mon.observe(lat1, np.maximum(lat1 - lat0, 0),
                                     ev.model.qos_latency),
                         hot(jb.config)))
    assert detected[0] == detected[1] and detected[1][0] is True
    assert detected[1][1] < 0.99
    jevent = ref["as"].rescale(jopt, jhot, budget=40)
    tevent = tas.rescale(topt, thot, budget=40)
    assert (tevent.new_best, tevent.new_cost) == \
        (jevent.new_best, jevent.new_cost) == ((5, 1, 1), 3.119)
    for name in ("kind", "old_best", "old_cost", "qos_by_load", "warm_scored",
                 "policy"):
        assert getattr(tevent, name) == getattr(jevent, name)
    assert 1 < tevent.samples_used <= 41


@pytest.mark.parametrize("name", [None, "hedged", "affinity", "cost_aware"])
def test_warm_grid_rescale_equal(ref, mtwnd, converged, name):
    """The warm anchor under a routing policy: every ``ScaleEvent`` field,
    the segment's telemetry and the base pool's tail latency equal the
    reference's."""
    jev, tev, jspace, _ = mtwnd
    jopt, topt = _base(converged)
    base = jopt.trace.best_feasible().config
    if name is None:
        jpol = tpol = None
    else:
        jpol = ref["route"].named_policy(name, jspace.prices)
        tpol = troute.named_policy(name, jspace.prices)
    events, tails = [], []
    for ev, opt, pol, mod in ((jev, jopt, jpol, ref["as"]),
                              (tev, topt, tpol, tas)):
        seg = ev.sim.segment_from(ev.sim.initial_state(), base, policy=pol,
                                  telemetry=True)
        st = seg.state_at(1000).rebased(float(ev.workload.arrivals[1000]))
        events.append(mod.rescale(opt, ev, budget=40,
                                  load_factors=[1.0, 1.5], warm_state=st,
                                  deployed=base, policy=pol))
        tails.append((seg.telemetry, seg.telemetry.latency_percentile(99),
                      ev.sim.tail_latency(base, 99, policy=pol)))
    jevent, tevent = events
    assert vars(tevent) == vars(jevent)
    assert tevent.warm_scored is True
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tails[1][0], f),
                                      getattr(tails[0][0], f))
    assert tails[1][1:] == tails[0][1:]
    anchors = {None: ((6, 0, 1), 3.305, 41), "hedged": ((1, 5, 1), 2.375, 22)}
    if name in anchors:
        assert (tevent.new_best, tevent.new_cost, tevent.samples_used) == \
            anchors[name]


def test_rescale_refusals_match(ref, converged):
    jopt, topt = _base(converged)
    for mod, opt in ((ref["as"], jopt), (tas, topt)):
        with pytest.raises(TypeError, match="grid"):
            mod.rescale(opt, lambda cfg: 1.0, load_factors=[1.0])
        with pytest.raises(TypeError, match="grid_from"):
            mod.rescale(opt, object(), load_factors=[1.0],
                        warm_state=object())
