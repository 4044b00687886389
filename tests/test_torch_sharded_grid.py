"""Port parity: the simulator's sharded grid lanes (``PoolSimulator``'s
QoS grid over ``lane_devices``) against its unsharded dispatch and the
reference's.

``simulator.lane_devices`` is replaced to force a lane mesh, as
``tests/test_streaming.py`` replaces ``jax.local_device_count``: two or
four shards on the CPU (the plain scan), one device named again and
again, as the one-card stand-in runs them on ``cuda:0``.

* The reference's eight ``SHARD_CASES`` (``tests/test_streaming.py``)
  at 2 and 4 lanes: the port's sharded rates equal its unsharded ones and
  the reference's unsharded ones, bit for bit, on the reference's arrays.
* The W = 1, odd-B case of ``tests/test_grid_eval.py`` at 4 lanes, every
  row against a simulator bound to the scaled workload.
* The arrival grid's cache: cyclic padding beyond W, LRU with a hit
  refreshing its place.
* The telemetry grid and the per-row ``states=`` grid stay one launch
  whatever the lane count; a sharded dispatch is one launch a shard.
* ``PoolEvaluator``'s grid and the warm ``rescale`` of the §5.5 anchors
  over 4 forced lanes reach the one-lane pools.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import RibbonOptimizer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import autoscaler as tas  # noqa: E402
from repro_torch.serving import instance as tinst  # noqa: E402
from repro_torch.serving import pool as tpool  # noqa: E402
from repro_torch.serving import routing as troute  # noqa: E402
from repro_torch.serving import simulator as tsim  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

CPU = torch.device("cpu")
MAX_INST = 8
TOY = dict(
    fast=dict(name="fast", price=1.0, flops=1e9, mem_bw=1e9, overhead=1e-3),
    slow=dict(name="slow", price=0.3, flops=2e8, mem_bw=5e8, overhead=2e-3))
PROF = dict(name="toy", flops_per_sample=1e6, act_bytes_per_sample=1e4,
            weight_bytes=1e5, qos_latency=0.05)

# (factors, n_cfgs, tables, n_policies) of tests/test_streaming.py: both
# split axes and both cyclic paddings on a 2-lane mesh
SHARD_CASES = [
    ((1.0, 1.2, 1.5), 3, False, 0),       # w-split, pad_w=1
    ((1.3,), 3, False, 0),                # b-split, pad_b=1
    ((1.0, 1.2, 1.5), 3, True, 0),        # w-split + table row padding
    ((1.3,), 3, True, 0),                 # b-split, stacked tables
    ((1.0, 1.1, 1.2, 1.5), 3, False, 2),  # w-split, policy fold
    ((1.3,), 1, False, 3),                # b-split pads policy operands
    ((1.0, 1.1, 1.2, 1.5), 3, True, 2),   # w-split, both stacked axes
    ((1.3,), 1, True, 3),                 # b-split, both stacked axes
]


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving`` modules, imported with the
    ``enable_x64`` alias their import needs on jax 0.9, as in
    ``tests/test_torch_simulator.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import instance, routing, simulator, workload
    return {"sim": simulator, "wl": workload, "inst": instance,
            "route": routing}


def _lanes(monkeypatch, n: int) -> None:
    monkeypatch.setattr(tsim, "lane_devices", lambda device: [device] * n)


def _pair(ref, seed=1, n=150, rate=120.0):
    """(reference simulator, port simulator) on the reference's workload."""
    w = ref["wl"].generate_workload(seed, n, rate, median_batch=8.0,
                                    max_batch=32)
    jsim = ref["sim"].PoolSimulator(
        ref["inst"].ModelProfile(**PROF),
        [ref["inst"].InstanceType(**TOY[k]) for k in ("fast", "slow")], w,
        max_instances=MAX_INST)
    tw = twl.Workload(arrivals=w.arrivals, batches=w.batches,
                      rate_qps=w.rate_qps)
    tsimr = tsim.PoolSimulator(
        tinst.ModelProfile(**PROF),
        [tinst.InstanceType(**TOY[k]) for k in ("fast", "slow")], tw,
        max_instances=MAX_INST, device=CPU)
    return jsim, tsimr, w


def _kwargs(mod, sim_tables, factors, tables, n_pol):
    kw = {"workloads": list(factors)}
    if tables:
        kw["service_tables"] = np.stack([sim_tables] * len(factors))
    if n_pol:
        kw["policy"] = mod.RoutingPolicy.stack(
            [mod.RoutingPolicy.fcfs(2), mod.RoutingPolicy.hedged(2),
             mod.RoutingPolicy.cost_aware([1.0, 0.3])][:n_pol])
    return kw


@pytest.mark.parametrize("n_lanes", [2, 4])
@pytest.mark.parametrize("factors,n_cfgs,tables,n_pol", SHARD_CASES)
def test_sharded_grid_bit_identical(ref, monkeypatch, n_lanes, factors,
                                    n_cfgs, tables, n_pol):
    jsim, sim, w = _pair(ref)
    cfgs = np.array([(1, 1), (2, 2), (0, 3)][:n_cfgs])
    tbl = ref["inst"].service_time_table(
        ref["inst"].ModelProfile(**PROF),
        [ref["inst"].InstanceType(**TOY[k]) for k in ("fast", "slow")],
        w.batches)
    want = np.asarray(jsim.qos(cfgs, **_kwargs(ref["route"], tbl, factors,
                                               tables, n_pol)).rates)
    kw = _kwargs(troute, tbl, factors, tables, n_pol)
    base = sim.qos(cfgs, **kw).rates
    _lanes(monkeypatch, n_lanes)
    sharded = sim.qos(cfgs, **kw).rates
    assert sim.n_sharded == 1
    np.testing.assert_array_equal(sharded, base)
    np.testing.assert_array_equal(sharded, want)


def test_grid_bit_identity_w1_odd_b_four_lanes(ref, monkeypatch):
    """The W = 1, odd-B case of ``tests/test_grid_eval.py``: the
    workload-axis pad exceeds W; every row equals a simulator bound to the
    scaled workload, in the port and in the reference."""
    jsim, sim, w = _pair(ref, seed=0, n=100)
    cfgs = np.array([[1, 0], [2, 1], [0, 3]])
    _lanes(monkeypatch, 4)
    for factors in [(1.5,), (1.0, 1.2), (1.0, 1.2, 1.5)]:
        got = sim.qos(cfgs, workloads=factors).rates
        for row, f in enumerate(factors):
            ws = w.scaled(f)
            one = tsim.PoolSimulator(
                sim.model, sim.types,
                twl.Workload(arrivals=ws.arrivals, batches=ws.batches,
                             rate_qps=ws.rate_qps),
                max_instances=MAX_INST, device=CPU)
            np.testing.assert_array_equal(got[row], one.qos(cfgs).rates)
            np.testing.assert_array_equal(
                got[row], np.asarray(jsim.qos(cfgs, workloads=[f]).rates)[0])
    assert sim.n_sharded == 3


def test_grid_arr_shards_pads_cyclically_beyond_workload_count(ref):
    """The workload-axis pad may exceed W (one level over 8 devices): rows
    wrap cyclically, one shard a device, the shards in order."""
    _, sim, _ = _pair(ref)
    for n_w, n_dev in [(1, 4), (2, 8), (3, 4), (5, 8), (4, 4)]:
        factors = tuple(1.0 + 0.1 * i for i in range(n_w))
        arr = np.asarray(sim._stacked_arrivals(factors), np.float32)
        shards = sim._grid_arr_shards(arr, "w", [CPU] * n_dev, factors)
        assert len(shards) == n_dev
        out = torch.cat(shards).numpy()
        pad_w = (-n_w) % n_dev
        assert out.shape == (n_w + pad_w, sim.workload.n_queries)
        for i in range(n_w + pad_w):
            np.testing.assert_array_equal(out[i], arr[i % n_w])


def test_grid_arr_shard_cache_is_lru_with_hit_refresh(ref):
    """The per-load-factor-tuple device cache of arrival grids evicts the
    least recently used entry: re-sweeping one level set keeps it resident
    while fresh sets cycle through (``tests/test_grid_eval.py``)."""
    _, sim, _ = _pair(ref)
    arr = np.asarray(sim.workload.arrivals, np.float32)[None, :]
    devs = [CPU, CPU]
    hot = ("b", 2, (1.0,))
    sim._grid_arr_shards(arr, "b", devs, (1.0,))
    for k in range(7):                          # fill the 8-entry cache
        sim._grid_arr_shards(arr, "b", devs, (1.0 + 0.1 * (k + 1),))
    assert hot in sim._grid_arrs and len(sim._grid_arrs) == 8
    sim._grid_arr_shards(arr, "b", devs, (1.0,))   # hit: refresh recency
    sim._grid_arr_shards(arr, "b", devs, (9.9,))   # miss: evicts the LRU
    assert hot in sim._grid_arrs                # survived thanks to the hit
    assert ("b", 2, (1.1,)) not in sim._grid_arrs   # the stalest went
    assert len(sim._grid_arrs) == 8


def _count_scans(monkeypatch) -> list:
    calls = []
    real = ops.fcfs_scan

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(ops, "fcfs_scan", counted)
    return calls


@pytest.mark.parametrize("n_lanes", [1, 4])
def test_telemetry_and_states_grids_take_one_launch(ref, monkeypatch,
                                                    n_lanes):
    """The reference keeps the telemetry grid and the per-row ``states=``
    grid on one device: one scan whatever the lane count, with the rates
    of the one-lane run; the lean grid takes one launch a shard."""
    _, sim, _ = _pair(ref)
    cfgs = np.array([(1, 1), (2, 2), (0, 3)])
    factors = [1.0, 1.2, 1.5]
    st = sim.segment_from(sim.initial_state(), (2, 1)).state_at(60)
    st = st.rebased(float(sim.workload.arrivals[60]))
    want_tel = sim.qos(cfgs, workloads=factors, telemetry=True)
    want_states = sim.qos(cfgs, workloads=factors,
                          states=[None, (st, (2, 1)), None]).rates
    _lanes(monkeypatch, n_lanes)
    calls = _count_scans(monkeypatch)
    got_tel = sim.qos(cfgs, workloads=factors, telemetry=True)
    assert len(calls) == 1
    got_states = sim.qos(cfgs, workloads=factors,
                         states=[None, (st, (2, 1)), None]).rates
    assert len(calls) == 2
    np.testing.assert_array_equal(got_tel.rates, want_tel.rates)
    for f in ("served", "miss", "lat_hist"):
        np.testing.assert_array_equal(getattr(got_tel.telemetry, f),
                                      getattr(want_tel.telemetry, f))
    np.testing.assert_array_equal(got_states, want_states)
    sim.qos(cfgs, workloads=factors)
    assert len(calls) == 2 + n_lanes
    assert sim.n_sharded == (n_lanes > 1)


def _converge(opt, ev):
    while not opt.done:
        cfg = opt.ask()
        if cfg is None:
            break
        opt.tell(cfg, ev(cfg))
    return opt


@pytest.mark.parametrize("name,anchor", [
    (None, ((6, 0, 1), 3.305, 41)), ("hedged", ((1, 5, 1), 2.375, 22))])
def test_evaluator_grid_and_warm_rescale_over_four_lanes(monkeypatch, name,
                                                         anchor):
    """mtwnd from the seed: ``PoolEvaluator.grid`` over 4 forced lanes
    equals the one-lane grid, and the §5.5 warm rescale through them
    reaches the one-lane anchors (``tests/test_torch_autoscaler.py``)."""
    ev, space, _ = tpool.make_paper_setup("mtwnd", device=CPU)
    cfgs = space.enumerate()[::37]
    one = ev.grid(cfgs, [1.0, 1.5])
    opt = _converge(RibbonOptimizer(space, qos_target=0.99, start=(5, 0, 0),
                                    device=CPU), ev)
    base = opt.trace.best_feasible().config
    pol = None if name is None else troute.named_policy(name, space.prices)
    seg = ev.sim.segment_from(ev.sim.initial_state(), base, policy=pol)
    st = seg.state_at(1000).rebased(float(ev.workload.arrivals[1000]))
    _lanes(monkeypatch, 4)
    four, _, _ = tpool.make_paper_setup("mtwnd", device=CPU)
    np.testing.assert_array_equal(four.grid(cfgs, [1.0, 1.5]), one)
    sharded = ev.sim.n_sharded
    event = tas.rescale(opt, ev, budget=40, load_factors=[1.0, 1.5],
                        warm_state=st, deployed=base, policy=pol)
    assert (event.new_best, event.new_cost, event.samples_used) == anchor
    assert event.warm_scored is True
    assert ev.sim.n_sharded > sharded
