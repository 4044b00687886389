"""Port parity: the telemetry plane (ROADMAP A-9) —
``repro_torch.serving.telemetry`` (the reference's numpy module, copied)
and ``telemetry=True`` on every simulator lane — against
``repro.serving``.

* The copied module: edges, ``bucket_index``, ``from_arrays``,
  ``queue_depth`` and every ``Telemetry`` method on the same inputs.
* ``telemetry=True`` on the single, segment, batch, grid (shared and
  per-row tables), warm and routed (single and stacked policy) lanes:
  every field equal to the reference's, bit for bit.  The batch and grid
  lanes read the ``fcfs_scan`` kernel's in-carry counters (on the CPU, its
  plain version's), the single and segment lanes the dispatch trace.
* ``tail_latency``, and windowed ``segment_telemetry`` merged back to the
  whole segment.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fcfs_scan as tfcfs  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.serving import from_fields  # noqa: E402
from repro_torch.serving import instance as tinst  # noqa: E402
from repro_torch.serving import routing as troute  # noqa: E402
from repro_torch.serving import simulator as tsim  # noqa: E402
from repro_torch.serving import telemetry as ttel  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

CPU = "cpu"
MODELS = ["mtwnd", "dien", "candle", "resnet50", "vgg19"]
N_QUERIES = 1500
FIELDS = ("served", "miss", "busy_ms", "lat_hist", "wait_hist", "depth_sum",
          "depth_peak")


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving`` (simulator, pool, telemetry,
    routing, instance), imported with the ``enable_x64`` alias its import
    needs on jax 0.9, as in ``tests/test_torch_simulator.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import (instance, pool, routing, simulator,
                                   telemetry)
    return {"sim": simulator, "pool": pool, "tel": telemetry,
            "route": routing, "inst": instance}


@pytest.fixture(scope="module")
def setups(ref):
    out = {}
    for model in MODELS:
        jev, _, _ = ref["pool"].make_paper_setup(model, n_queries=N_QUERIES)
        w = jev.workload
        tw = twl.Workload(arrivals=w.arrivals, batches=w.batches,
                          rate_qps=w.rate_qps)
        types = [tinst.AWS_INSTANCES[t.name] for t in jev.types]
        out[model] = (jev.sim, tsim.PoolSimulator(
            tinst.MODEL_PROFILES[model], types, tw, device=CPU))
    return out


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def _tel_equal(t, j):
    assert type(t) is ttel.Telemetry
    for name in FIELDS:
        _equal(getattr(t, name), getattr(j, name))


def _configs(n, seed):
    cfgs = np.random.default_rng(seed).integers(0, 6, (n, 3))
    cfgs[0] = 0
    return cfgs


# -------------------------------------------------------- the numpy module
def test_copied_module_equal(ref):
    jt = ref["tel"]
    assert ttel.N_BUCKETS == jt.N_BUCKETS
    _equal(ttel.BUCKET_EDGES, jt.BUCKET_EDGES)
    _equal(tref.bucket_edges().numpy(), jt.BUCKET_EDGES)
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.exponential(0.01, 5000), [0.0, np.inf, 1e-4,
                                                      0.0002, 2e5]])
    _equal(ttel.bucket_index(x), jt.bucket_index(x))
    n, n_types = 3000, 3
    lat = rng.exponential(0.01, n)
    wait = np.maximum(lat - 0.004, 0.0)
    svc = rng.uniform(0.001, 0.01, n)
    tslot = rng.integers(0, n_types, n)
    depth = rng.integers(0, 9, n)
    a = ttel.from_arrays(lat, wait, svc, tslot, n_types, 0.02, depth=depth)
    b = jt.from_arrays(lat, wait, svc, tslot, n_types, 0.02, depth=depth)
    _tel_equal(a, b)
    slots = rng.integers(0, 6, n)
    fin = np.sort(rng.uniform(0, 3, n))
    free0 = rng.uniform(0, 0.1, 6)
    active = np.array([1, 1, 1, 1, 0, 0], bool)
    arr = np.sort(rng.uniform(0, 3, n))
    _equal(ttel.queue_depth(slots, fin, free0, active, arr),
           jt.queue_depth(slots, fin, free0, active, arr))
    half = ttel.from_arrays(lat[:900], wait[:900], svc[:900], tslot[:900],
                            n_types, 0.02)
    rest = ttel.from_arrays(lat[900:], wait[900:], svc[900:], tslot[900:],
                            n_types, 0.02)
    jhalf = jt.from_arrays(lat[:900], wait[:900], svc[:900], tslot[:900],
                           n_types, 0.02)
    jrest = jt.from_arrays(lat[900:], wait[900:], svc[900:], tslot[900:],
                           n_types, 0.02)
    _tel_equal(half + rest, jhalf.merge(jrest))
    for pct in (50, 95, 99, 99.9):
        assert a.latency_percentile(pct) == b.latency_percentile(pct)
        assert a.wait_percentile(pct) == b.wait_percentile(pct)
    assert a.to_dict() == b.to_dict()
    assert a.mean_depth() == b.mean_depth() and a.n == b.n == n
    _equal(a.utilization((2, 1, 3), 4.0), b.utilization((2, 1, 3), 4.0))
    _equal(a.miss_rate_by_type(), b.miss_rate_by_type())
    _equal(a.busy_seconds(), b.busy_seconds())
    _tel_equal(ttel.Telemetry.zeros(3, (2, 4)), jt.Telemetry.zeros(3, (2, 4)))
    _tel_equal(from_fields("Telemetry", vars(b)), b)
    stacked = ttel.Telemetry(**{f: np.stack([getattr(a, f)] * 2)
                                for f in FIELDS})
    _tel_equal(stacked[1], b)
    with pytest.raises(ValueError):
        stacked.latency_percentile(99)
    with pytest.raises(ValueError):
        a.merge(stacked)


# ------------------------------------------------------------ the lanes
@pytest.mark.parametrize("model", MODELS)
def test_single_and_batch_lanes_equal(setups, model):
    jsim, tsim_ = setups[model]
    for cfg in ((3, 2, 1), (0, 0, 0), (10, 10, 20)):
        t = tsim_.simulate(cfg, telemetry=True)
        j = jsim.simulate(cfg, telemetry=True)
        _tel_equal(t.telemetry, j.telemetry)
        _equal(t.lat, j.lat)
        _tel_equal(tsim_.qos(cfg, telemetry=True).telemetry,
                   jsim.qos(cfg, telemetry=True).telemetry)
    cfgs = _configs(12, 1)
    t = tsim_.simulate(cfgs, telemetry=True)
    j = jsim.simulate(cfgs, telemetry=True)
    _tel_equal(t.telemetry, j.telemetry)
    _equal(t.lat, j.lat)
    q = tsim_.qos(cfgs, telemetry=True)
    _tel_equal(q.telemetry, jsim.qos(cfgs, telemetry=True).telemetry)
    _equal(q.rates, tsim_.qos(cfgs).rates)
    # the kernel's counters on row i equal the single lane's trace on it
    _tel_equal(t.telemetry[3], tsim_.simulate(cfgs[3],
                                              telemetry=True).telemetry)


@pytest.mark.parametrize("model", ["mtwnd", "resnet50"])
def test_grid_lanes_equal(ref, setups, model):
    jsim, tsim_ = setups[model]
    cfgs = _configs(8, 2)
    factors = [0.8, 1.0, 1.4]
    for fn in ("simulate", "qos"):
        t = getattr(tsim_, fn)(cfgs, workloads=factors, telemetry=True)
        j = getattr(jsim, fn)(cfgs, workloads=factors, telemetry=True)
        _tel_equal(t.telemetry, j.telemetry)
    tables = []
    for dist in ("lognormal", "gaussian", "bucketed-small"):
        w = ref["pool"].paper_workload(model, n_queries=N_QUERIES,
                                       batch_dist=dist)
        tables.append(ref["inst"].service_table_for(jsim.model, jsim.types,
                                                    w))
    kw = dict(workloads=factors, service_tables=np.stack(tables),
              telemetry=True)
    _tel_equal(tsim_.qos(cfgs, **kw).telemetry, jsim.qos(cfgs, **kw).telemetry)
    _tel_equal(tsim_.simulate(cfgs, **kw).telemetry,
               jsim.simulate(cfgs, **kw).telemetry)


@pytest.mark.parametrize("model", ["mtwnd", "dien"])
def test_warm_and_routed_lanes_equal(ref, setups, model):
    jsim, tsim_ = setups[model]
    prices = [t.price for t in jsim.types]
    jseg = jsim.segment_from(jsim.initial_state(), (3, 2, 1))
    tseg = tsim_.segment_from(tsim_.initial_state(), (3, 2, 1))
    clock = float(jsim.workload.arrivals[800])
    jst, tst = (s.state_at(800).rebased(clock) for s in (jseg, tseg))
    jhed = ref["route"].named_policy("hedged", prices)
    jstack = ref["route"].RoutingPolicy.stack(
        [ref["route"].named_policy(n, prices)
         for n in ("cost_aware", "affinity")])
    cfgs = _configs(6, 3)
    for jpol in (None, jhed, jstack):
        tpol = None if jpol is None else from_fields("RoutingPolicy",
                                                     vars(jpol))
        for warm in (False, True):
            jkw = dict(state=jst, deployed=(3, 2, 1)) if warm else {}
            tkw = dict(state=tst, deployed=(3, 2, 1)) if warm else {}
            for lane in (dict(), dict(workloads=[1.0, 1.5])):
                t = tsim_.qos(cfgs, policy=tpol, telemetry=True, **tkw,
                              **lane)
                j = jsim.qos(cfgs, policy=jpol, telemetry=True, **jkw, **lane)
                _tel_equal(t.telemetry, j.telemetry)
                _equal(t.rates, j.rates)
        if jpol is not jstack:
            t = tsim_.simulate((3, 2, 2), state=tst, policy=tpol,
                               telemetry=True)
            j = jsim.simulate((3, 2, 2), state=jst, policy=jpol,
                              telemetry=True)
            _tel_equal(t.telemetry, j.telemetry)


def test_kernel_counters_equal_reference_in_carry_scan(ref):
    """The plain ``fcfs_scan``'s counters against the reference's in-carry
    telemetry scans on the same arrays (any carry, absent slots, a per-row
    table), with and without a policy."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    n_w, n_b, n_s, nq, n_types = 2, 5, 12, 400, 3
    arr = np.sort(rng.exponential(0.002, (n_w, nq)).cumsum(axis=1),
                  axis=1).astype(np.float32)
    svc = rng.uniform(0.001, 0.02, (n_w, n_types, nq)).astype(np.float32)
    tos = rng.integers(0, n_types, (n_b, n_s)).astype(np.int32)
    free0 = np.where(rng.uniform(size=(n_b, n_s)) < 0.2, 1e30,
                     rng.uniform(0.0, 0.01, (n_b, n_s))).astype(np.float32)
    n_act = (free0 < 1e29).sum(axis=1).astype(np.int32)
    prio = np.arange(n_s, dtype=np.float32)
    pref = rng.uniform(0, 3, (n_b, n_s)).astype(np.float32)
    aff = rng.uniform(0, 5, n_b).astype(np.float32)
    hed = rng.uniform(0, 1, n_b).astype(np.float32)
    qos_t = 0.02
    common = (jnp.asarray(arr), jnp.transpose(jnp.asarray(svc), (0, 2, 1)),
              jnp.asarray(tos), jnp.asarray(prio), jnp.asarray(free0),
              jnp.arange(n_s, dtype=jnp.int32), jnp.float32(qos_t),
              jnp.asarray(n_act), jnp.arange(n_types, dtype=jnp.int32),
              jnp.arange(32, dtype=jnp.int32),
              jnp.asarray(ref["tel"].BUCKET_EDGES))
    t = [torch.from_numpy(x) for x in (arr, svc, tos, prio, free0)]
    for policy in (False, True):
        if policy:
            want = ref["sim"]._grid_counts_policy_tel_tables_jit(
                *common, jnp.asarray(pref), jnp.asarray(aff),
                jnp.asarray(hed))
            pol = tuple(torch.from_numpy(x) for x in (pref, aff, hed))
        else:
            want = ref["sim"]._grid_counts_tel_tables_jit(*common)
            pol = None
        got = tref.fcfs_scan_ref(*t, qos_t, tfcfs.BIG, policy=pol,
                                 n_active=torch.from_numpy(n_act))
        _equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(tfcfs.split_tel(got[5], n_types), want[1:]):
            _equal(g.numpy(), np.asarray(w))


def test_tail_latency_equal(setups):
    for model in ("mtwnd", "candle"):
        jsim, tsim_ = setups[model]
        for cfg in ((4, 0, 1), (2, 3, 1)):
            for pct in (50, 99):
                assert tsim_.tail_latency(cfg, pct) == \
                    jsim.tail_latency(cfg, pct)
    jsim, tsim_ = setups["mtwnd"]
    assert tsim_.tail_latency((4, 0, 1), 99, policy=troute.named_policy(
        "hedged", [t.price for t in tsim_.types])) > 0


@pytest.mark.parametrize("model", ["mtwnd", "vgg19"])
def test_windowed_segment_telemetry_merges_to_the_whole(setups, model):
    jsim, tsim_ = setups[model]
    cfg = (4, 1, 1)
    tseg = tsim_.segment_from(tsim_.initial_state(), cfg, telemetry=True)
    jseg = jsim.segment_from(jsim.initial_state(), cfg, telemetry=True)
    _tel_equal(tseg.telemetry, jseg.telemetry)
    cuts = [0, 1, 400, 999, 1000, N_QUERIES]
    merged = ttel.Telemetry.zeros(3)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        part = tsim_.segment_telemetry(tseg, cfg, lo, hi)
        _tel_equal(part, jsim.segment_telemetry(jseg, cfg, lo, hi))
        merged = merged + part
    _tel_equal(merged, tseg.telemetry)
    with pytest.raises(ValueError):
        tsim_.segment_telemetry(tseg, cfg, 10, 5)
