"""Port parity: the FCFS pool simulator's cold lanes
(``repro_torch.serving.simulator``), the plain version of the ``fcfs_scan``
kernel and the instance catalog against ``repro.serving``.

The reference's own arrays (its realized workloads, handed across as
numpy) go through both simulators.  Every comparison is bit for bit:
latencies, waits, QoS rates and counts, slot layouts, thresholds and
service tables.  The scan's float32 arithmetic is the same step for step,
the slot layout and the tables are the same numpy code, and the rates are
the same float64 mean (the single lane) or the same device counts (the
batch and grid lanes).  The CUDA kernel is held to the same plain version
on the card by ``chip_smoke.py``.
"""

import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fcfs_scan as tfcfs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import fcfs_scan_ref  # noqa: E402
from repro_torch.serving import instance as tinst  # noqa: E402
from repro_torch.serving import routing as troute  # noqa: E402
from repro_torch.serving import simulator as tsim  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

CPU = "cpu"
MODELS = ["mtwnd", "dien", "candle", "resnet50", "vgg19"]
N_QUERIES = 1500


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving`` (simulator, pool, instance,
    workload), imported with the ``enable_x64`` alias its import needs on
    jax 0.9, as in ``tests/test_torch_engine.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import instance, pool, simulator, workload
    return {"sim": simulator, "pool": pool, "inst": instance,
            "wl": workload}


@pytest.fixture(scope="module")
def setups(ref):
    """Per paper model: the reference's simulator on its standard stream
    and the port's simulator on the same arrays, on the CPU."""
    out = {}
    for model in MODELS:
        jev, _, profile = ref["pool"].make_paper_setup(model,
                                                       n_queries=N_QUERIES)
        w = jev.workload
        tw = twl.Workload(arrivals=w.arrivals, batches=w.batches,
                          rate_qps=w.rate_qps)
        types = [tinst.AWS_INSTANCES[t.name] for t in jev.types]
        out[model] = (jev.sim, tsim.PoolSimulator(
            tinst.MODEL_PROFILES[model], types, tw, device=CPU))
    return out


def _configs(model, n, seed=0):
    """``n`` random configs within the model's search bounds, the first
    all-zero and the second at ``max_instances``."""
    from repro_torch.serving.pool import DEFAULT_BOUNDS
    rng = np.random.default_rng(seed)
    cfgs = np.stack([rng.integers(0, b + 1, n)
                     for b in DEFAULT_BOUNDS[model]], axis=1)
    cfgs[0] = 0
    cfgs[1] = (10, 10, 20)
    return cfgs


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


# ------------------------------------------------------- instance catalog
def test_instance_catalog_equal(ref):
    ji = ref["inst"]
    assert {k: vars(v) for k, v in tinst.AWS_INSTANCES.items()} == \
        {k: vars(v) for k, v in ji.AWS_INSTANCES.items()}
    assert {k: vars(v) for k, v in tinst.MODEL_PROFILES.items()} == \
        {k: vars(v) for k, v in ji.MODEL_PROFILES.items()}
    assert tinst.PAPER_POOLS == ji.PAPER_POOLS
    assert not hasattr(tinst, "TPU_CELLS")


@pytest.mark.parametrize("model", MODELS)
def test_service_tables_equal(ref, model):
    ji = ref["inst"]
    w = ref["pool"].paper_workload(model, n_queries=N_QUERIES)
    wb = ref["pool"].paper_workload(model, n_queries=N_QUERIES,
                                    batch_dist="bucketed-small")
    names = list(ji.AWS_INSTANCES)
    jt = [ji.AWS_INSTANCES[n] for n in names]
    tt = [tinst.AWS_INSTANCES[n] for n in names]
    jp, tp = ji.MODEL_PROFILES[model], tinst.MODEL_PROFILES[model]
    _equal(tinst.service_time_table(tp, tt, w.batches),
           ji.service_time_table(jp, jt, w.batches))
    _equal(tinst.service_time_lut(tp, tt, 64), ji.service_time_lut(jp, jt, 64))
    tb = twl.Workload(arrivals=wb.arrivals, batches=wb.batches,
                      rate_qps=wb.rate_qps, bucket_of=wb.bucket_of,
                      buckets=tuple(twl.RequestBucket(**vars(b))
                                    for b in wb.buckets))
    for jw_, tw_ in ((w, twl.Workload(w.arrivals, w.batches, w.rate_qps)),
                     (wb, tb)):
        _equal(tinst.service_table_for(tp, tt, tw_),
               ji.service_table_for(jp, jt, jw_))
        _equal(tinst.measured_throughputs(tp, tt, tw_),
               ji.measured_throughputs(jp, jt, jw_))
    _equal(tinst.bucketed_service_time_lut(tp, tt, 32, tb.buckets),
           ji.bucketed_service_time_lut(jp, jt, 32, wb.buckets))
    assert vars(tinst.bucket_profile(tp, tb.buckets[1])) == \
        vars(ji.bucket_profile(jp, wb.buckets[1]))


# ---------------------------------------------------- layout and helpers
@pytest.mark.parametrize("max_instances", [8, 40, 64])
def test_slot_layout_equal(ref, max_instances):
    rng = np.random.default_rng(max_instances)
    cfgs = rng.integers(0, max_instances // 3 + 1, (50, 3))
    cfgs[0] = 0
    cfgs[1] = (max_instances, 0, 0)
    for got, want in zip(tsim._expand_slots(cfgs, 3, max_instances),
                         ref["sim"]._expand_slots(cfgs, 3, max_instances)):
        _equal(got, want)
    active = ref["sim"]._expand_slots(cfgs, 3, max_instances)[1]
    _equal(tsim._cold_free0(active), ref["sim"]._cold_free0(active))
    with pytest.raises(ValueError):
        tsim._expand_slots([(max_instances, 1, 0)], 3, max_instances)


@pytest.mark.parametrize("qos", [0.02, 0.03, 0.04, 0.4, 0.8, 0.1, 1 / 3])
def test_qos_threshold_equal(ref, qos):
    assert tsim._qos_threshold_f32(qos) == ref["sim"]._qos_threshold_f32(qos)


def test_constants_equal(ref):
    for name in ("_INF", "_BIG", "_MAX_HORIZON", "_TIE"):
        assert getattr(tsim, name) == getattr(ref["sim"], name)


# ------------------------------------------------------------ the lanes
@pytest.mark.parametrize("model", MODELS)
def test_single_lane_bit_identical(setups, model):
    jsim, tsim_ = setups[model]
    for cfg in [(3, 2, 1), (0, 0, 1), (0, 0, 0), (10, 10, 20)]:
        j, t = jsim.simulate(cfg), tsim_.simulate(cfg)
        _equal(t.lat, j.lat)
        _equal(t.waits, j.waits)
        assert t.state is None
        assert tsim_.qos(cfg).rates == jsim.qos(cfg).rates


@pytest.mark.parametrize("model", MODELS)
def test_batch_lane_bit_identical(setups, model):
    jsim, tsim_ = setups[model]
    cfgs = _configs(model, 64)
    lat = tsim_.simulate(cfgs).lat
    _equal(lat, jsim.simulate(cfgs).lat)
    assert np.isinf(lat[0]).all()
    rates = tsim_.qos(cfgs).rates
    _equal(rates, jsim.qos(cfgs).rates)
    assert rates[0] == 0.0
    # row i of the batch is the single lane on configs[i]
    for i in (1, 7):
        _equal(lat[i], tsim_.simulate(cfgs[i]).lat)


@pytest.fixture(scope="module")
def paper_sims():
    """The port's own ``make_paper_setup`` simulator per paper model (its
    threefry stream from seed 0), on the CPU."""
    from repro_torch.serving.pool import make_paper_setup
    return {m: make_paper_setup(m, device=CPU)[0].sim for m in MODELS}


def _spy_want_lat(monkeypatch):
    """Record ``want_lat`` of every ``ops.fcfs_scan`` call the simulator
    makes."""
    asked = []
    real = ops.fcfs_scan

    def spy(*args, **kwargs):
        asked.append(kwargs.get("want_lat", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(tsim.ops, "fcfs_scan", spy)
    return asked


def _host_rates(sim, cfgs, **kw):
    """The host float64 mean of the batch lane's latencies within the QoS
    latency: what the batch lane's rates were before they came from the
    scan's counts."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # empty stream: 0/0
        return np.mean(sim.simulate(cfgs, **kw).lat <= sim.model.qos_latency,
                       axis=-1)


@pytest.mark.parametrize("model", MODELS)
def test_batch_lane_rates_from_device_counts(paper_sims, model, monkeypatch):
    """The cold batch lane's rates come from the scan's QoS counts against
    the float32 threshold, with no latencies asked of the scan, and equal
    (==) the host mean of its latencies: all-zero rows 0, a stacked policy
    (P, B), telemetry on."""
    sim = paper_sims[model]
    cfgs = _configs(model, 24, seed=3)
    want = _host_rates(sim, cfgs)
    prices = tuple(t.price for t in sim.types)
    stacked = troute.RoutingPolicy.stack(
        [troute.named_policy(n, prices) for n in troute.NAMED_POLICIES])
    want_p = _host_rates(sim, cfgs, policy=stacked)
    want_tel = sim.simulate(cfgs, telemetry=True).telemetry
    asked = _spy_want_lat(monkeypatch)
    got = sim.qos(cfgs).rates
    got_p = sim.qos(cfgs, policy=stacked).rates
    got_tel = sim.qos(cfgs, telemetry=True)
    assert asked == [False, False, False]
    for g, w in ((got, want), (got_p, want_p), (got_tel.rates, want)):
        assert g.dtype == np.float64 and g.shape == w.shape
        assert (g == w).all()
    assert got.shape == (24,) and got_p.shape == (4, 24)
    assert got[0] == 0.0 and (got_p[:, 0] == 0.0).all()
    assert 0.0 < got.max() and got.min() < 1.0   # rates of every kind
    for field in ("served", "miss", "busy_ms", "lat_hist", "wait_hist",
                  "depth_sum", "depth_peak"):
        _equal(getattr(got_tel.telemetry, field), getattr(want_tel, field))


def test_batch_lane_rates_on_an_empty_stream_and_batch(paper_sims,
                                                       monkeypatch):
    """An empty stream gives what the host mean gave (0/0: NaN per row),
    an empty batch an empty array, and neither dispatches."""
    sim = paper_sims["dien"]
    empty = twl.Workload(arrivals=np.zeros(0), batches=np.zeros(0, np.int64),
                         rate_qps=1.0)
    es = tsim.PoolSimulator(sim.model, sim.types, empty, device=CPU)
    cfgs = np.asarray([(1, 0, 0), (0, 0, 0), (0, 2, 1)])
    prices = tuple(t.price for t in sim.types)
    stacked = troute.RoutingPolicy.stack(
        [troute.named_policy(n, prices) for n in ("fcfs", "hedged")])
    asked = _spy_want_lat(monkeypatch)
    for s, c, kw in ((es, cfgs, {}), (es, cfgs, dict(policy=stacked)),
                     (sim, cfgs[:0], {}), (es, cfgs[:0], {}),
                     (sim, cfgs[:0], dict(policy=stacked))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = s.qos(c, **kw).rates
        np.testing.assert_array_equal(got, _host_rates(s, c, **kw))
        assert got.shape == _host_rates(s, c, **kw).shape
        assert np.isnan(got).all() if s is es and c.size else got.size == 0
    assert asked == [] and es.n_dispatches == 0


@pytest.mark.parametrize("model", ["mtwnd", "candle"])
def test_grid_lane_bit_identical(setups, model):
    jsim, tsim_ = setups[model]
    cfgs = _configs(model, 16, seed=1)
    factors = [0.8, 1.0, 1.3]
    _equal(tsim_.simulate(cfgs, workloads=factors).lat,
           jsim.simulate(cfgs, workloads=factors).lat)
    rates = tsim_.qos(cfgs, workloads=factors).rates
    _equal(rates, jsim.qos(cfgs, workloads=factors).rates)
    # the grid's device counts agree with the batch lane's host mean
    _equal(rates[1], tsim_.qos(cfgs).rates)


def test_grid_lane_with_service_tables_bit_identical(ref, setups):
    jsim, tsim_ = setups["mtwnd"]
    ji = ref["inst"]
    tables = []
    for dist in ("lognormal", "gaussian", "bucketed-large"):
        w = ref["pool"].paper_workload("mtwnd", n_queries=N_QUERIES,
                                       batch_dist=dist)
        np.testing.assert_array_equal(w.arrivals, jsim.workload.arrivals)
        tables.append(ji.service_table_for(jsim.model, jsim.types, w))
    tables = np.stack(tables)
    cfgs = _configs("mtwnd", 12, seed=2)
    kw = dict(workloads=[1.0, 1.1, 0.9], service_tables=tables)
    _equal(tsim_.simulate(cfgs, **kw).lat, jsim.simulate(cfgs, **kw).lat)
    _equal(tsim_.qos(cfgs, **kw).rates, jsim.qos(cfgs, **kw).rates)
    with pytest.raises(ValueError):
        tsim_.qos(cfgs, workloads=[1.0], service_tables=tables)
    with pytest.raises(ValueError):
        tsim_.qos(cfgs, service_tables=tables)


def test_empty_stream_and_empty_batch_match(ref, setups):
    jsim, _ = setups["dien"]
    empty = twl.Workload(arrivals=np.zeros(0), batches=np.zeros(0, np.int64),
                         rate_qps=1.0)
    jempty = ref["wl"].Workload(arrivals=np.zeros(0),
                                batches=np.zeros(0, np.int64), rate_qps=1.0)
    js = ref["sim"].PoolSimulator(jsim.model, jsim.types, jempty)
    ts = tsim.PoolSimulator(tinst.MODEL_PROFILES["dien"],
                            [tinst.AWS_INSTANCES[t.name] for t in jsim.types],
                            empty, device=CPU)
    cfgs = np.asarray([(1, 0, 0), (0, 2, 1)])
    _equal(ts.simulate(cfgs).lat, js.simulate(cfgs).lat)
    _equal(ts.qos(cfgs, workloads=[1.0, 2.0]).rates,
           js.qos(cfgs, workloads=[1.0, 2.0]).rates)
    none = np.zeros((0, 3), np.int64)
    _equal(ts.qos(none, workloads=[1.0]).rates,
           js.qos(none, workloads=[1.0]).rates)
    assert ts.n_dispatches == 0


def test_horizon_guard(setups):
    _, tsim_ = setups["mtwnd"]
    with pytest.raises(ValueError, match="horizon"):
        tsim_.qos(_configs("mtwnd", 2), workloads=[1e-6])


def test_every_lane_goes_through_fcfs_scan(setups, monkeypatch):
    _, tsim_ = setups["vgg19"]
    calls = []
    real = ops.fcfs_scan

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tsim.ops, "fcfs_scan", spy)
    before = tsim_.n_dispatches
    cfgs = _configs("vgg19", 4)
    tsim_.qos(cfgs[2])
    tsim_.simulate(cfgs)
    tsim_.qos(cfgs, workloads=[1.0, 2.0])
    assert calls == [(1, N_QUERIES), (1, N_QUERIES), (2, N_QUERIES)]
    assert tsim_.n_dispatches == before + 3


# ------------------------------------ the lanes once refused (A-7 to A-9)
@pytest.mark.parametrize("kwargs,item", [
    (dict(state="idle"), "A-7"),
    (dict(deployed=(1, 0, 0)), "A-7"),
    (dict(policy="fcfs"), "A-8"),
    (dict(telemetry=True), "A-9"),
])
def test_unported_arguments_name_their_item(setups, kwargs, item):
    """The warm (A-7), routed (A-8) and telemetry (A-9) arguments, refused
    before the lanes were ported, now run: from the idle carry, under the
    identity policy and with telemetry on, the single and grid lanes equal
    the cold, unrouted lanes bit for bit; ``deployed=`` without a state is
    refused as the reference refuses it."""
    _, tsim_ = setups["mtwnd"]
    kw = dict(kwargs)
    if kw.get("state") == "idle":
        kw["state"] = tsim_.initial_state()
    if kw.get("policy") == "fcfs":
        kw["policy"] = troute.RoutingPolicy.fcfs(3)
    if "deployed" in kw:
        for fn in (tsim_.simulate, tsim_.qos):
            with pytest.raises(ValueError, match="require state="):
                fn((1, 1, 1), **kw)
        kw["state"] = tsim_.initial_state()
        kw["deployed"] = (0, 0, 0)
    cold = tsim_.simulate((1, 1, 1))
    got = tsim_.simulate((1, 1, 1), **kw)
    _equal(got.lat, cold.lat)
    _equal(got.waits, cold.waits)
    assert tsim_.qos((1, 1, 1), **kw).rates == tsim_.qos((1, 1, 1)).rates
    if kwargs.get("telemetry"):
        assert got.telemetry.n == N_QUERIES
    cfgs = np.ones((2, 3), np.int64)
    grid = dict(kw)
    if "state" in grid:
        grid = dict(states=[(grid["state"], grid.get("deployed"))])
    _equal(tsim_.qos(cfgs, workloads=[1.0], **grid).rates,
           tsim_.qos(cfgs, workloads=[1.0]).rates)


def test_unported_entry_points_name_their_item(setups):
    """``segment_from`` (A-7), ``tail_latency`` (A-9) and the streaming
    simulator (A-10) run; the scenario engine's live plane is still refused
    with its item (ROADMAP item 14)."""
    _, tsim_ = setups["mtwnd"]
    seg = tsim_.segment_from(tsim_.initial_state(), (1, 1, 1))
    _equal(seg.lat, tsim_.simulate((1, 1, 1)).lat)
    tail = tsim_.tail_latency((1, 1, 1))
    assert tail == tsim_.qos((1, 1, 1), telemetry=True).telemetry \
        .latency_percentile(99.0)
    from repro_torch.scenario import LivePlane
    from repro_torch.serving.pool import paper_spec
    stream = tsim.StreamingSimulator(tsim_.model, tsim_.types,
                                     paper_spec("mtwnd"), device=CPU)
    assert stream.qos((1, 1, 1), 300).rate == float(
        tsim.PoolSimulator(tsim_.model, tsim_.types,
                           paper_spec("mtwnd").realize(300),
                           device=CPU).qos((1, 1, 1)).rates)
    with pytest.raises(NotImplementedError, match="item 14"):
        LivePlane(None, {}, 0.05)


# ------------------------------------------ the kernel's plain version
def _scan_inputs(seed, n_w=2, n_b=5, n_s=12, nq=300, n_types=3, ties=False):
    rng = np.random.default_rng(seed)
    arr = np.sort(rng.exponential(0.002, (n_w, nq)).cumsum(axis=1), axis=1)
    svc = rng.uniform(0.001, 0.02, (n_w, n_types, nq))
    if ties:   # bursts at one instant, one service time: many equal keys
        arr = np.floor(np.arange(nq) / 20)[None].repeat(n_w, 0) * 0.003
        svc = np.full((n_w, n_types, nq), 0.004)
    tos = rng.integers(0, n_types, (n_b, n_s))
    # an arbitrary carry, idle, busy and absent slots mixed
    free0 = np.where(rng.uniform(size=(n_b, n_s)) < 0.2, 1e30,
                     rng.uniform(0.0, 0.01, (n_b, n_s)))
    return [x.astype(dt) for x, dt in ((arr, np.float32), (svc, np.float32),
                                       (tos, np.int32), (free0, np.float32))]


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True)])
def test_plain_scan_matches_reference_kernels(ref, seed, ties):
    """The plain version against the reference's vmapped scan and fused
    counter on the same arrays (any carry, shared and per-row tables)."""
    import jax.numpy as jnp
    arr, svc, tos, free0 = _scan_inputs(seed, ties=ties)
    prio = np.arange(tos.shape[1], dtype=np.float32)
    qos_t = ref["sim"]._qos_threshold_f32(0.02)
    targs = [torch.from_numpy(x) for x in (arr, svc, tos, prio, free0)]
    counts, lat, start, free, slot, tel = fcfs_scan_ref(
        *targs, qos_t, tfcfs.BIG, want_lat=True, want_start=True)
    assert slot is None and tel is None
    jfree, (jlat, jstart, _) = ref["sim"]._simulate_scan_grid_tables(
        jnp.asarray(arr), jnp.asarray(svc), jnp.asarray(tos),
        jnp.asarray(prio), jnp.asarray(free0))
    _equal(lat.numpy(), np.asarray(jlat))
    _equal(start.numpy(), np.asarray(jstart))
    _equal(free.numpy(), np.asarray(jfree))
    iota = jnp.arange(tos.shape[1], dtype=jnp.int32)
    jcounts, _ = ref["sim"]._grid_counts_tables_jit(
        jnp.asarray(arr), jnp.transpose(jnp.asarray(svc), (0, 2, 1)),
        jnp.asarray(tos), jnp.asarray(prio), jnp.asarray(free0), iota,
        jnp.float32(qos_t))
    _equal(counts.numpy(), np.asarray(jcounts))
    # one shared table is the same as that table on every row
    shared = fcfs_scan_ref(targs[0], targs[1][:1], *targs[2:], qos_t,
                           tfcfs.BIG, want_lat=True)
    _equal(shared[1].numpy(), fcfs_scan_ref(
        targs[0], targs[1][:1].expand(2, -1, -1), *targs[2:], qos_t,
        tfcfs.BIG, want_lat=True)[1].numpy())


def test_ops_fcfs_scan_takes_the_plain_version_on_cpu():
    arr, svc, tos, free0 = (torch.from_numpy(x) for x in _scan_inputs(3))
    prio = torch.arange(tos.shape[1], dtype=torch.float32)
    before = tfcfs.fcfs_scan_cuda.launches
    got = ops.fcfs_scan(arr, svc, tos, prio, free0, 0.01, want_lat=True)
    want = fcfs_scan_ref(arr, svc, tos, prio, free0, 0.01, tfcfs.BIG,
                         want_lat=True)
    assert got.start is None and want[2] is None
    for g, w in zip((got.counts, got.lat, got.free),
                    (want[0], want[1], want[3])):
        assert torch.equal(g, w)
    assert ops.fcfs_scan(arr, svc, tos, prio, free0, 0.01).lat is None
    assert tfcfs.fcfs_scan_cuda.launches == before


def test_fcfs_scan_cuda_refuses_cpu_tensors():
    arr, svc, tos, free0 = (torch.from_numpy(x) for x in _scan_inputs(4))
    prio = torch.arange(tos.shape[1], dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tfcfs.fcfs_scan_cuda(arr, svc, tos, prio, free0, 0.01)


def _bad_inputs(case):
    arr, svc, tos, free0 = (torch.from_numpy(x) for x in _scan_inputs(5))
    prio = torch.arange(tos.shape[1], dtype=torch.float32)
    args = dict(arrivals=arr, service=svc, type_of_slot=tos, priority=prio,
                free0=free0)
    if case == "arrivals f64":
        args["arrivals"] = arr.double()
    elif case == "types i64":
        args["type_of_slot"] = tos.long()
    elif case == "service rows":
        args["service"] = torch.cat([svc, svc[:1]])
    elif case == "service length":
        args["service"] = svc[:, :, :-1].contiguous()
    elif case == "too many types":
        args["service"] = svc[:, :1].expand(-1, 33, -1).contiguous()
    elif case == "too many slots":
        args["type_of_slot"] = torch.zeros((5, 1025), dtype=torch.int32)
        args["priority"] = torch.zeros(1025)
        args["free0"] = torch.zeros((5, 1025))
    elif case == "priority shape":
        args["priority"] = prio[:-1]
    elif case == "free0 shape":
        args["free0"] = free0[:-1]
    elif case == "non-contiguous":
        args["free0"] = free0.t().contiguous().t()
    elif case == "arrivals 1-D":
        args["arrivals"] = arr[0]
    return args


@pytest.mark.parametrize("case", [
    "arrivals f64", "types i64", "service rows", "service length",
    "too many types", "too many slots", "priority shape", "free0 shape",
    "non-contiguous", "arrivals 1-D"])
def test_fcfs_scan_refuses(case):
    with pytest.raises((TypeError, ValueError)):
        ops.fcfs_scan(qos_t=0.01, **_bad_inputs(case))
