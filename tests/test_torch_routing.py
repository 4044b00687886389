"""Port parity: routing policies (ROADMAP A-8), ``repro_torch.serving.routing``
and the routed lanes of the simulator and ``PoolEvaluator``, against
``repro.serving``.

* ``RoutingPolicy``'s constructors, ``stack``/``row``/``key``/
  ``check_pool``, ``named_policy`` and their validation messages.
* The identity policy equal to ``policy=None`` on every lane.
* The four named policies and a stacked policy on the single, batch and
  grid lanes, cold and warm, bit for bit on the reference's arrays.
* The plain ``fcfs_scan``'s routed keys, rounded as fused multiply-adds
  (``kernels.ref.fma32``), against the reference's routed scan on inputs
  where rounding the sums in two steps picks other slots (ROADMAP C-R18),
  and its two-stage argmin (all idle, none idle, one idle, equal keys,
  absent slots, hedge 0 and 1).
* ``PoolEvaluator``'s per-policy memos.

Policies cross from the reference as their fields
(``repro_torch.serving.from_fields``).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fcfs_scan as tfcfs  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.serving import from_fields  # noqa: E402
from repro_torch.serving import instance as tinst  # noqa: E402
from repro_torch.serving import pool as tpool  # noqa: E402
from repro_torch.serving import routing as troute  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

CPU = "cpu"
MODELS = ["mtwnd", "dien", "candle", "resnet50", "vgg19"]
N_QUERIES = 1500


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving`` (simulator, pool, routing),
    imported with the ``enable_x64`` alias its import needs on jax 0.9, as
    in ``tests/test_torch_simulator.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import pool, routing, simulator
    return {"sim": simulator, "pool": pool, "route": routing}


@pytest.fixture(scope="module")
def evaluators(ref):
    """Per paper model: the reference's evaluator on its standard stream
    and the port's on the same arrays, on the CPU."""
    out = {}
    for model in MODELS:
        jev, _, _ = ref["pool"].make_paper_setup(model, n_queries=N_QUERIES)
        w = jev.workload
        tw = twl.Workload(arrivals=w.arrivals, batches=w.batches,
                          rate_qps=w.rate_qps)
        types = [tinst.AWS_INSTANCES[t.name] for t in jev.types]
        out[model] = (jev, tpool.PoolEvaluator(tinst.MODEL_PROFILES[model],
                                               types, tw, device=CPU))
    return out


def _policy(jpol):
    return from_fields("RoutingPolicy", vars(jpol))


def _policies(ref, prices):
    """(name, reference policy, port policy): the four named policies, a
    from_order with affinity and hedge, and a stacked P = 4 policy."""
    jr = ref["route"]
    out = [(n, jr.named_policy(n, prices), troute.named_policy(n, prices))
           for n in jr.NAMED_POLICIES]
    mixed = jr.RoutingPolicy.from_order([2, 0, 1], affinity=40.0, hedge=0.5)
    out.append(("mixed", mixed, _policy(mixed)))
    stacked = jr.RoutingPolicy.stack([p for _, p, _ in out[1:]])
    out.append(("stacked", stacked, _policy(stacked)))
    return out


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def _fields_equal(t, j):
    for name in ("type_pref", "affinity", "hedge", "name"):
        _equal(getattr(t, name), getattr(j, name))


# ------------------------------------------------------- the policy class
def test_constructors_equal(ref):
    jr = ref["route"]
    prices = (0.526, 0.34, 1.2)
    pairs = [(troute.RoutingPolicy.fcfs(3), jr.RoutingPolicy.fcfs(3)),
             (troute.RoutingPolicy.from_order([1, 2, 0], affinity=2.0,
                                              hedge=0.25),
              jr.RoutingPolicy.from_order([1, 2, 0], affinity=2.0,
                                          hedge=0.25)),
             (troute.RoutingPolicy.cost_aware(prices, hedge=0.5),
              jr.RoutingPolicy.cost_aware(prices, hedge=0.5)),
             (troute.RoutingPolicy.affine(3, 3.0, 0.1),
              jr.RoutingPolicy.affine(3, 3.0, 0.1)),
             (troute.RoutingPolicy.hedged(3, 0.7),
              jr.RoutingPolicy.hedged(3, 0.7))]
    pairs += [(troute.named_policy(n, prices), jr.named_policy(n, prices))
              for n in jr.NAMED_POLICIES]
    assert troute.NAMED_POLICIES == jr.NAMED_POLICIES
    for t, j in pairs:
        _fields_equal(t, j)
        assert t.key() == j.key() and t.stacked == j.stacked
    ts = troute.RoutingPolicy.stack([t for t, _ in pairs])
    js = jr.RoutingPolicy.stack([j for _, j in pairs])
    _fields_equal(ts, js)
    assert ts.key() == js.key() and ts.n_policies == js.n_policies == 9
    for p in (0, 4, 8):
        _fields_equal(ts.row(p), js.row(p))
    _fields_equal(_policy(js), js)
    assert ts.check_pool(3) is ts


def _message(call):
    with pytest.raises((ValueError, TypeError)) as info:
        call()
    return str(info.value)


@pytest.mark.parametrize("case", [
    "pref 3-D", "pref empty", "pref nan", "affinity < 0", "hedge > 1",
    "hedge shape", "order range", "order repeat", "order empty",
    "prices 2-D", "fcfs 0", "affine 0", "hedged 0", "stack empty",
    "stack stacked", "stack mixed", "check_pool", "unknown name"])
def test_validation_messages_equal(ref, case):
    calls = {}
    for side, mod in (("port", troute), ("ref", ref["route"])):
        rp = mod.RoutingPolicy
        calls[side] = {
            "pref 3-D": lambda rp=rp: rp(type_pref=np.zeros((1, 2, 3))),
            "pref empty": lambda rp=rp: rp(type_pref=np.zeros(0)),
            "pref nan": lambda rp=rp: rp(type_pref=[0.0, np.nan]),
            "affinity < 0": lambda rp=rp: rp(type_pref=[0, 1], affinity=-1),
            "hedge > 1": lambda rp=rp: rp(type_pref=[0, 1], hedge=1.5),
            "hedge shape": lambda rp=rp: rp(type_pref=np.zeros((2, 3)),
                                            hedge=[0.1, 0.2, 0.3]),
            "order range": lambda rp=rp: rp.from_order([0, 3, 1]),
            "order repeat": lambda rp=rp: rp.from_order([0, 0, 1]),
            "order empty": lambda rp=rp: rp.from_order([]),
            "prices 2-D": lambda rp=rp: rp.cost_aware([[1.0, 2.0]]),
            "fcfs 0": lambda rp=rp: rp.fcfs(0),
            "affine 0": lambda rp=rp: rp.affine(0),
            "hedged 0": lambda rp=rp: rp.hedged(0),
            "stack empty": lambda rp=rp: rp.stack([]),
            "stack stacked": lambda rp=rp: rp.stack(
                [rp.stack([rp.fcfs(2)])]),
            "stack mixed": lambda rp=rp: rp.stack([rp.fcfs(2), rp.fcfs(3)]),
            "check_pool": lambda rp=rp: rp.fcfs(2).check_pool(3),
            "unknown name": lambda mod=mod: mod.named_policy("nope", [1.0]),
        }[case]
    assert _message(calls["port"]) == _message(calls["ref"])


# ------------------------------------------------------------ the lanes
@pytest.mark.parametrize("model", ["mtwnd", "vgg19"])
def test_identity_policy_equals_none_on_every_lane(evaluators, model):
    _, tev = evaluators[model]
    sim = tev.sim
    fcfs = troute.RoutingPolicy.fcfs(3)
    cfgs = np.random.default_rng(1).integers(0, 6, (8, 3))
    cfgs[0] = 0
    st = sim.segment_from(sim.initial_state(), (3, 1, 1)).state_at(600) \
        .rebased(float(sim.workload.arrivals[600]))
    for kw in (dict(), dict(state=st), dict(state=st, deployed=(3, 1, 1))):
        _equal(sim.simulate(cfgs, policy=fcfs, **kw).lat,
               sim.simulate(cfgs, **kw).lat)
        _equal(sim.qos(cfgs, workloads=[1.0, 1.3], policy=fcfs, **kw).rates,
               sim.qos(cfgs, workloads=[1.0, 1.3], **kw).rates)
        _equal(sim.simulate(cfgs, workloads=[1.2], policy=fcfs, **kw).lat,
               sim.simulate(cfgs, workloads=[1.2], **kw).lat)
    one = sim.simulate((3, 1, 1), policy=fcfs)
    _equal(one.lat, sim.simulate((3, 1, 1)).lat)
    _equal(one.waits, sim.simulate((3, 1, 1)).waits)
    _equal(sim.segment_from(st, (2, 2, 2), policy=fcfs).lat,
           sim.segment_from(st, (2, 2, 2)).lat)


@pytest.mark.parametrize("model", MODELS)
def test_routed_single_and_batch_lanes_equal(ref, evaluators, model):
    jev, tev = evaluators[model]
    prices = [t.price for t in jev.types]
    cfgs = np.random.default_rng(2).integers(0, 6, (10, 3))
    cfgs[0] = 0
    for name, jpol, tpol in _policies(ref, prices):
        t = tev.sim.simulate(cfgs, policy=tpol)
        _equal(t.lat, jev.sim.simulate(cfgs, policy=jpol).lat)
        _equal(tev.sim.qos(cfgs, policy=tpol).rates,
               jev.sim.qos(cfgs, policy=jpol).rates)
        if name != "stacked":
            for cfg in ((3, 2, 1), (0, 0, 0)):
                a, b = (tev.sim.simulate(cfg, policy=tpol),
                        jev.sim.simulate(cfg, policy=jpol))
                _equal(a.lat, b.lat)
                _equal(a.waits, b.waits)


@pytest.mark.parametrize("model", ["mtwnd", "dien", "candle"])
def test_routed_grid_lanes_cold_and_warm_equal(ref, evaluators, model):
    jev, tev = evaluators[model]
    prices = [t.price for t in jev.types]
    cfgs = np.random.default_rng(3).integers(0, 6, (8, 3))
    cfgs[0] = 0
    factors = [0.9, 1.0, 1.5]
    jseg = jev.sim.segment_from(jev.sim.initial_state(), (3, 2, 1))
    tseg = tev.sim.segment_from(tev.sim.initial_state(), (3, 2, 1))
    clock = float(jev.workload.arrivals[800])
    jst = jseg.state_at(800).rebased(clock)
    tst = tseg.state_at(800).rebased(clock)
    for name, jpol, tpol in _policies(ref, prices):
        for warm in (False, True):
            jkw = dict(state=jst, deployed=(3, 2, 1)) if warm else {}
            tkw = dict(state=tst, deployed=(3, 2, 1)) if warm else {}
            _equal(tev.sim.qos(cfgs, workloads=factors, policy=tpol,
                               **tkw).rates,
                   jev.sim.qos(cfgs, workloads=factors, policy=jpol,
                               **jkw).rates)
            _equal(tev.sim.simulate(cfgs, workloads=factors[1:],
                                    policy=tpol, **tkw).lat,
                   jev.sim.simulate(cfgs, workloads=factors[1:],
                                    policy=jpol, **jkw).lat)
            if warm:
                t = tev.sim.simulate(cfgs, policy=tpol, **tkw)
                j = jev.sim.simulate(cfgs, policy=jpol, **jkw)
                _equal(t.lat, j.lat)
                flat = (lambda s: s) if name != "stacked" else (
                    lambda s: [x for row in s for x in row])
                for a, b in zip(flat(t.state), flat(j.state)):
                    _equal(a.free, b.free)
        if name != "stacked":
            tseg_p = tev.sim.segment_from(tst, (2, 2, 2), policy=tpol)
            jseg_p = jev.sim.segment_from(jst, (2, 2, 2), policy=jpol)
            _equal(tseg_p.lat, jseg_p.lat)
            _equal(tseg_p._slots, jseg_p._slots)


def test_routed_states_grid_equal(ref, evaluators):
    jev, tev = evaluators["mtwnd"]
    prices = [t.price for t in jev.types]
    jseg = jev.sim.segment_from(jev.sim.initial_state(), (4, 0, 1))
    tseg = tev.sim.segment_from(tev.sim.initial_state(), (4, 0, 1))
    clock = float(jev.workload.arrivals[700])
    jst, tst = (s.state_at(700).rebased(clock) for s in (jseg, tseg))
    cfgs = np.random.default_rng(4).integers(0, 6, (6, 3))
    for _, jpol, tpol in _policies(ref, prices)[-2:]:
        _equal(tev.sim.qos(cfgs, workloads=[1.0, 1.5], policy=tpol,
                           states=[None, (tst, (4, 0, 1))]).rates,
               jev.sim.qos(cfgs, workloads=[1.0, 1.5], policy=jpol,
                           states=[None, (jst, (4, 0, 1))]).rates)


def test_stacked_policy_refusals_match(ref, evaluators):
    jev, tev = evaluators["dien"]
    prices = [t.price for t in jev.types]
    (_, jpol, tpol), = _policies(ref, prices)[-1:]
    for sim, pol in ((tev.sim, tpol), (jev.sim, jpol)):
        with pytest.raises(ValueError, match="config batch"):
            sim.simulate((1, 1, 1), policy=pol)
        with pytest.raises(ValueError, match="stacked"):
            sim.segment_from(sim.initial_state(), (1, 1, 1), policy=pol)
        with pytest.raises(TypeError):
            sim.qos((1, 1, 1), policy="fcfs")
    for ev, pol in ((tev, tpol), (jev, jpol)):
        with pytest.raises(ValueError, match="single policy"):
            ev((1, 1, 1), policy=pol)


# ------------------------------------- the plain scan's routed arithmetic
def _near_tie_inputs(busy: bool):
    """Routed lanes whose two slot types nearly tie on the routed key, so a
    key rounded in two steps (``a·b`` then ``+ c``) picks another slot than
    the fused multiply-add: idle keys ``pref + affinity·svc`` of 50-600
    (where float32's ulp exceeds the slot-priority tiebreak), 256 lanes x
    300 queries; or, with ``busy``, one query into 4096 two-slot lanes
    whose carries sit ``hedge·(s0 - s1)`` apart, so their busy keys
    ``free + hedge·svc`` nearly tie."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    n_b, nq = (4096, 1) if busy else (256, 300)
    s0 = rng.uniform(0.005, 0.02, nq).astype(f32)
    s1 = rng.uniform(0.005, 0.02, nq).astype(f32)
    svc = np.stack([s0, s1])[None]
    tos = np.tile(np.array([0, 1], np.int32), (n_b, 1))
    if busy:
        arr = np.zeros((1, 1), f32)
        aff = np.zeros(n_b, f32)
        hed = rng.uniform(0.2, 1.0, n_b).astype(f32)
        base = rng.uniform(0.005, 0.02, n_b)
        free0 = np.stack([base, base + hed * (s0[0] - np.float64(s1[0]))],
                         1).astype(f32)
        pref = np.zeros((n_b, 2), f32)
    else:
        q = rng.integers(0, nq, n_b)
        arr = (np.arange(nq) * 0.05).astype(f32)[None]
        aff = rng.uniform(1e4, 3e4, n_b).astype(f32)
        hed = np.zeros(n_b, f32)
        free0 = np.zeros((n_b, 2), f32)
        p1 = (aff.astype(np.float64) * (s0[q].astype(np.float64) - s1[q]))
        pref = np.stack([np.zeros(n_b), p1], 1).astype(f32)
    return arr, svc, tos, np.arange(2, dtype=f32), free0, pref, aff, hed


@pytest.mark.parametrize("busy", [False, True])
def test_plain_routed_keys_are_fused_multiply_adds(ref, busy, monkeypatch):
    import jax.numpy as jnp
    arr, svc, tos, prio, free0, pref, aff, hed = _near_tie_inputs(busy)
    qos_t = 0.02
    targs = [torch.from_numpy(x) for x in (arr, svc, tos, prio, free0)]
    policy = tuple(torch.from_numpy(x) for x in (pref, aff, hed))

    def plain():
        return tref.fcfs_scan_ref(*targs, qos_t, tfcfs.BIG, policy=policy,
                                  want_lat=True, want_slot=True)

    jfree, (jlat, jstart, jslot) = ref["sim"]._scan_policy_grid(
        *(jnp.asarray(x) for x in (arr, svc[0], tos, prio, free0, pref,
                                   aff, hed)))
    counts, lat, _, free, slot, _ = plain()
    _equal(slot.numpy(), np.asarray(jslot))
    _equal(lat.numpy(), np.asarray(jlat))
    _equal(free.numpy(), np.asarray(jfree))
    monkeypatch.setattr(tref, "fma32", lambda a, b, c: a * b + c)
    two_step = plain()
    assert (two_step[4].numpy() != np.asarray(jslot)).any()


def test_fma32_rounds_once():
    rng = np.random.default_rng(12)
    f32 = np.float32
    a, b, c = (rng.uniform(-3, 3, 400000).astype(f32) for _ in range(3))
    got = tref.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    from fractions import Fraction
    for i in range(0, 400000, 4001):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, f32(-np.inf)), lo,
                 np.nextafter(lo, f32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(v.view(np.int32)) & 1))
        assert got[i] == best
    # the double-rounding case: 4097² + 2^-30 = 16785409 + 2^-30 rounds in
    # float64 to the float32 tie 16785409, which rounds to even (16785408);
    # the fused result is 16785410
    x = torch.tensor([4097.0], dtype=torch.float32)
    z = torch.tensor([2.0 ** -30], dtype=torch.float32)
    assert float((x.double() * x.double() + z.double()).float()) == 16785408
    assert tref.fma32(x, x, z).item() == 16785410.0
    assert tref.fma32(-x, x, -z).item() == -16785410.0
    assert tref.fma32(x, x, -z).item() == 16785408.0


def _argmin_case(case):
    """One routed step's operands: 1 query, 6 slots of 2 types."""
    f32 = np.float32
    arr = np.full((1, 1), 1.0, f32)
    svc = np.array([[[0.01], [0.02]]], f32)
    tos = np.array([[0, 1, 0, 1, 0, 1]], np.int32)
    pref = np.zeros((1, 6), f32)
    aff, hed = np.zeros(1, f32), np.zeros(1, f32)
    free0 = {"all idle": [0.5, 0.2, 0.9, 0.1, 0.3, 0.4],
             "none idle": [1.5, 1.2, 1.9, 1.1, 1.3, 1.4],
             "one idle": [1.5, 1.2, 0.9, 1.1, 1.3, 1.4],
             "equal keys": [1.1, 1.1, 1.1, 1.1, 1.1, 1.1],
             "absent": [1e30, 1e30, 1.9, 1e30, 1.3, 1e30],
             "all absent": [1e30] * 6,
             "hedge 1": [1.5, 1.49, 1.9, 1.485, 1.3, 1.4]}[case]
    if case == "hedge 1":
        hed[:] = 1.0
    if case in ("all idle", "one idle"):
        pref[0] = [1.0, 0.0, 1.0, 0.0, 2.0, 0.0]
        aff[:] = 10.0
    return (arr, svc, tos, np.arange(6, dtype=f32),
            np.asarray([free0], f32), pref, aff, hed)


@pytest.mark.parametrize("case", ["all idle", "none idle", "one idle",
                                  "equal keys", "absent", "all absent",
                                  "hedge 1"])
def test_plain_two_stage_argmin_matches_reference(ref, case):
    import jax.numpy as jnp
    ops_ = _argmin_case(case)
    arr, svc, tos, prio, free0, pref, aff, hed = ops_
    t = tref.fcfs_scan_ref(*(torch.from_numpy(x) for x in ops_[:5]), 0.02,
                           tfcfs.BIG, policy=tuple(torch.from_numpy(x)
                                                   for x in ops_[5:]),
                           want_lat=True, want_slot=True)
    jfree, (jlat, _, jslot) = ref["sim"]._scan_policy_grid(
        *(jnp.asarray(x) for x in (arr, svc[0], tos, prio, free0, pref, aff,
                                   hed)))
    _equal(t[4].numpy(), np.asarray(jslot))
    _equal(t[1].numpy(), np.asarray(jlat))
    _equal(t[3].numpy(), np.asarray(jfree))


# ------------------------------------------------------ evaluator memos
def test_evaluator_policy_memos_equal(ref, evaluators):
    jev, tev = evaluators["candle"]
    jev2, _ = ref["pool"].make_paper_setup("candle", n_queries=N_QUERIES)[:2]
    tev2 = tpool.PoolEvaluator(tev.model, tev.types, tev.workload,
                               device=CPU)
    prices = [t.price for t in jev.types]
    cfgs = [(3, 2, 1), (1, 1, 1), (3, 2, 1), (0, 4, 4)]
    for _, jpol, tpol in _policies(ref, prices)[:-1]:
        _equal(tev2.batch(cfgs, policy=tpol), jev2.batch(cfgs, policy=jpol))
        assert tev2(cfgs[1], policy=tpol) == jev2(cfgs[1], policy=jpol)
        _equal(tev2.grid(cfgs, [1.0, 1.3], policy=tpol),
               jev2.grid(cfgs, [1.0, 1.3], policy=jpol))
        assert tpool.best_homogeneous(tev2, 1, prices, 0.99, policy=tpol) == \
            ref["pool"].best_homogeneous(jev2, 1, prices, 0.99, policy=jpol)
        assert tev2.n_evals == jev2.n_evals
    assert set(tev2._policy_caches) == set(jev2._policy_caches)
    for k in jev2._policy_caches:
        assert tev2._policy_caches[k] == jev2._policy_caches[k]
    assert tev2._cache == {} and jev2._cache == {}
