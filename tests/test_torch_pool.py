"""Port parity: RIBBON's search path over the simulator
(``repro_torch.serving.pool`` and ``repro_torch.core.baselines``) against
``repro.serving.pool`` and ``repro.core.baselines``.

* ``PoolEvaluator`` (call, batch, grid, exhaustive) and
  ``best_homogeneous`` on the reference's own streams: the same rates bit
  for bit and the same ``n_evals``.
* The mtwnd anchor, ``make_paper_setup("mtwnd", seed=0, n_queries=1500)``
  then ``run_ribbon(budget=80, start=(5, 0, 0))``: the same evaluated
  configs in the same order and the same best pool, (1) with the
  reference's workload handed across, rates bit for bit, and (2) from the
  seed alone through the port's own threefry stream.  In case (2) the
  arrivals differ from the reference's by float32 roundings
  (``tests/test_torch_prng.py``); measured on this host, no rate of the 38
  evaluations moved, and the test pins that.
* The baselines (RANDOM, HILL-CLIMB, RSM, the exact bucketed solver) on
  one oracle and seed: the same traces and solutions.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import run_ribbon  # noqa: E402
from repro_torch.core import search_space as tss  # noqa: E402
from repro_torch.serving import instance as tinst  # noqa: E402
from repro_torch.serving import pool as tpool  # noqa: E402
from repro_torch.serving import routing as troute  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

CPU = "cpu"
MODELS = ["mtwnd", "dien", "candle", "resnet50", "vgg19"]
ANCHOR = dict(qos_target=0.99, budget=80, start=(5, 0, 0))


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving.pool`` and ``repro.core``, imported
    with the ``enable_x64`` alias ``repro.serving`` needs on jax 0.9, as in
    ``tests/test_torch_engine.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import pool
    import repro.core as core
    from repro.core import baselines
    return {"pool": pool, "core": core, "base": baselines}


def _port_evaluator(jev):
    """The port's evaluator on the reference evaluator's arrays."""
    w = jev.workload
    tw = twl.Workload(arrivals=w.arrivals, batches=w.batches,
                      rate_qps=w.rate_qps)
    types = [tinst.AWS_INSTANCES[t.name] for t in jev.types]
    return tpool.PoolEvaluator(tinst.MODEL_PROFILES[jev.model.name], types,
                               tw, device=CPU)


@pytest.fixture(scope="module")
def mtwnd(ref):
    """(reference evaluator, port evaluator on its arrays, space)."""
    jev, jspace, _ = ref["pool"].make_paper_setup("mtwnd", n_queries=1500)
    return jev, _port_evaluator(jev), tss.SearchSpace(jspace.bounds,
                                                      jspace.prices)


@pytest.fixture(scope="module")
def lattice_rates(mtwnd):
    """Every mtwnd config's QoS rate (the port's exhaustive sweep), as an
    oracle both packages' baselines can share."""
    _, tev, space = mtwnd
    lattice = space.enumerate()
    rates = tev.batch(lattice)
    table = {tuple(int(v) for v in c): float(r)
             for c, r in zip(lattice, rates)}
    return lambda config: table[tuple(int(v) for v in config)]


def test_tables_and_specs_equal(ref):
    jp = ref["pool"]
    assert tpool.DEFAULT_RATES == jp.DEFAULT_RATES
    assert tpool.DEFAULT_BOUNDS == jp.DEFAULT_BOUNDS
    assert tpool.BUCKET_DIST_MIXES == jp.BUCKET_DIST_MIXES
    assert tpool.cost_effectiveness(120.0, 0.5) == \
        jp.cost_effectiveness(120.0, 0.5)
    for model in MODELS:
        for dist in ("lognormal", "gaussian"):
            assert vars(tpool.paper_spec(model, 3, batch_dist=dist)) == \
                vars(jp.paper_spec(model, 3, batch_dist=dist))
        t = tpool.paper_bucketed_spec(model, "bucketed-large")
        j = jp.paper_bucketed_spec(model, "bucketed-large")
        assert vars(t.base) == vars(j.base)
        assert (t.rates, t.input_scales, t.output_scales) == \
            (j.rates, j.input_scales, j.output_scales)


def test_evaluator_call_batch_grid_match(mtwnd):
    jev, _, _ = mtwnd
    tev = _port_evaluator(jev)   # a fresh memo: n_evals counted from 0
    jev = type(jev)(jev.model, jev.types, jev.workload)
    rng = np.random.default_rng(0)
    cfgs = np.stack([rng.integers(0, b + 1, 20) for b in (8, 10, 12)], 1)
    cfgs[3] = cfgs[5]              # a duplicate
    for ev in (jev, tev):
        ev((2, 1, 1))
    assert tev((2, 1, 1)) == jev((2, 1, 1))
    np.testing.assert_array_equal(tev.batch(cfgs), jev.batch(cfgs))
    factors = [1.0, 1.25, 0.75, 1.25]
    np.testing.assert_array_equal(tev.grid(cfgs[:8], factors),
                                  jev.grid(cfgs[:8], factors))
    np.testing.assert_array_equal(tev.grid(cfgs[4:12], [1.25, 2.0]),
                                  jev.grid(cfgs[4:12], [1.25, 2.0]))
    assert tev.n_evals == jev.n_evals
    assert tev((2, 1, 1)) == jev((2, 1, 1)) and tev.n_evals == jev.n_evals


@pytest.mark.parametrize("model", MODELS)
def test_best_homogeneous_matches(ref, model):
    jev, jspace, _ = ref["pool"].make_paper_setup(model, n_queries=1500)
    tev = _port_evaluator(jev)
    for t in range(3):
        assert tpool.best_homogeneous(tev, t, jspace.prices, 0.99) == \
            ref["pool"].best_homogeneous(jev, t, jspace.prices, 0.99)
    assert tev.n_evals == jev.n_evals


@pytest.mark.parametrize("load_factor", [1.0, 1.2])
def test_exhaustive_matches(ref, mtwnd, load_factor):
    jev, _, space = mtwnd
    tev = _port_evaluator(jev)
    jev = type(jev)(jev.model, jev.types, jev.workload)
    assert tev.exhaustive(space, 0.99, load_factor) == \
        jev.exhaustive(ref["core"].SearchSpace(space.bounds, space.prices),
                       0.99, load_factor)
    assert tev.n_evals == jev.n_evals == space.size


def _anchor(run, space, ev, **kw):
    trace = run(space, ev, ANCHOR["qos_target"], budget=ANCHOR["budget"],
                start=ANCHOR["start"], evaluate_qos_batch=ev.batch, **kw)
    return ([(e.config, e.qos_rate, e.cost, e.feasible)
             for e in trace.evaluations], trace.best_feasible())


@pytest.fixture(scope="module")
def reference_anchor(ref):
    jev, jspace, _ = ref["pool"].make_paper_setup("mtwnd", seed=0,
                                                  n_queries=1500)
    evals, best = _anchor(ref["core"].run_ribbon, jspace, jev)
    return jev, evals, best


def test_anchor_on_the_reference_stream(reference_anchor):
    jev, jevals, jbest = reference_anchor
    tev = _port_evaluator(jev)
    space = tss.SearchSpace(tpool.DEFAULT_BOUNDS["mtwnd"],
                            tuple(t.price for t in tev.types))
    evals, best = _anchor(run_ribbon, space, tev, device=CPU)
    assert evals == jevals
    assert vars(best) == vars(jbest)
    assert best.config == (4, 0, 1) and tev.n_evals == jev.n_evals


def test_anchor_from_the_seed_alone(reference_anchor):
    """The port's own stream (threefry in torch) from seed 0: the same
    configs in the same order, the same rates (measured: all 38 equal) and
    the same best pool as the reference from the same seed."""
    _, jevals, jbest = reference_anchor
    tev, space, profile = tpool.make_paper_setup("mtwnd", seed=0,
                                                 n_queries=1500, device=CPU)
    assert profile is tinst.MODEL_PROFILES["mtwnd"]
    evals, best = _anchor(run_ribbon, space, tev, device=CPU)
    assert [e[0] for e in evals] == [e[0] for e in jevals]
    assert evals == jevals and len(evals) == 38
    assert vars(best) == vars(jbest)


def test_central_composite_design_equal(ref):
    for bounds in ((8, 10, 12), (3, 4), (2, 2, 2, 5)):
        assert tbase.central_composite_design(bounds) == \
            ref["base"].central_composite_design(bounds)


def _traces_equal(t, j):
    assert [vars(e) for e in t.evaluations] == [vars(e) for e in j.evaluations]


@pytest.mark.parametrize("seed", [0, 3])
def test_random_and_hill_climb_match(ref, mtwnd, lattice_rates, seed):
    _, _, space = mtwnd
    jspace = ref["core"].SearchSpace(space.bounds, space.prices)
    _traces_equal(tbase.run_random(space, lattice_rates, 0.99, budget=40,
                                   seed=seed),
                  ref["base"].run_random(jspace, lattice_rates, 0.99,
                                         budget=40, seed=seed))
    _traces_equal(tbase.run_hill_climb(space, lattice_rates, 0.99, budget=40,
                                       start=(2, 2, 2), seed=seed),
                  ref["base"].run_hill_climb(jspace, lattice_rates, 0.99,
                                             budget=40, start=(2, 2, 2),
                                             seed=seed))


def test_rsm_matches(ref, mtwnd, lattice_rates):
    _, _, space = mtwnd
    jspace = ref["core"].SearchSpace(space.bounds, space.prices)
    _traces_equal(tbase.run_rsm(space, lattice_rates, 0.99, budget=60),
                  ref["base"].run_rsm(jspace, lattice_rates, 0.99, budget=60))


@pytest.mark.parametrize("method", ["milp", "enumerate", "auto"])
def test_solve_bucketed_matches(ref, method):
    w = tpool.paper_workload("dien", n_queries=1500,
                             batch_dist="bucketed-small")
    types = [tinst.AWS_INSTANCES[n] for n in tinst.PAPER_POOLS["dien"][
        "diverse"]]
    tputs = tinst.measured_throughputs(tinst.MODEL_PROFILES["dien"], types, w)
    rates = [b.rate for b in w.buckets]
    prices = [t.price for t in types]
    for kw in (dict(), dict(slice_factor=2, utilization=0.8)):
        got = tbase.solve_bucketed(rates, tputs, prices, method=method, **kw)
        want = ref["base"].solve_bucketed(rates, tputs, prices, method=method,
                                          **kw)
        assert vars(got) == vars(want)


def test_solve_bucketed_refusals_match(ref):
    for kw in (dict(slice_factor=0), dict(utilization=1.5),
               dict(method="greedy"), dict(bounds=(1,))):
        for mod in (tbase, ref["base"]):
            with pytest.raises(ValueError):
                mod.solve_bucketed([1.0, 2.0], [[3.0, 4.0], [5.0, 6.0]],
                                   [1.0, 2.0], **kw)


def test_unported_options_name_their_item(mtwnd):
    """The ``policy=`` option (A-8) and ``grid_from`` (A-7), refused before
    they were ported, now run: under the identity policy every entry point
    gives the rates of ``policy=None`` (from the identity policy's own
    memo), and ``grid_from`` from the idle carry gives the cold grid's."""
    _, tev, space = mtwnd
    fcfs = troute.RoutingPolicy.fcfs(3)
    for call in (lambda **kw: tev((1, 1, 1), **kw),
                 lambda **kw: tev.batch([(1, 1, 1)], **kw),
                 lambda **kw: tev.grid([(1, 1, 1)], [1.0, 1.2], **kw),
                 lambda **kw: tev.exhaustive(space, 0.99, **kw),
                 lambda **kw: tpool.best_homogeneous(tev, 0, space.prices,
                                                     0.99, **kw)):
        assert repr(call(policy=fcfs)) == repr(call())
    assert fcfs.key() in tev._policy_caches
    idle = tev.sim.initial_state()
    np.testing.assert_array_equal(tev.grid_from(idle, [(1, 1, 1)], [1.0]),
                                  tev.grid([(1, 1, 1)], [1.0]))
