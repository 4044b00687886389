"""Port parity: RIBBON's core (search space, trace, objective, pruning, GP,
acquisition, optimizer) in PyTorch against ``repro.core``.

Inputs come from numpy seeds.  Tolerances:
* search space, trace, objective and prune rules: bit-equal (the same
  float32 elementwise operations, or numpy copies);
* ``gp_posterior``: 1e-5 in the mean, 1e-4 in the std (float32 Cholesky
  and triangular solves in another order; std is a square root near 0);
* acquisition and the optimizer: the same picks and the same sequence of
  evaluated configurations.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import acquisition as jacq  # noqa: E402
from repro.core import gp as jgp  # noqa: E402
from repro.core import objective as jobj  # noqa: E402
from repro.core import pruning as jpr  # noqa: E402
from repro.core import ribbon as jrib  # noqa: E402
from repro.core import search_space as jss  # noqa: E402
from repro.core import trace as jtr  # noqa: E402
from repro_torch.core import acquisition as tacq  # noqa: E402
from repro_torch.core import gp as tgp  # noqa: E402
from repro_torch.core import objective as tobj  # noqa: E402
from repro_torch.core import pruning as tpr  # noqa: E402
from repro_torch.core import ribbon as trib  # noqa: E402
from repro_torch.core import search_space as tss  # noqa: E402
from repro_torch.core import trace as ttr  # noqa: E402

CPU = "cpu"
BOUNDS = [(4, 3, 3), (5, 4, 4), (6, 8), (2, 3, 1, 2)]


def _prices(n, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(float(p) for p in np.round(rng.uniform(0.5, 10.0, n), 3))


def _spaces(bounds):
    prices = _prices(len(bounds))
    return jss.SearchSpace(bounds, prices), tss.SearchSpace(bounds, prices)


def monotone_oracle(caps, demand):
    """QoS rate = min(1, capacity / demand): monotone in every dimension."""
    caps = np.asarray(caps, dtype=np.float64)

    def f(config):
        return min(1.0, float(caps @ np.asarray(config, dtype=np.float64))
                   / demand)
    return f


# ------------------------------------------------------------ numpy copies
@pytest.mark.parametrize("bounds", BOUNDS)
def test_search_space_equal(bounds):
    js, ts = _spaces(bounds)
    lat = js.enumerate()
    np.testing.assert_array_equal(ts.enumerate(), lat)
    np.testing.assert_array_equal(ts.costs(lat), js.costs(lat))
    np.testing.assert_array_equal(ts.normalize(lat), js.normalize(lat))
    assert ts.size == js.size and ts.max_cost == js.max_cost
    assert [ts.index_of(c) for c in lat] == [js.index_of(c) for c in lat]


def test_trace_equal():
    rng = np.random.default_rng(4)
    jt, tt = jtr.SearchTrace(), ttr.SearchTrace()
    for _ in range(30):
        cfg = tuple(rng.integers(0, 5, 3))
        rate, cost = float(rng.uniform()), float(rng.uniform(1, 20))
        feas, est = rate >= 0.5, bool(rng.uniform() < 0.2)
        jt.record(cfg, rate, cost, feas, est)
        tt.record(cfg, rate, cost, feas, est)
    assert [vars(e) for e in tt.evaluations] == [vars(e) for e in jt.evaluations]
    assert vars(tt.best_feasible()) == vars(jt.best_feasible())
    np.testing.assert_array_equal(tt.best_cost_curve(), jt.best_cost_curve())
    assert (tt.n_samples, tt.n_violations, tt.exploration_cost) == (
        jt.n_samples, jt.n_violations, jt.exploration_cost)
    assert tt.samples_to_reach_cost(5.0) == jt.samples_to_reach_cost(5.0)


# --------------------------------------------------------- objective, rules
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_objective_batch_bit_equal(seed):
    rng = np.random.default_rng(seed)
    rates = rng.uniform(size=257).astype(np.float32)
    rates[::7] = 0.99
    costs = rng.uniform(0, 50, size=257).astype(np.float32)
    want = np.asarray(jobj.ribbon_objective_batch(
        jnp.asarray(rates), jnp.asarray(costs), 0.99, 50.0))
    got = tobj.ribbon_objective_batch(torch.from_numpy(rates),
                                      torch.from_numpy(costs), 0.99, 50.0)
    np.testing.assert_array_equal(got.numpy(), want)
    for r, c in zip(rates[:20], costs[:20]):
        assert tobj.ribbon_objective(float(r), float(c), 0.99, 50.0) == \
            jobj.ribbon_objective(float(r), float(c), 0.99, 50.0)


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prune_rules_bit_equal(seed, joint):
    rng = np.random.default_rng(seed)
    js, ts = _spaces((5, 4, 4))
    lat = js.enumerate().astype(np.float32)
    costs = js.costs(js.enumerate()).astype(np.float32)
    jfn = jpr.apply_prune_rules_joint if joint else jpr.apply_prune_rules
    tfn = tpr.apply_prune_rules_joint if joint else tpr.apply_prune_rules
    for _ in range(8):
        blocked = rng.uniform(size=len(lat)) < 0.2
        idx = int(rng.integers(len(lat)))
        config = lat[idx]
        cut = np.float32(costs[rng.integers(len(lat))]
                         if rng.uniform() < 0.7 else np.inf)
        down, cost = bool(rng.uniform() < 0.5), bool(rng.uniform() < 0.5)
        want = np.asarray(jfn(jnp.asarray(blocked), jnp.asarray(lat),
                              jnp.asarray(costs), jnp.int32(idx),
                              jnp.asarray(config), jnp.float32(cut),
                              down, cost))
        got = tfn(torch.from_numpy(blocked), torch.from_numpy(lat),
                  torch.from_numpy(costs), idx, torch.from_numpy(config),
                  torch.tensor(cut), down, cost)
        np.testing.assert_array_equal(got.numpy(), want)


def test_prune_set_copy_equal():
    js, ts = _spaces((5, 4, 4))
    jp, tp = jpr.PruneSet(js), tpr.PruneSet(ts)
    assert tp.prune_down_set((2, 1, 3)) == jp.prune_down_set((2, 1, 3))
    assert tp.prune_cost_at_least(20.0) == jp.prune_cost_at_least(20.0)
    np.testing.assert_array_equal(tp.mask, jp.mask)


# -------------------------------------------------------------------- GP
def _gp_inputs(seed, n_obs, bounds=(5, 4, 4), max_obs=48):
    rng = np.random.default_rng(seed)
    lat = jss.SearchSpace(bounds, _prices(len(bounds))).enumerate().astype(
        np.float32)
    x = np.zeros((max_obs, len(bounds)), np.float32)
    y = np.zeros(max_obs, np.float32)
    m = np.zeros(max_obs, np.float32)
    pick = rng.choice(len(lat), n_obs, replace=False)
    x[:n_obs] = lat[pick]
    y[:n_obs] = rng.uniform(0.1, 0.9, n_obs)
    m[:n_obs] = 1.0
    denom = np.maximum(np.asarray(bounds, np.float32), 1.0)
    return x, y, m, lat, denom


@pytest.mark.parametrize("n_obs", [1, 5, 20, 40])
def test_gp_posterior_within_tolerance(n_obs):
    x, y, m, lat, denom = _gp_inputs(n_obs, n_obs)
    jm, js = jgp.gp_posterior(*(jnp.asarray(a) for a in (x, y, m, lat, denom)))
    tm, ts = tgp.gp_posterior(*(torch.from_numpy(a) for a in (x, y, m, lat,
                                                               denom)))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-4)


def test_fit_predict_single_lengthscale():
    x, y, m, lat, denom = _gp_inputs(9, 12)
    args = (0.35, np.float32(0.04), np.float32(5e-6))
    jmean, jvar, jlml = jgp._fit_predict(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), jnp.asarray(lat),
        *args, jnp.asarray(denom))
    tmean, tvar, tlml = tgp._fit_predict(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m),
        torch.from_numpy(lat), torch.tensor([args[0]]),
        torch.tensor(args[1]), torch.tensor(args[2]), torch.from_numpy(denom))
    np.testing.assert_allclose(tmean[0].numpy(), np.asarray(jmean), atol=1e-5)
    np.testing.assert_allclose(tvar[0].numpy(), np.asarray(jvar), atol=1e-5)
    np.testing.assert_allclose(tlml[0].item(), float(jlml), rtol=1e-4)


def test_matern_kernels_match():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 4, (7, 3)).astype(np.float32)
    b = rng.uniform(0, 4, (5, 3)).astype(np.float32)
    denom = np.array([4.0, 3.0, 3.0], np.float32)
    np.testing.assert_allclose(
        tgp.rounded_matern52(torch.from_numpy(a), torch.from_numpy(b), 0.35,
                             1.5, torch.from_numpy(denom)).numpy(),
        np.asarray(jgp.rounded_matern52(jnp.asarray(a), jnp.asarray(b), 0.35,
                                        1.5, jnp.asarray(denom))),
        rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ acquisition
@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_select_batch_same_picks(q, seed):
    x, y, m, lat, denom = _gp_inputs(seed + 20, 10)
    rng = np.random.default_rng(seed)
    blocked = rng.uniform(size=len(lat)) < 0.3
    weights = np.ones(len(lat), np.float32)
    best_y = float(y.max())
    jp, jsc, jb = jacq.select_batch(
        *(jnp.asarray(a) for a in (x, y, m, lat, denom)), best_y,
        jnp.asarray(blocked), jnp.asarray(weights), q)
    tp, tsc, tb = tacq.select_batch(
        *(torch.from_numpy(a) for a in (x, y, m, lat, denom)), best_y,
        torch.from_numpy(blocked), torch.from_numpy(weights), q)
    assert tp.tolist() == np.asarray(jp).tolist()
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-4,
                               atol=1e-6)


def test_expected_improvement_matches():
    rng = np.random.default_rng(6)
    mean = rng.uniform(0, 1, 100).astype(np.float32)
    std = rng.uniform(0, 0.3, 100).astype(np.float32)
    np.testing.assert_allclose(
        tacq.expected_improvement(torch.from_numpy(mean),
                                  torch.from_numpy(std), 0.6).numpy(),
        np.asarray(jacq.expected_improvement(jnp.asarray(mean),
                                             jnp.asarray(std), 0.6)),
        rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------- optimizer
def _seq(trace):
    return [(e.config, e.qos_rate, e.cost, e.feasible, e.estimated)
            for e in trace.evaluations]


@pytest.mark.parametrize("batch_q", [1, 4])
@pytest.mark.parametrize("caps,demand,target", [
    ((3.0, 5.0, 11.0), 40.0, 0.99),
    ((2.5, 7.0, 9.5), 33.0, 0.95),
])
def test_run_ribbon_same_sequence(caps, demand, target, batch_q):
    js, ts = _spaces((5, 4, 4))
    oracle = monotone_oracle(caps, demand)
    jt = jrib.run_ribbon(js, oracle, qos_target=target, budget=60,
                         batch_q=batch_q)
    tt = trib.run_ribbon(ts, oracle, qos_target=target, budget=60,
                         batch_q=batch_q, device=CPU)
    assert _seq(tt) == _seq(jt)
    assert vars(tt.best_feasible()) == vars(jt.best_feasible())


def test_optimizer_state_and_restarts_match():
    js, ts = _spaces((5, 4, 4))
    oracle = monotone_oracle((3.0, 5.0, 11.0), 40.0)
    jo = jrib.RibbonOptimizer(js, qos_target=0.99)
    to = trib.RibbonOptimizer(ts, qos_target=0.99, device=CPU)
    for _ in range(10):
        cj, ct = jo.ask(), to.ask()
        assert ct == cj
        jo.tell(cj, oracle(cj))
        to.tell(ct, oracle(ct))
    np.testing.assert_array_equal(to._blocked_dev.numpy(),
                                  np.asarray(jo._blocked_dev))
    np.testing.assert_array_equal(to._blocked_dev.numpy(),
                                  to.sampled | to.prune.mask)
    # checkpoint round trip
    restored = trib.RibbonOptimizer(ts, qos_target=0.99, device=CPU)
    restored.load_state_dict(to.state_dict())
    assert restored.ask() == to.ask() == jo.ask()
    # load change: warm restart from the new QoS of the old optimum
    jo.warm_restart(0.9)
    to.warm_restart(0.9)
    assert _seq(to.trace) == _seq(jo.trace)
    assert to.ask_batch(3) == jo.ask_batch(3)
    # history replay into a reduced space
    js2 = jss.SearchSpace((3, 4, 4), js.prices)
    ts2 = tss.SearchSpace((3, 4, 4), ts.prices)
    jr = jrib.RibbonOptimizer(js2, qos_target=0.99)
    tr = trib.RibbonOptimizer(ts2, qos_target=0.99, device=CPU)
    assert tr.replay_from(to) == jr.replay_from(jo)
    assert _seq(tr.trace) == _seq(jr.trace)
    assert tr.ask() == jr.ask()


def test_cost_aware_and_penalties_match():
    js, ts = _spaces((4, 3, 3))
    oracle = monotone_oracle((3.0, 5.0, 11.0), 30.0)
    kw = dict(qos_target=0.99, cost_aware=True, cost_penalties=(0.5, 0.0, 1.0))
    jo, to = jrib.RibbonOptimizer(js, **kw), trib.RibbonOptimizer(
        ts, device=CPU, **kw)
    for _ in range(12):
        cj, ct = jo.ask(), to.ask()
        assert ct == cj
        if cj is None:
            break
        jo.tell(cj, oracle(cj))
        to.tell(ct, oracle(ct))
    assert _seq(to.trace) == _seq(jo.trace)


@pytest.mark.parametrize("cost_aware", [False, True])
def test_select_next_matches(cost_aware):
    rng = np.random.default_rng(12)
    mean = rng.uniform(0, 1, 80).astype(np.float32)
    std = rng.uniform(0, 0.3, 80).astype(np.float32)
    sampled = rng.uniform(size=80) < 0.3
    pruned = rng.uniform(size=80) < 0.2
    costs = rng.uniform(1, 30, 80).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (mean, std)] + [0.7] + [
        jnp.asarray(a) for a in (sampled, pruned)]
    targs = [torch.from_numpy(a) for a in (mean, std)] + [0.7] + [
        torch.from_numpy(a) for a in (sampled, pruned)]
    if cost_aware:
        ji, jv = jacq.select_next_cost_aware(*jargs, jnp.asarray(costs))
        ti, tv = tacq.select_next_cost_aware(*targs, torch.from_numpy(costs))
    else:
        ji, jv = jacq.select_next(*jargs)
        ti, tv = tacq.select_next(*targs)
    assert int(ti) == int(ji)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-7)


def test_gaussian_process_predict_matches():
    js, _ = _spaces((5, 4, 4))
    jg = jgp.GaussianProcess(3, (5, 4, 4), max_obs=16)
    tg = tgp.GaussianProcess(3, (5, 4, 4), max_obs=16, device=CPU)
    rng = np.random.default_rng(8)
    for cfg in js.enumerate()[rng.choice(js.size, 9, replace=False)]:
        y = float(rng.uniform())
        jg.add(cfg, y)
        tg.add(cfg, y)
    query = js.enumerate()[:30]
    jm, jsd = jg.predict(query)
    tm, tsd = tg.predict(query)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsd.numpy(), np.asarray(jsd), rtol=0, atol=1e-4)
    restored = tgp.GaussianProcess(3, (5, 4, 4), max_obs=16, device=CPU)
    restored.load_state_dict(tg.state_dict())
    assert torch.equal(restored.predict(query)[0], tm)


def test_ask_with_a_full_observation_buffer_matches():
    """With every GP row used, ``ask`` still answers (the constant liar
    writes no row for the last pick) and the next ``tell`` refuses."""
    js, ts = _spaces((4, 3, 3))
    oracle = monotone_oracle((3.0, 5.0, 11.0), 30.0)
    jo = jrib.RibbonOptimizer(js, qos_target=0.99, max_obs=5)
    to = trib.RibbonOptimizer(ts, qos_target=0.99, max_obs=5, device=CPU)
    for _ in range(5):
        cj, ct = jo.ask(), to.ask()
        assert ct == cj
        jo.tell(cj, oracle(cj))
        to.tell(ct, oracle(ct))
    assert to.ask() == jo.ask()
    with pytest.raises(RuntimeError, match="buffer full"):
        to.tell(to.ask(), 0.5)
