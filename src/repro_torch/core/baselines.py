"""Competing search strategies from paper §5.3: RANDOM, HILL-CLIMB, RSM —
plus the Mélange-style *exact* minimum-cost solver over request-size buckets
(``solve_bucketed``), the ground-truth baseline BO is benchmarked against.

Each black-box strategy is given the same QoS oracle and produces the same
SearchTrace, so Figs. 10/13/14 comparisons are computed uniformly.

A numpy and scipy copy of ``repro/core/baselines.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np

from .search_space import SearchSpace, upper_bounds_from_throughput
from .trace import SearchTrace


def _dominates_down(v, x) -> bool:
    """True if x <= v componentwise (x lies in the down-set of v)."""
    return all(xi <= vi for xi, vi in zip(x, v))


class _Bookkeeping:
    """Shared skip rules (made explicit for RANDOM in the paper, and sound for
    all strategies): a config in the down-set of a known violator cannot meet
    QoS; a config componentwise >= a known feasible config cannot be cheaper."""

    def __init__(self, space: SearchSpace):
        self.space = space
        self.violators: list[tuple[int, ...]] = []
        self.feasibles: list[tuple[int, ...]] = []
        self.visited: set[tuple[int, ...]] = set()

    def skip(self, x) -> bool:
        x = tuple(x)
        if x in self.visited:
            return True
        if any(_dominates_down(v, x) for v in self.violators):
            return True
        if any(_dominates_down(x, f) for f in self.feasibles):
            # x >= some feasible f componentwise → x at least as expensive.
            return True
        return False

    def update(self, x, feasible: bool) -> None:
        x = tuple(x)
        self.visited.add(x)
        (self.feasibles if feasible else self.violators).append(x)


def _evaluate(space, evaluate_qos, qos_target, config, trace, book) -> bool:
    rate = float(evaluate_qos(config))
    cost = float(space.costs(np.asarray(config)[None, :])[0])
    feasible = rate >= qos_target
    trace.record(config, rate, cost, feasible)
    book.update(config, feasible)
    return feasible


def run_random(space: SearchSpace, evaluate_qos, qos_target: float = 0.99,
               budget: int = 200, seed: int = 0) -> SearchTrace:
    """RANDOM with the paper's intelligence: skip configs ruled out by
    dominance over previous observations."""
    rng = np.random.default_rng(seed)
    lattice = space.enumerate()
    order = rng.permutation(len(lattice))
    trace, book = SearchTrace(), _Bookkeeping(space)
    for idx in order:
        if trace.n_samples >= budget:
            break
        config = tuple(int(v) for v in lattice[idx])
        if book.skip(config):
            continue
        _evaluate(space, evaluate_qos, qos_target, config, trace, book)
    return trace


def _neighbors(config, bounds):
    for dim in range(len(config)):
        for step in (+1, -1):
            v = config[dim] + step
            if 0 <= v <= bounds[dim]:
                yield tuple(config[:dim]) + (v,) + tuple(config[dim + 1:])


def run_hill_climb(space: SearchSpace, evaluate_qos, qos_target: float = 0.99,
                   budget: int = 200, start=None, seed: int = 0) -> SearchTrace:
    """HILL-CLIMB (paper §5.3): steepest-ascent on the (feasibility, cost/QoS)
    ordering over ±1 neighbor moves, with random restarts when stuck
    (paper Fig. 12 shows exactly this restart behavior)."""
    rng = np.random.default_rng(seed)
    bounds = space.bounds
    trace, book = SearchTrace(), _Bookkeeping(space)

    def score(rate, cost):
        # Feasible configs rank above violating ones; within feasible prefer
        # cheap, within violating prefer higher QoS rate.
        if rate >= qos_target:
            return (1, -cost)
        return (0, rate)

    current = tuple(space.bounds) if start is None else tuple(int(v) for v in start)
    rate = float(evaluate_qos(current))
    cost = float(space.costs(np.asarray(current)[None, :])[0])
    trace.record(current, rate, cost, rate >= qos_target)
    book.update(current, rate >= qos_target)
    current_score = score(rate, cost)

    lattice = space.enumerate()
    while trace.n_samples < budget:
        best_move, best_score = None, current_score
        progressed = False
        for nb in _neighbors(current, bounds):
            if trace.n_samples >= budget:
                break
            if book.skip(nb):
                continue
            nrate = float(evaluate_qos(nb))
            ncost = float(space.costs(np.asarray(nb)[None, :])[0])
            trace.record(nb, nrate, ncost, nrate >= qos_target)
            book.update(nb, nrate >= qos_target)
            s = score(nrate, ncost)
            if s > best_score:
                best_move, best_score = nb, s
        if best_move is not None:
            current, current_score = best_move, best_score
            progressed = True
        if not progressed:
            # Stuck at a local optimum → random restart (dark-orange square in
            # paper Fig. 12).
            unvisited = [tuple(int(v) for v in c) for c in lattice
                         if tuple(int(v) for v in c) not in book.visited]
            unvisited = [c for c in unvisited if not book.skip(c)]
            if not unvisited or trace.n_samples >= budget:
                break
            current = unvisited[rng.integers(len(unvisited))]
            crate = float(evaluate_qos(current))
            ccost = float(space.costs(np.asarray(current)[None, :])[0])
            trace.record(current, crate, ccost, crate >= qos_target)
            book.update(current, crate >= qos_target)
            current_score = score(crate, ccost)
    return trace


def central_composite_design(bounds) -> list[tuple[int, ...]]:
    """3-level face-centered central composite design over [0, m_i]:
    2^n factorial corners + 2n axial face points + center."""
    n = len(bounds)
    lo = [0] * n
    hi = list(bounds)
    mid = [m // 2 for m in bounds]
    pts: list[tuple[int, ...]] = []
    for corner in itertools.product(*[(lo_v, hi_v)
                                      for lo_v, hi_v in zip(lo, hi)]):
        pts.append(tuple(int(v) for v in corner))
    for dim in range(n):
        for v in (lo[dim], hi[dim]):
            p = list(mid)
            p[dim] = v
            pts.append(tuple(int(x) for x in p))
    pts.append(tuple(int(v) for v in mid))
    seen, uniq = set(), []
    for p in pts:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def run_rsm(space: SearchSpace, evaluate_qos, qos_target: float = 0.99,
            budget: int = 200, seed: int = 0) -> SearchTrace:
    """Response Surface Methodology (paper §5.3): evaluate the central
    composite face-centered design, then explore around the most promising
    design point (greedy neighborhood search, switching to the next-best
    design point when stuck — the behavior described for Fig. 12)."""
    trace, book = SearchTrace(), _Bookkeeping(space)
    design = central_composite_design(space.bounds)
    results = []
    for p in design:
        if trace.n_samples >= budget:
            break
        if book.skip(p):
            continue
        rate = float(evaluate_qos(p))
        cost = float(space.costs(np.asarray(p)[None, :])[0])
        trace.record(p, rate, cost, rate >= qos_target)
        book.update(p, rate >= qos_target)
        results.append((p, rate, cost))

    def key(item):
        p, rate, cost = item
        return (1, -cost) if rate >= qos_target else (0, rate)

    results.sort(key=key, reverse=True)
    for start, rate, cost in results:
        if trace.n_samples >= budget:
            break
        sub = run_hill_climb(space, evaluate_qos, qos_target=qos_target,
                             budget=budget - trace.n_samples, start=start,
                             seed=seed)
        for e in sub.evaluations:
            if tuple(e.config) in book.visited:
                continue
            trace.record(e.config, e.qos_rate, e.cost, e.feasible)
            book.update(e.config, e.feasible)
        best = trace.best_feasible()
        if best is not None:
            break
    return trace


# ---------------------------------------------------------------------------
# Exact bucketed allocation (Mélange-style ILP / enumeration)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BucketedSolution:
    """Provably minimum-cost pool for a bucketed workload.

    ``assignment[b][t]`` is the fraction of bucket ``b``'s traffic routed to
    type ``t`` (rows sum to 1, quantized to ``1/slice_factor``); ``loads[t]``
    is the fractional instance-time that routing demands of type ``t``, of
    which ``config[t] = ceil(loads[t])`` whole instances are bought."""

    config: tuple[int, ...]
    cost: float
    assignment: tuple[tuple[float, ...], ...]
    loads: tuple[float, ...]
    method: str


def _slice_compositions(total: int, parts: int):
    """All ways to write ``total`` as an ordered sum of ``parts`` >=0 ints."""
    if parts == 1:
        yield (total,)
        return
    for head in range(total + 1):
        for rest in _slice_compositions(total - head, parts - 1):
            yield (head,) + rest


def _bucketed_inputs(rates, tputs, prices, slice_factor, utilization, bounds):
    rates_arr = np.asarray(rates, dtype=np.float64).reshape(-1)
    tput_arr = np.atleast_2d(np.asarray(tputs, dtype=np.float64))
    price_arr = np.asarray(prices, dtype=np.float64).reshape(-1)
    n_types, n_buckets = tput_arr.shape
    if rates_arr.shape[0] != n_buckets:
        raise ValueError("rates must have one entry per tput column")
    if price_arr.shape[0] != n_types:
        raise ValueError("prices must have one entry per tput row")
    if np.any(rates_arr < 0) or rates_arr.sum() <= 0:
        raise ValueError("bucket rates must be >= 0 with a positive sum")
    if np.any(price_arr <= 0):
        raise ValueError("prices must be positive")
    if slice_factor < 1:
        raise ValueError("slice_factor must be >= 1")
    if not 0 < utilization <= 1:
        raise ValueError("utilization must be in (0, 1]")
    eff = tput_arr * float(utilization)
    for b in range(n_buckets):
        if rates_arr[b] > 0 and not np.any(eff[:, b] > 0):
            raise ValueError(f"bucket {b} has no type able to serve it")
    if bounds is None:
        bounds = upper_bounds_from_throughput(rates_arr, eff)
    bounds = tuple(int(m) for m in bounds)
    if len(bounds) != n_types:
        raise ValueError("bounds must have one entry per type")
    # Instance-time one *slice* of bucket b demands of type t (inf where the
    # type cannot serve the bucket; 0 where the bucket carries no traffic).
    unit = np.full((n_buckets, n_types), np.inf)
    for b in range(n_buckets):
        for t in range(n_types):
            if rates_arr[b] == 0:
                unit[b, t] = 0.0
            elif eff[t, b] > 0:
                unit[b, t] = rates_arr[b] / (slice_factor * eff[t, b])
    return rates_arr, eff, price_arr, bounds, unit


def _solve_milp(price_arr, bounds, unit, slice_factor):
    from scipy.optimize import Bounds, LinearConstraint, milp

    n_buckets, n_types = unit.shape
    n_var = n_buckets * n_types + n_types
    c = np.concatenate([np.zeros(n_buckets * n_types), price_arr])
    a_eq = np.zeros((n_buckets, n_var))
    for b in range(n_buckets):
        a_eq[b, b * n_types:(b + 1) * n_types] = 1.0
    a_cap = np.zeros((n_types, n_var))
    for t in range(n_types):
        for b in range(n_buckets):
            if np.isfinite(unit[b, t]):
                a_cap[t, b * n_types + t] = unit[b, t]
        a_cap[t, n_buckets * n_types + t] = -1.0
    ub = np.empty(n_var)
    for b in range(n_buckets):
        for t in range(n_types):
            ub[b * n_types + t] = slice_factor if np.isfinite(unit[b, t]) else 0
    ub[n_buckets * n_types:] = bounds
    res = milp(c=c,
               constraints=[LinearConstraint(a_eq, slice_factor, slice_factor),
                            LinearConstraint(a_cap, -np.inf, 0.0)],
               integrality=np.ones(n_var),
               bounds=Bounds(np.zeros(n_var), ub))
    if not res.success:
        raise ValueError("bucketed allocation is infeasible under the given "
                         "bounds (milp: %s)" % res.message)
    x = np.round(res.x).astype(np.int64)
    y = x[:n_buckets * n_types].reshape(n_buckets, n_types)
    return y


def _solve_enumerate(price_arr, bounds, unit, slice_factor):
    """Exact depth-first branch and bound over per-bucket slice compositions.

    The lower bound at any node is the *continuous* cost of the load placed
    so far plus, for every unplaced bucket, the cost of serving it wholly on
    its cheapest-per-query type — both relaxations of the integer objective,
    so pruning never cuts the optimum."""
    n_buckets, n_types = unit.shape
    comps = list(_slice_compositions(slice_factor, n_types))
    comp_by_bucket = []
    for b in range(n_buckets):
        ok = [cm for cm in comps
              if all(c == 0 or np.isfinite(unit[b, t])
                     for t, c in enumerate(cm))]
        if not ok:
            raise ValueError("bucketed allocation is infeasible under the "
                             "given bounds")
        comp_by_bucket.append(ok)
    frac_min = [min(unit[b, t] * slice_factor * price_arr[t]
                    for t in range(n_types) if np.isfinite(unit[b, t]))
                for b in range(n_buckets)]
    tail = np.zeros(n_buckets + 1)
    for b in range(n_buckets - 1, -1, -1):
        tail[b] = tail[b + 1] + frac_min[b]
    best = {"cost": math.inf, "y": None}
    choice = [None] * n_buckets

    def dfs(b, loads):
        if float(np.dot(price_arr, loads)) + tail[b] >= best["cost"] - 1e-12:
            return
        if b == n_buckets:
            counts = [int(math.ceil(ld - 1e-9)) for ld in loads]
            if any(c > m for c, m in zip(counts, bounds)):
                return
            cost = float(np.dot(price_arr, counts))
            if cost < best["cost"] - 1e-12:
                best["cost"] = cost
                best["y"] = [list(cm) for cm in choice]
            return
        for cm in comp_by_bucket[b]:
            nxt = loads + np.where(np.asarray(cm) > 0,
                                   np.nan_to_num(unit[b], posinf=0.0)
                                   * np.asarray(cm), 0.0)
            if any(math.ceil(ld - 1e-9) > m for ld, m in zip(nxt, bounds)):
                continue
            choice[b] = cm
            dfs(b + 1, nxt)
    dfs(0, np.zeros(n_types))
    if best["y"] is None:
        raise ValueError("bucketed allocation is infeasible under the given "
                         "bounds")
    return np.asarray(best["y"], dtype=np.int64)


def solve_bucketed(rates, tputs, prices, *, slice_factor: int = 4,
                   bounds=None, utilization: float = 1.0,
                   method: str = "auto") -> BucketedSolution:
    """Exact minimum-cost pool for a request-size-bucketed workload
    (Mélange-style allocation).

    Each bucket's arrival rate is split into ``slice_factor`` equal slices;
    every slice is assigned to one instance type; a type's instance count is
    the ceiling of the instance-time its assigned slices demand, derated by
    ``utilization``.  The solver minimizes ``sum(price_t * count_t)`` over
    all integer slice assignments — the global optimum at that granularity,
    not a heuristic.

    ``rates``: per-bucket qps, shape ``(n_buckets,)``.
    ``tputs``: queries/s one instance sustains, shape ``(n_types,
    n_buckets)`` (``serving.instance.measured_throughputs``).
    ``bounds``: optional per-type instance caps (default: enough of each
    type to carry the whole load alone).
    ``method``: ``"milp"`` (scipy/HiGHS, raises if scipy is absent),
    ``"enumerate"`` (pure-python exact branch and bound), or ``"auto"``.
    """
    rates_arr, eff, price_arr, bounds, unit = _bucketed_inputs(
        rates, tputs, prices, slice_factor, utilization, bounds)
    if method not in ("auto", "milp", "enumerate"):
        raise ValueError(f"unknown method: {method!r}")
    use = method
    if method == "auto":
        try:
            import scipy.optimize  # noqa: F401
            use = "milp"
        except ImportError:
            use = "enumerate"
    if use == "milp":
        y = _solve_milp(price_arr, bounds, unit, slice_factor)
    else:
        y = _solve_enumerate(price_arr, bounds, unit, slice_factor)
    loads = np.array([float(np.sum(np.where(y[:, t] > 0,
                                            np.nan_to_num(unit[:, t],
                                                          posinf=0.0)
                                            * y[:, t], 0.0)))
                      for t in range(len(price_arr))])
    config = tuple(int(math.ceil(ld - 1e-9)) for ld in loads)
    cost = float(np.dot(price_arr, config))
    assignment = tuple(tuple(float(v) / slice_factor for v in row)
                       for row in y)
    return BucketedSolution(config=config, cost=cost, assignment=assignment,
                            loads=tuple(float(ld) for ld in loads),
                            method=use)
