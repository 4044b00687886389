"""Pool evaluation glue: the QoS oracle and cost metrics of the search.

``PoolEvaluator`` is the black-box f(x) the paper's BO samples: it
deploys a pool configuration against the query stream (the simulator) and
returns the measured QoS satisfaction rate, memoized per configuration
(per routing policy, and per warm carry for ``grid_from``).
Counterpart of ``repro/serving/pool.py``; the simulator dispatches run on
``device`` (default ``cuda``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar

import numpy as np

from ..core.search_space import SearchSpace
from .instance import (AWS_INSTANCES, MODEL_PROFILES, PAPER_POOLS,
                       InstanceType, ModelProfile)
from .routing import RoutingPolicy
from .simulator import PoolSimulator
from .workload import BucketedWorkloadSpec, Workload, WorkloadSpec


def cost_effectiveness(perf_qps: float, price_per_hour: float) -> float:
    """Paper Eq. 1: 3600 * Perf / Price  (queries per dollar)."""
    return 3600.0 * perf_qps / price_per_hour


@dataclass
class PoolEvaluator:
    """QoS oracle over a fixed (model, type order, workload).

    Memoized per configuration (per (load factor, configuration) cell for
    ``grid``), with one memo pair per routing policy and an LRU of memos per
    warm carry for ``grid_from``; ``n_evals`` counts the configurations
    (cells) newly simulated, as in the reference.  The misses of one call
    are simulated in one dispatch: the reference cut them into power-of-two
    chunks of at most 64 to bound the number of XLA executables, which a
    CUDA kernel does not need, and a lane's result does not depend on its
    batch.
    """

    model: ModelProfile
    types: list[InstanceType]
    workload: Workload
    max_instances: int = 40
    device: object = None
    n_evals: int = field(default=0, init=False)

    # Warm-keyed memo bound: per-cell caches are kept for this many distinct
    # (state, deployed, now, warmup, policy) warm keys, LRU — every
    # adaptation cut carries a fresh backlog, so old cuts age out.
    _warm_states: ClassVar[int] = 4

    def __post_init__(self):
        self.sim = PoolSimulator(self.model, self.types, self.workload,
                                 max_instances=self.max_instances,
                                 device=self.device)
        self._cache: dict[tuple[int, ...], float] = {}
        # (load_factor, config) -> rate for factors != 1.0; the unit factor
        # shares self._cache.
        self._grid_cache: dict[tuple[float, tuple[int, ...]], float] = {}
        # warm key -> {(load_factor, config) -> rate}; see grid_from.
        self._warm_cache: dict[tuple, dict] = {}
        # RoutingPolicy.key() -> (cold cache, grid cache): each policy gets
        # its own memo pair; the pair above is the policy=None view.
        self._policy_caches: dict[tuple, tuple[dict, dict]] = {}

    @staticmethod
    def _policy_key(policy: RoutingPolicy | None):
        if policy is None:
            return None
        if policy.stacked:
            raise ValueError(
                "PoolEvaluator memoizes per single policy; score stacked "
                "policies through PoolSimulator.qos or pass policy.row(p)")
        return policy.key()

    def _caches_for(self, pk) -> tuple[dict, dict]:
        if pk is None:
            return self._cache, self._grid_cache
        return self._policy_caches.setdefault(pk, ({}, {}))

    def __call__(self, config, *, policy=None) -> float:
        key = tuple(int(c) for c in config)
        cache, _ = self._caches_for(self._policy_key(policy))
        if key not in cache:
            cache[key] = float(self.sim.qos(key, policy=policy).rates)
            self.n_evals += 1
        return cache[key]

    def batch(self, configs, *, policy=None) -> np.ndarray:
        """QoS rates for many configs, aligned with ``configs``: the memo's
        misses (deduplicated; ``policy=`` selects that policy's memo) in one
        batched dispatch."""
        keys = [tuple(int(c) for c in cfg) for cfg in configs]
        cache, _ = self._caches_for(self._policy_key(policy))
        missing = [k for k in dict.fromkeys(keys) if k not in cache]
        if missing:
            rates = self.sim.qos(np.asarray(missing, dtype=np.int64),
                                 policy=policy).rates
            for k, r in zip(missing, rates):
                cache[k] = float(r)
            self.n_evals += len(missing)
        return np.asarray([cache[k] for k in keys], dtype=np.float64)

    def grid(self, configs, load_factors, *, policy=None) -> np.ndarray:
        """QoS rates on the (load level × config) grid: (W, B) float64,
        cell ``[w, b]`` what an evaluator bound to
        ``workload.scaled(load_factors[w])`` measures for ``configs[b]``.
        Misses are evaluated as a cross product (every load level with any
        miss × every config missing somewhere) in one grid dispatch;
        ``policy=`` routes and selects that policy's memo pair."""
        cache, grid_cache = self._caches_for(self._policy_key(policy))

        def cell_get(f, k):
            return cache.get(k) if f == 1.0 else grid_cache.get((f, k))

        def cell_put(f, k, rate):
            if f == 1.0:
                cache[k] = rate
            else:
                grid_cache[(f, k)] = rate

        return self._sweep_grid(
            configs, load_factors, cell_get, cell_put,
            lambda cols, rows: self.sim.qos(cols, workloads=rows,
                                            policy=policy).rates)

    def _sweep_grid(self, configs, load_factors, cell_get, cell_put,
                    dispatch) -> np.ndarray:
        keys = [tuple(int(c) for c in cfg) for cfg in configs]
        factors = [float(f) for f in load_factors]
        uniq_keys = list(dict.fromkeys(keys))
        uniq_factors = list(dict.fromkeys(factors))
        missing = {(f, k) for f in uniq_factors for k in uniq_keys
                   if cell_get(f, k) is None}
        if missing:
            cols = [k for k in uniq_keys if any((f, k) in missing
                                                for f in uniq_factors)]
            rows = [f for f in uniq_factors if any((f, k) in missing
                                                   for k in cols)]
            rates = dispatch(np.asarray(cols, dtype=np.int64), rows)
            for w, f in enumerate(rows):
                for b, k in enumerate(cols):
                    cell_put(f, k, float(rates[w, b]))
            self.n_evals += len(missing)
        return np.asarray([[cell_get(f, k) for k in keys]
                           for f in factors], dtype=np.float64)

    def grid_from(self, state, configs, load_factors, *, deployed=None,
                  now=None, warmup=None, policy=None) -> np.ndarray:
        """Warm-start ``grid``: QoS rates of candidate pools scored from a
        live carry (each candidate's initial state the ``PoolState.remap``
        of the ``deployed`` pool at ``now``, added slots paying their
        ``warmup`` cold start).  Cell ``[w, b]`` equals the warm single
        lane on the scaled workload from that candidate's remapped state.
        Memoized per (warm state, load factor, config) cell, the per-state
        memos LRU-bounded (``_warm_states``)."""
        warm_key = (
            None if deployed is None else tuple(int(c) for c in deployed),
            None if now is None else float(now),
            None if warmup is None else tuple(float(w) for w in warmup),
            float(state.clock),
            tuple(np.asarray(state.free, dtype=np.float64).tolist()),
            self._policy_key(policy),
        )
        cache = self._warm_cache.pop(warm_key, None)
        if cache is None:
            cache = {}
            while len(self._warm_cache) >= self._warm_states:
                self._warm_cache.pop(next(iter(self._warm_cache)))
        # (Re-)inserting moves the key to the recent end of the dict.
        self._warm_cache[warm_key] = cache
        return self._sweep_grid(
            configs, load_factors,
            lambda f, k: cache.get((f, k)),
            lambda f, k, rate: cache.__setitem__((f, k), rate),
            lambda cols, rows: self.sim.qos(
                cols, workloads=rows, state=state, deployed=deployed,
                now=now, warmup=warmup, policy=policy).rates)

    def exhaustive(self, space: SearchSpace, qos_target: float,
                   load_factor: float = 1.0, *, policy=None):
        """Ground-truth optimum and total exhaustive cost (paper Fig. 13
        normalizer), in one batched sweep, or a one-row grid sweep for
        ``load_factor != 1``.  Returns (best_config, best_cost,
        exhaustive_cost)."""
        lattice = space.enumerate()
        costs = space.costs(lattice)
        if load_factor == 1.0:
            rates = self.batch(lattice, policy=policy)
        else:
            rates = self.grid(lattice, [load_factor], policy=policy)[0]
        total = float(costs.sum())
        feasible = rates >= qos_target
        if not feasible.any():
            return None, np.inf, total
        i = int(np.argmin(np.where(feasible, costs, np.inf)))
        return tuple(int(c) for c in lattice[i]), float(costs[i]), total


def best_homogeneous(evaluator: PoolEvaluator, type_index: int, prices,
                     qos_target: float, cap: int = 24, *, policy=None):
    """Minimum-count homogeneous pool of one type meeting QoS, evaluated as
    one batched sweep over counts 1..cap (under ``policy=``, its memo).
    Returns (count, cost) or (None, inf)."""
    n = len(evaluator.types)
    cfgs = np.zeros((cap, n), dtype=np.int64)
    cfgs[:, type_index] = np.arange(1, cap + 1)
    rates = evaluator.batch(cfgs, policy=policy)
    ok = np.nonzero(rates >= qos_target)[0]
    if ok.size == 0:
        return None, np.inf
    count = int(ok[0]) + 1
    return count, count * prices[type_index]


# Request-size mixes backing the bucketed batch distributions: weights[i][j]
# is the traffic fraction landing in (input-size bucket i, output-size bucket
# j); the scales multiply the profile's per-sample bytes (input axis) and
# flops (output axis).
BUCKET_DIST_MIXES: dict[str, dict] = {
    "bucketed-small": {"weights": ((0.45, 0.15), (0.30, 0.10)),
                       "input_scales": (0.7, 1.6),
                       "output_scales": (0.8, 1.5)},
    "bucketed-large": {"weights": ((0.10, 0.30), (0.15, 0.45)),
                       "input_scales": (0.7, 1.6),
                       "output_scales": (0.8, 1.5)},
}


def paper_spec(model_name: str, seed: int = 0,
               rate_qps: float | None = None,
               batch_dist: str = "lognormal") -> WorkloadSpec:
    """The standard per-model stream as a :class:`WorkloadSpec` (paper §5.1
    parameters)."""
    profile = MODEL_PROFILES[model_name]
    if rate_qps is None:
        rate_qps = DEFAULT_RATES[model_name]
    return WorkloadSpec(seed=seed, rate_qps=rate_qps, batch_dist=batch_dist,
                        median_batch=profile.median_batch,
                        mean_batch=2.0 * profile.median_batch,
                        std_batch=profile.median_batch,
                        max_batch=profile.max_batch)


def paper_bucketed_spec(model_name: str, batch_dist: str, seed: int = 0,
                        rate_qps: float | None = None) -> BucketedWorkloadSpec:
    """Bucketed variant of the standard stream: the named mix from
    ``BUCKET_DIST_MIXES`` over the log-normal base, same arrivals and
    batches."""
    mix = BUCKET_DIST_MIXES[batch_dist]
    if rate_qps is None:
        rate_qps = DEFAULT_RATES[model_name]
    base = paper_spec(model_name, seed=seed, rate_qps=rate_qps,
                      batch_dist="lognormal")
    rates = tuple(tuple(w * float(rate_qps) for w in row)
                  for row in mix["weights"])
    return BucketedWorkloadSpec(base=base, rates=rates,
                                input_scales=mix["input_scales"],
                                output_scales=mix["output_scales"])


def paper_workload(model_name: str, seed: int = 0, n_queries: int = 1500,
                   rate_qps: float | None = None,
                   batch_dist: str = "lognormal") -> Workload:
    """The standard per-model query stream (paper §5.1 parameters); the
    bucketed names of ``BUCKET_DIST_MIXES`` give the log-normal stream with
    a bucket per query."""
    if batch_dist in BUCKET_DIST_MIXES:
        return paper_bucketed_spec(model_name, batch_dist, seed=seed,
                                   rate_qps=rate_qps).realize(n_queries)
    return paper_spec(model_name, seed=seed, rate_qps=rate_qps,
                      batch_dist=batch_dist).realize(n_queries)


def make_paper_setup(model_name: str, seed: int = 0, n_queries: int = 1500,
                     rate_qps: float | None = None,
                     batch_dist: str = "lognormal", device=None):
    """Standard experimental setup for one of the paper's five models:
    (evaluator, space, model_profile) with the Table 3 diverse pool, the
    simulator on ``device`` (default ``cuda``)."""
    profile = MODEL_PROFILES[model_name]
    types = [AWS_INSTANCES[n] for n in PAPER_POOLS[model_name]["diverse"]]
    wl = paper_workload(model_name, seed=seed, n_queries=n_queries,
                        rate_qps=rate_qps, batch_dist=batch_dist)
    evaluator = PoolEvaluator(profile, types, wl, device=device)
    space = SearchSpace(bounds=DEFAULT_BOUNDS[model_name],
                        prices=tuple(t.price for t in types))
    return evaluator, space, profile


# Arrival rates giving paper-like pool sizes.
DEFAULT_RATES: dict[str, float] = {
    "mtwnd": 800.0,
    "dien": 850.0,
    "candle": 550.0,
    "resnet50": 275.0,
    "vgg19": 36.0,
}

# Per-type search bounds m_i (paper: count at which QoS rate saturates).
DEFAULT_BOUNDS: dict[str, tuple[int, ...]] = {
    "mtwnd": (8, 10, 12),
    "dien": (8, 10, 12),
    "candle": (10, 12, 14),
    "resnet50": (10, 12, 14),
    "vgg19": (10, 12, 14),
}
