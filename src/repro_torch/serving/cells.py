"""RIBBON over pools of differently sized serving cells: the reference's
``benchmarks/bench_tpu_cells.py`` procedure as a library function, run
over ``instance.H100_CELLS`` (or any cell catalog).

An LLM-decode-like profile (decode-heavy, bound by memory traffic per
token) is served by a pool of the catalog's cells, largest first; the
procedure finds the cheapest homogeneous pool of the largest cell, the
exhaustive optimum over the bounded space, and RIBBON's pick started from
that homogeneous pool.  Host code: the simulator runs on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import RibbonOptimizer, SearchSpace
from .instance import InstanceType, ModelProfile
from .pool import PoolEvaluator
from .workload import WorkloadSpec

# the reference benchmark's LLM-serving-like profile: decode-heavy, HBM-bound
# per token
LLM_PROFILE = ModelProfile("llm-decode", flops_per_sample=6.0e9,
                           act_bytes_per_sample=2.5e8, weight_bytes=1.4e10,
                           qos_latency=0.20, max_batch=64, median_batch=8)


@dataclass(frozen=True)
class CellSearch:
    """The procedure's results: the homogeneous baseline (count of the
    largest cell, $/h; None and inf when none up to 6 meets the target),
    the exhaustive optimum, RIBBON's pick and its samples."""

    homog_count: int | None
    homog_cost: float
    best_config: tuple | None
    best_cost: float
    ribbon_config: tuple | None
    ribbon_cost: float | None
    ribbon_samples: int

    @property
    def saving_pct(self) -> float:
        if self.homog_count is None:
            return float("nan")
        return 100 * (1 - self.best_cost / self.homog_cost)


# the reference benchmark's set-up: a 1200-query lognormal stream at 95 qps
# (seed 0), QoS 0.99 within the profile's 200 ms, bounds (6, 8, 10), up to
# 60 RIBBON rounds
QOS_TARGET, N_QUERIES, RATE_QPS, BOUNDS, ROUNDS = 0.99, 1200, 95.0, \
    (6, 8, 10), 60


def search_cells(types: list[InstanceType], *, device=None) -> CellSearch:
    """The reference benchmark's procedure over three cell types, largest
    first, serving ``LLM_PROFILE``."""
    wl = WorkloadSpec(seed=0, rate_qps=RATE_QPS, median_batch=8,
                      max_batch=64).realize(N_QUERIES)
    ev = PoolEvaluator(LLM_PROFILE, types, wl, device=device)
    space = SearchSpace(bounds=BOUNDS, prices=tuple(t.price for t in types))

    homog_cost, homog_n = np.inf, None
    for n in range(1, BOUNDS[0] + 1):
        if ev((n, 0, 0)) >= QOS_TARGET:
            homog_cost, homog_n = n * types[0].price, n
            break

    best_cfg, best_cost, _ = ev.exhaustive(space, QOS_TARGET)
    opt = RibbonOptimizer(space, qos_target=QOS_TARGET,
                          start=(homog_n or BOUNDS[0], 0, 0), device=device)
    for _ in range(ROUNDS):
        cfg = opt.ask()
        if cfg is None or opt.done:
            break
        opt.tell(cfg, float(ev(cfg)))
    found = opt.trace.best_feasible()
    return CellSearch(homog_n, homog_cost,
                      None if best_cfg is None else tuple(best_cfg),
                      best_cost,
                      None if found is None else tuple(found.config),
                      None if found is None else found.cost,
                      opt.trace.n_samples)
