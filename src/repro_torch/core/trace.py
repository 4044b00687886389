"""Search-trace bookkeeping shared by RIBBON and the competing strategies.

A numpy-only copy of ``repro/core/trace.py``: the port imports
nothing of the JAX package.

Every strategy records the same per-evaluation tuple so the paper's comparison
figures (10, 13, 14) can be computed uniformly:
  * samples needed to reach a given cost-saving level (Fig. 10),
  * cumulative exploration cost vs exhaustive-search cost (Fig. 13),
  * number of QoS-violating configurations sampled (Fig. 14).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Evaluation:
    config: tuple[int, ...]
    qos_rate: float
    cost: float
    feasible: bool
    estimated: bool = False   # warm-restart estimates (not real samples)


@dataclass
class SearchTrace:
    evaluations: list[Evaluation] = field(default_factory=list)

    def record(self, config, qos_rate: float, cost: float, feasible: bool,
               estimated: bool = False) -> None:
        self.evaluations.append(Evaluation(tuple(int(c) for c in config),
                                           float(qos_rate), float(cost),
                                           bool(feasible), bool(estimated)))

    # -- real (non-estimated) sample statistics ------------------------------
    @property
    def real(self) -> list[Evaluation]:
        return [e for e in self.evaluations if not e.estimated]

    @property
    def n_samples(self) -> int:
        return len(self.real)

    @property
    def n_violations(self) -> int:
        return sum(1 for e in self.real if not e.feasible)

    @property
    def exploration_cost(self) -> float:
        """Total price of every evaluated config (each is run for one fixed
        evaluation window, so cost is proportional to the sum of prices)."""
        return float(sum(e.cost for e in self.real))

    def best_feasible(self) -> Evaluation | None:
        feas = [e for e in self.real if e.feasible]
        if not feas:
            return None
        return min(feas, key=lambda e: e.cost)

    def best_cost_curve(self) -> np.ndarray:
        """Best feasible cost after each real sample (inf until first)."""
        out, best = [], np.inf
        for e in self.real:
            if e.feasible:
                best = min(best, e.cost)
            out.append(best)
        return np.array(out)

    def samples_to_reach_cost(self, cost_target: float) -> int | None:
        """Number of samples until a feasible config with cost <= target."""
        curve = self.best_cost_curve()
        hits = np.nonzero(curve <= cost_target + 1e-9)[0]
        return int(hits[0]) + 1 if hits.size else None
