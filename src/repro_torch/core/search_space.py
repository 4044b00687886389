"""Integer configuration lattice for heterogeneous pool search.

A numpy-only copy of ``repro/core/search_space.py``: the port imports
nothing of the JAX package.

A pool configuration is an integer vector ``x = [x_1, ..., x_n]`` where ``x_i``
is the number of instances (or serving cells) of type ``i``.  The search space
is the full integer lattice ``prod_i {0, ..., m_i}`` bounded by the per-type
upper bounds ``m_i`` (paper §4: the smallest count beyond which the QoS
satisfaction rate stops improving).

RIBBON's BO, the baselines, and the pruning logic all operate over this
enumerated lattice: the spaces in the paper are small (1000s of configs for
three types), so enumeration is both faithful and exact.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SearchSpace:
    """Bounded integer lattice over ``n`` instance types."""

    bounds: tuple[int, ...]               # m_i per type (inclusive upper bound)
    prices: tuple[float, ...]             # p_i unit-time price per type

    def __post_init__(self):
        if len(self.bounds) != len(self.prices):
            raise ValueError("bounds and prices must have the same length")
        if any(m < 0 for m in self.bounds):
            raise ValueError("bounds must be non-negative")
        if any(p <= 0 for p in self.prices):
            raise ValueError("prices must be positive")

    @property
    def n_types(self) -> int:
        return len(self.bounds)

    @property
    def size(self) -> int:
        return int(np.prod([m + 1 for m in self.bounds]))

    def enumerate(self) -> np.ndarray:
        """All configurations, shape (size, n_types), int32.

        Paper §4 ("RIBBON maintains a smooth distribution of configurations"):
        within each dimension configurations are arranged in increasing
        instance-count order, which `itertools.product` over ``range`` gives us
        for free — this is the smooth per-dimension ordering the GP relies on.
        """
        grids = [range(m + 1) for m in self.bounds]
        return np.array(list(itertools.product(*grids)), dtype=np.int32)

    def costs(self, configs: np.ndarray) -> np.ndarray:
        """Unit-time price of each configuration: sum_i p_i * x_i."""
        return np.asarray(configs, dtype=np.float64) @ np.asarray(self.prices)

    @property
    def max_cost(self) -> float:
        """sum_i p_i * m_i — the Eq. 2 normalizer."""
        return float(np.dot(self.prices, self.bounds))

    def normalize(self, configs: np.ndarray) -> np.ndarray:
        """Map configs to [0, 1]^n for GP lengthscale conditioning."""
        denom = np.maximum(np.asarray(self.bounds, dtype=np.float32), 1.0)
        return np.asarray(configs, dtype=np.float32) / denom

    def index_of(self, config) -> int:
        """Row index of ``config`` in :meth:`enumerate` ordering."""
        idx = 0
        for x, m in zip(config, self.bounds):
            if not (0 <= x <= m):
                raise ValueError(f"config {config} outside bounds {self.bounds}")
            idx = idx * (m + 1) + int(x)
        return idx


@dataclass(frozen=True)
class JointSearchSpace(SearchSpace):
    """Pool × routing-policy lattice (joint search).

    The last dimension is a categorical *routing-policy index* in
    ``{0, ..., n_policies - 1}``, priced at zero — choosing a smarter
    router is free, only capacity costs money.  ``SearchSpace``'s
    positive-price invariant is relaxed for that one axis (and only that
    one); everything else (enumeration order, costs, normalize, index_of)
    is inherited unchanged, so the BO engine sees one integer lattice with
    one extra dimension.

    The policy axis is categorical, not a capacity count: the
    dominance-down prune rule must not read "policy k <= policy k'" as
    "less capacity".  ``pruning.apply_prune_rules_joint`` and the
    ``PruneSet`` host mirror therefore restrict the down-set to lattice
    points with the *same* policy index whenever the space carries a
    policy axis (``n_policies > 1``); the incumbent-cost rule stays global
    (a pool priced at or above the incumbent cannot win under any router).
    """

    n_policies: int = 1

    def __post_init__(self):
        if len(self.bounds) != len(self.prices):
            raise ValueError("bounds and prices must have the same length")
        if len(self.bounds) < 2:
            raise ValueError("a joint space needs at least one pool type "
                             "plus the policy axis")
        if self.n_policies < 1:
            raise ValueError(f"n_policies must be >= 1, got "
                             f"{self.n_policies}")
        if any(m < 0 for m in self.bounds):
            raise ValueError("bounds must be non-negative")
        if self.bounds[-1] != self.n_policies - 1:
            raise ValueError(
                f"the last bound is the policy axis and must equal "
                f"n_policies - 1 = {self.n_policies - 1}, got "
                f"{self.bounds[-1]}")
        if any(p <= 0 for p in self.prices[:-1]):
            raise ValueError("prices must be positive")
        if self.prices[-1] != 0.0:
            raise ValueError("the policy axis is free: prices[-1] must "
                             "be 0.0")

    @classmethod
    def joint(cls, space: SearchSpace,
              n_policies: int) -> "JointSearchSpace":
        """Extend a pool space with an ``n_policies``-way routing axis."""
        return cls(bounds=tuple(space.bounds) + (int(n_policies) - 1,),
                   prices=tuple(space.prices) + (0.0,),
                   n_policies=int(n_policies))

    @property
    def pool_space(self) -> SearchSpace:
        """The pool-only projection (drops the policy axis)."""
        return SearchSpace(bounds=self.bounds[:-1], prices=self.prices[:-1])

    def split(self, config) -> tuple[tuple[int, ...], int]:
        """(pool_config, policy_index) of one joint lattice point."""
        cfg = tuple(int(v) for v in config)
        return cfg[:-1], cfg[-1]


def estimate_upper_bounds(evaluate_qos, n_types: int, hard_cap: int = 24,
                          tol: float = 1e-4) -> tuple[int, ...]:
    """Estimate m_i per the paper: grow a homogeneous pool of type ``i`` until
    the QoS satisfaction rate stops improving; m_i is the count at saturation.

    ``evaluate_qos(config) -> float`` is the (expensive) QoS-rate oracle.
    """
    bounds = []
    for i in range(n_types):
        prev_rate = -1.0
        m_i = 1
        for count in range(1, hard_cap + 1):
            config = [0] * n_types
            config[i] = count
            rate = float(evaluate_qos(config))
            if rate <= prev_rate + tol:
                m_i = count - 1
                break
            prev_rate = rate
            m_i = count
        bounds.append(max(m_i, 1))
    return tuple(bounds)


def upper_bounds_from_throughput(rates, tputs, *, headroom: float = 1.0,
                                 cap: int = 64) -> tuple[int, ...]:
    """Per-type instance caps from measured throughputs: enough instances of
    each type to carry the *entire* bucketed load alone (the loosest bound a
    minimum-cost allocation can need), scaled by ``headroom`` and clipped to
    ``cap``.

    ``rates`` is the per-bucket arrival rate vector (qps); ``tputs`` is the
    ``(n_types, n_buckets)`` matrix of queries/s one instance of each type
    sustains per bucket (``serving.instance.measured_throughputs``).  A type
    with a non-positive throughput on any bucket cannot serve the load alone,
    so it falls back to ``cap``.
    """
    rates_arr = np.asarray(rates, dtype=np.float64)
    tput_arr = np.atleast_2d(np.asarray(tputs, dtype=np.float64))
    if tput_arr.shape[1] != rates_arr.shape[0]:
        raise ValueError("tputs must have one column per bucket rate")
    if headroom <= 0:
        raise ValueError("headroom must be positive")
    bounds = []
    for col in tput_arr:
        if np.any(col <= 0):
            bounds.append(int(cap))
            continue
        need = float(np.sum(rates_arr / col)) * headroom
        bounds.append(int(min(cap, int(np.ceil(need - 1e-9)))))
    return tuple(max(b, 1) for b in bounds)
