"""Active pruning of the configuration lattice (paper §4).

Two sound pruning rules derived from the objective's structure:

1. **Dominance-down rule** — when a configuration x_c violates the QoS by
   more than a threshold θ, every x_c' with c'_i <= c_i for all i cannot meet
   it either (fewer instances of every type only serve slower): the whole
   down-set of x_c is pruned.

2. **Cost rule** — a configuration priced at or above the best *feasible*
   configuration found so far can never improve the objective.

Two mirrors of the same rules live here: ``PruneSet``, the host-side numpy
mask (init-queue filter, exhaustion counts, checkpoints), and
``apply_prune_rules``, the update ``RibbonOptimizer.tell`` applies to its
device-resident blocked mask (sampled | pruned), which the acquisition
argmax consumes without a round trip to the host.  Counterpart of
``repro/core/pruning.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .search_space import SearchSpace


def apply_prune_rules(blocked: torch.Tensor, lattice: torch.Tensor,
                      costs: torch.Tensor, idx: int, config: torch.Tensor,
                      cost_cut: torch.Tensor, apply_down: bool,
                      apply_cost: bool) -> torch.Tensor:
    """Device-side ``tell`` update of the blocked (sampled|pruned) mask.

    blocked:   (size,) bool mask, True = never propose again
    lattice:   (size, d) float32 lattice counts
    costs:     (size,) float32 lattice prices
    idx:       lattice index of the config just evaluated
    config:    (d,) float32 — its counts (dominance-down anchor)
    cost_cut:  scalar float32 — incumbent feasible cost (+inf disables)
    apply_down/apply_cost: which rules fire

    Counts are exact in float32 (small integers) and price gaps are far
    above float32 ulp, so the result matches the float64 host rules
    elementwise.  Returns a new mask; ``blocked`` is left as it was.
    """
    blocked = blocked.clone()
    blocked[idx] = True
    down = torch.all(lattice <= config[None, :], dim=1) & apply_down
    over = (costs >= cost_cut - 1e-12) & apply_cost
    return blocked | down | over


def apply_prune_rules_joint(blocked: torch.Tensor, lattice: torch.Tensor,
                            costs: torch.Tensor, idx: int,
                            config: torch.Tensor, cost_cut: torch.Tensor,
                            apply_down: bool,
                            apply_cost: bool) -> torch.Tensor:
    """Joint pool x policy variant of :func:`apply_prune_rules`.

    The last lattice dimension is a categorical routing-policy index
    (``JointSearchSpace``), so the down-set is restricted to lattice points
    with the *same* policy index.  The cost rule stays global.
    """
    blocked = blocked.clone()
    blocked[idx] = True
    down = (torch.all(lattice <= config[None, :], dim=1)
            & (lattice[:, -1] == config[-1]) & apply_down)
    over = (costs >= cost_cut - 1e-12) & apply_cost
    return blocked | down | over


class PruneSet:
    def __init__(self, space: SearchSpace, costs=None):
        """``costs`` overrides the lattice cost vector the cost rule cuts on
        (e.g. risk-adjusted tier costs) — it must stay bit-identical to the
        ``costs`` the device-side ``apply_prune_rules`` consumes, or the two
        mirrors diverge."""
        self.space = space
        self.lattice = space.enumerate()                     # (size, n)
        self.costs = (space.costs(self.lattice) if costs is None
                      else np.asarray(costs, dtype=np.float64))  # (size,)
        self.mask = np.zeros(space.size, dtype=bool)         # True = pruned
        # Joint pool x policy lattice: dominance-down must not cross the
        # categorical policy axis (see apply_prune_rules_joint).
        self._joint = getattr(space, "n_policies", 1) > 1

    def __len__(self) -> int:
        return int(self.mask.sum())

    def prune_down_set(self, config) -> int:
        """Rule 1: prune every config componentwise <= ``config``.
        Returns how many new configs were pruned."""
        c = np.asarray(config, dtype=np.int32)
        dominated = np.all(self.lattice <= c[None, :], axis=1)
        if self._joint:
            dominated &= self.lattice[:, -1] == c[-1]
        new = int(np.sum(dominated & ~self.mask))
        self.mask |= dominated
        return new

    def prune_cost_at_least(self, cost: float) -> int:
        """Rule 2: prune every config with price >= ``cost`` (the incumbent
        feasible cost).  The incumbent itself is already in the sampled mask,
        so pruning ties is safe."""
        over = self.costs >= cost - 1e-12
        new = int(np.sum(over & ~self.mask))
        self.mask |= over
        return new

    def is_pruned(self, config) -> bool:
        return bool(self.mask[self.space.index_of(config)])

    def state_dict(self) -> dict:
        return {"mask": self.mask.copy()}

    def load_state_dict(self, state: dict) -> None:
        self.mask = np.asarray(state["mask"], dtype=bool).copy()
