"""RIBBON core in PyTorch: Bayesian optimisation over heterogeneous pools.

Counterpart of ``repro/core``.  Public API:
    SearchSpace, JointSearchSpace, estimate_upper_bounds
    RibbonOptimizer, run_ribbon
    run_random, run_hill_climb, run_rsm, central_composite_design
    solve_bucketed, BucketedSolution
    ribbon_objective, ribbon_objective_batch
    GaussianProcess, matern52, rounded_matern52
    expected_improvement, select_next, select_batch
    PruneSet, apply_prune_rules, apply_prune_rules_joint
    SearchTrace, Evaluation
"""

from .acquisition import expected_improvement, select_batch, select_next
from .baselines import (BucketedSolution, central_composite_design,
                        run_hill_climb, run_random, run_rsm, solve_bucketed)
from .gp import GaussianProcess, matern52, round_counts, rounded_matern52
from .objective import ribbon_objective, ribbon_objective_batch
from .pruning import PruneSet, apply_prune_rules, apply_prune_rules_joint
from .ribbon import RibbonOptimizer, run_ribbon
from .search_space import (JointSearchSpace, SearchSpace,
                           estimate_upper_bounds)
from .trace import Evaluation, SearchTrace

__all__ = [
    "SearchSpace", "JointSearchSpace", "estimate_upper_bounds",
    "RibbonOptimizer", "run_ribbon",
    "run_random", "run_hill_climb", "run_rsm", "central_composite_design",
    "solve_bucketed", "BucketedSolution",
    "ribbon_objective", "ribbon_objective_batch",
    "GaussianProcess", "matern52", "rounded_matern52", "round_counts",
    "expected_improvement", "select_next", "select_batch",
    "PruneSet", "apply_prune_rules", "apply_prune_rules_joint",
    "SearchTrace", "Evaluation",
]
