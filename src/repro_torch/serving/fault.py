"""Fault tolerance: cell-failure recovery and straggler mitigation.

* **Cell failure** — a lost node shrinks the pool; the remaining pool usually
  violates QoS.  Recovery reuses RIBBON's load-change machinery (a failure is
  indistinguishable from a per-cell load increase): measure the degraded
  config, warm-restart the BO with the exploration-record transfer, converge
  to the new optimum over the surviving capacity.

* **Stragglers** — slow instances (noisy neighbors, thermal throttling) break
  tail QoS even in feasible configs.  Mitigation: deadline-triggered hedging
  (predictive re-dispatch) — a query whose queue wait exceeds a p99-derived
  threshold is re-issued to the next-free alternate instance when that copy
  is predicted to finish more than a threshold sooner, and the original is
  cancelled *in queue*.  The cancellation is free by construction: the hedge
  can only fire while the original is still waiting (its service would start
  at free[pick] > arrival + threshold, after the decision instant), so the
  winning copy is the only one that ever occupies an instance and hedging
  never consumes the capacity it is protecting — the tail improves while the
  mean satisfaction rate trades away only marginally.

Counterpart of ``repro/serving/fault.py``, on the port's
:class:`~repro_torch.core.ribbon.RibbonOptimizer`: a recovery's optimizer
runs its GP on the device of the optimizer it replaces.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.ribbon import RibbonOptimizer
from .autoscaler import ScaleEvent
from .instance import InstanceType, ModelProfile
from .workload import Workload


def fail_instances(config, type_index: int, count: int = 1) -> tuple:
    """Pool config after losing `count` instances of one type.

    Losing more than is deployed clamps at zero (a storm can only take what
    is there); a type index outside the pool or a negative count is a caller
    bug and raises instead of silently wrapping / growing the pool.
    """
    cfg = list(int(c) for c in config)
    if not 0 <= type_index < len(cfg):
        raise ValueError(f"type_index {type_index} out of range for a pool "
                         f"with {len(cfg)} instance types")
    if count < 0:
        raise ValueError(f"count must be >= 0, got {count}")
    cfg[type_index] = max(0, cfg[type_index] - count)
    return tuple(cfg)


def continue_search(opt: RibbonOptimizer, evaluate_qos, budget: int) -> int:
    """Drive a (replayed) optimizer for up to `budget` more evaluations;
    returns the number of samples actually spent."""
    n0 = opt.trace.n_samples
    while opt.trace.n_samples - n0 < budget and not opt.done:
        cfg = opt.ask()
        if cfg is None:
            break
        opt.tell(cfg, float(evaluate_qos(cfg)))
    return opt.trace.n_samples - n0


def recover_from_capacity_change(optimizer: RibbonOptimizer, evaluate_qos,
                                 losses: dict, *, budget: int = 40,
                                 kind: str = "cell_failure",
                                 replay: bool = True, policy=None,
                                 ) -> tuple[RibbonOptimizer, ScaleEvent]:
    """Capacity-change recovery (beyond-paper extension of RIBBON).

    ``losses`` maps type index -> instances lost; a correlated event (a
    same-tier preemption storm, a tier outage) shrinks several types in one
    recovery instead of chaining per-type searches.  Unlike a load change,
    the *load is unchanged*, so every measurement of a configuration that
    still fits the reduced capacity remains VALID: recovery builds a new
    optimizer over the reduced search space, replays the still-valid history
    as real observations (``RibbonOptimizer.replay_from`` — no estimation
    needed), then continues the search.  Returns (new_optimizer, event).

    ``replay=False`` switches to *pessimistic* replay instead: when the
    oracle scores candidates from a live queue backlog on a capacity-tier
    plane, the old measurements were taken under strictly milder conditions
    (no backlog, and history scored its pools fully warm while a
    replacement bought now pays tier cold starts), so replaying feasible
    samples as ground truth lets a stale incumbent shadow every
    honestly-scored probe.  Only the infeasible history transfers (as
    flagged estimates — still infeasible under harsher conditions, so its
    dominance pruning and GP mass remain sound), and the actual incumbent
    must re-earn feasibility through the caller's oracle.

    Entries may be negative to model *restored* capacity (a preempted spot
    type restocking): the bounds grow, the whole history replays, and the
    continued search reclaims any cheaper configuration that needed the
    restored instances.  Restock grows *bounds* only — the tier's hazard
    process runs on the absolute episode clock (serving/tiers.TierHazard),
    so restocked capacity re-enters it; nothing here resets it.  ``kind``
    labels the emitted ScaleEvent ("cell_failure", "spot_preemption",
    "recover_storm", "restock", ...).

    Everything after ``losses`` is keyword-only.  ``policy=`` routes the continued search's oracle calls
    (``evaluate_qos(cfg, policy=...)``) and is recorded on the event; a
    joint pool × policy optimizer (``JointSearchSpace``) keeps its policy
    axis through recovery — ``losses`` only ever names pool types.
    """
    from ..core.search_space import JointSearchSpace, SearchSpace

    old_best = optimizer.best_config
    old_cost = optimizer.best_cost
    space = optimizer.space
    new_bounds = list(space.bounds)
    joint_n = getattr(space, "n_policies", 1)
    pool_dims = len(new_bounds) - (1 if joint_n > 1 else 0)
    for t, lost in losses.items():
        if not 0 <= t < pool_dims:
            raise ValueError(f"type_index {t} out of range for a pool with "
                             f"{pool_dims} instance types")
        new_bounds[t] = max(0, new_bounds[t] - int(lost))
    if joint_n > 1:
        new_space = JointSearchSpace(bounds=tuple(new_bounds),
                                     prices=space.prices,
                                     n_policies=joint_n)
    else:
        new_space = SearchSpace(bounds=tuple(new_bounds),
                                prices=space.prices)

    new_opt = RibbonOptimizer(new_space, qos_target=optimizer.qos_target,
                              theta=optimizer.theta,
                              start=tuple(min(b, c) for b, c in
                                          zip(new_bounds, old_best))
                              if old_best else None,
                              cost_penalties=optimizer.cost_penalties,
                              device=optimizer.device)
    new_opt.replay_from(optimizer, pessimistic=not replay)
    if policy is not None:
        base = evaluate_qos

        def evaluate_qos(cfg):
            return base(cfg, policy=policy)

    used = continue_search(new_opt, evaluate_qos, budget)
    best = new_opt.trace.best_feasible()
    event = ScaleEvent(kind=kind, old_best=old_best,
                       old_cost=old_cost,
                       new_best=best.config if best else None,
                       new_cost=best.cost if best else None,
                       samples_used=used,
                       policy=None if policy is None else policy.name)
    return new_opt, event


def recover_from_failure(optimizer: RibbonOptimizer, evaluate_qos, *,
                         failed_type: int, lost: int = 1,
                         budget: int = 40,
                         kind: str = "cell_failure",
                         replay: bool = True,
                         policy=None) -> tuple[RibbonOptimizer,
                                               ScaleEvent]:
    """Single-type convenience wrapper over
    :func:`recover_from_capacity_change` (keyword-only)."""
    return recover_from_capacity_change(optimizer, evaluate_qos,
                                        {failed_type: lost}, budget=budget,
                                        kind=kind, replay=replay,
                                        policy=policy)


def reprice(optimizer: RibbonOptimizer, new_prices, evaluate_qos, *,
            budget: int = 20,
            policy=None) -> tuple[RibbonOptimizer, ScaleEvent]:
    """Price-change response (spot market repricing, scenario engine event).

    QoS measurements are price-independent, so the *entire* real exploration
    record stays valid — only the Eq. 2 objective landscape moved.  Rebuild
    the optimizer over the same bounds with the new prices, replay the full
    history, and let a (usually memo-saturated, near-free) continued search
    re-converge to the new cost optimum.  Returns (new_optimizer, event)
    with costs quoted at the new prices.
    """
    from ..core.search_space import JointSearchSpace, SearchSpace

    old_best = optimizer.best_config
    space = optimizer.space
    prices = tuple(float(p) for p in new_prices)
    joint_n = getattr(space, "n_policies", 1)
    if joint_n > 1:
        # A joint optimizer reprices its pool types; the policy axis stays
        # free whether or not the caller included its zero entry.
        if len(prices) == len(space.bounds) - 1:
            prices = prices + (0.0,)
        new_space = JointSearchSpace(bounds=space.bounds, prices=prices,
                                     n_policies=joint_n)
    else:
        new_space = SearchSpace(bounds=space.bounds, prices=prices)
    new_opt = RibbonOptimizer(new_space, qos_target=optimizer.qos_target,
                              theta=optimizer.theta, start=old_best,
                              cost_penalties=optimizer.cost_penalties,
                              device=optimizer.device)
    new_opt.replay_from(optimizer)
    if policy is not None:
        base = evaluate_qos

        def evaluate_qos(cfg):
            return base(cfg, policy=policy)

    used = continue_search(new_opt, evaluate_qos, budget)
    best = new_opt.trace.best_feasible()
    old_cost = (float(new_space.costs(np.asarray([old_best]))[0])
                if old_best is not None else np.inf)
    event = ScaleEvent(kind="price_change", old_best=old_best,
                       old_cost=old_cost,
                       new_best=best.config if best else None,
                       new_cost=best.cost if best else None,
                       samples_used=used,
                       policy=None if policy is None else policy.name)
    return new_opt, event


# ----------------------------------------------------------- stragglers


@dataclass
class StragglerModel:
    """Multiplies service time of afflicted instances."""
    slow_factor: float = 4.0
    afflicted: tuple = ()      # instance slot indices


def simulate_fcfs_hedged(workload: Workload, types: list[InstanceType],
                         counts, profile: ModelProfile,
                         straggler: StragglerModel | None = None,
                         hedge_threshold: float | None = None):
    """Python FCFS simulation with optional stragglers + hedged requests.

    Returns per-query latencies.  (The simulator's scan covers the fast
    path; this variant exists for fault studies where per-slot behavior
    matters.)"""
    slots = []
    for t_idx, c in enumerate(counts):
        slots += [t_idx] * int(c)
    free = [0.0] * len(slots)
    slow = set(straggler.afflicted) if straggler else set()
    lat = []
    for arr, b in zip(workload.arrivals, workload.batches):
        idle = [i for i, f in enumerate(free) if f <= arr]
        pick = idle[0] if idle else int(np.argmin(free))
        prev_free_pick = free[pick]
        start = max(arr, free[pick])
        svc = float(types[slots[pick]].latency(profile, b))
        if pick in slow:
            svc *= straggler.slow_factor
        finish = start + svc
        free[pick] = finish
        if hedge_threshold is not None and start - arr > hedge_threshold \
                and len(free) > 1:
            others = [i for i in range(len(free)) if i != pick]
            alt = min(others, key=lambda i: free[i])
            alt_start = max(arr, free[alt])
            alt_svc = float(types[slots[alt]].latency(profile, b))
            if alt in slow:
                alt_svc *= straggler.slow_factor
            alt_finish = alt_start + alt_svc
            # Re-dispatch only when the alternate copy is predicted to beat
            # the original by more than the hedge threshold (marginal hedges
            # are pure capacity loss).  The decision happens at
            # arrival + threshold, and the hedge fired because the original
            # would not start before then (start = free[pick] > that
            # instant), so the queued original is cancelled before it ever
            # occupies `pick`; only the winning copy consumes capacity.
            if alt_finish + hedge_threshold < finish:
                free[pick] = prev_free_pick
                free[alt] = alt_finish
                finish = alt_finish
        lat.append(finish - arr)
    return np.asarray(lat)
