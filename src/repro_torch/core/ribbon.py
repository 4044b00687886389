"""RibbonOptimizer — the paper's BO engine as a batched ask/tell loop.

Components wired together as in §4 of the paper:
  * GP surrogate with Matern 5/2 + integer-rounding kernel (gp.py),
  * Eq. 2 two-regime objective (objective.py),
  * EI acquisition over the enumerated lattice (acquisition.py),
  * active pruning ℙ via dominance-down and incumbent-cost rules (pruning.py),
  * load-change warm restart: estimation set 𝕊 with linear QoS rescaling.

``ask_batch(q)`` returns the top-q EI candidates by the constant-liar rule
(acquisition.select_batch); ``ask()`` is the q=1 case.  The blocked mask
(sampled | pruned) lives on the optimizer's ``device`` and every ``tell``
updates it with the prune rules there (pruning.apply_prune_rules); numpy
mirrors (``sampled``, ``PruneSet``) keep the host bookkeeping (init queue,
exhaustion counts, checkpoints).  The incumbent objective is maintained per
``tell``; GP observations are staged on the host and uploaded once per fit.

The optimizer is black-box: it only sees (configuration → measured QoS
satisfaction rate); prices are static metadata.  The evaluation (the live
serving engine, or any QoS oracle) plugs in through ``tell``.  The low-EI
streak that ends a search is updated in ``tell``, keyed to the config the
``ask`` answered, so repeated asks without a tell cannot trip ``done``.

Counterpart of ``repro/core/ribbon.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .acquisition import _NEG, select_batch
from .gp import GaussianProcess
from .objective import ribbon_objective
from .pruning import PruneSet, apply_prune_rules, apply_prune_rules_joint
from .search_space import SearchSpace
from .trace import SearchTrace


class RibbonOptimizer:
    def __init__(self, space: SearchSpace, qos_target: float = 0.99,
                 theta: float = 0.01, start=None, max_obs: int = 192,
                 ei_tol: float = 1e-6, patience: int = 3,
                 cost_aware: bool = False, cost_penalties=None, device=None):
        self.device = resolve_device(device)
        self.space = space
        self.qos_target = float(qos_target)
        self.theta = float(theta)
        self.lattice = space.enumerate()
        # Optional per-type additive cost penalties (capacity-tier risk
        # premiums, as the reference's serving/tiers.py derives): the objective,
        # pruning and incumbent bookkeeping all see the risk-adjusted
        # landscape, while ``space.prices`` keeps the market prices callers
        # use for billing.
        self.cost_penalties = (None if cost_penalties is None
                               else tuple(float(p) for p in cost_penalties))
        self._apply_cost_penalties()
        # Joint pool x policy lattice (core.search_space.JointSearchSpace):
        # the tell rules must keep dominance-down within one policy
        # index.  Mirrors PruneSet._joint so the host and device masks stay
        # bit-identical.
        self._joint_space = getattr(space, "n_policies", 1) > 1
        self.prune = PruneSet(space, costs=self.lattice_costs)
        self.gp = GaussianProcess(space.n_types, space.bounds, max_obs=max_obs,
                                  device=self.device)
        self.sampled = np.zeros(space.size, dtype=bool)
        self.trace = SearchTrace()
        self.best_config: tuple[int, ...] | None = None
        self.best_cost: float = np.inf
        self.best_objective: float = -np.inf
        self._init_queue: list[tuple[int, ...]] = []
        start = tuple(space.bounds) if start is None else tuple(int(v) for v in start)
        self._init_queue.append(start)
        self.ei_tol = ei_tol
        self.patience = patience
        self.cost_aware = cost_aware
        self._low_ei_streak = 0
        self.exhausted = False
        # Device-resident acquisition inputs: the lattice, costs and EI
        # weights are uploaded once; the blocked mask lives on the device and
        # is updated there by the tell rules (never re-uploaded).
        self._lattice_dev = self._to_dev(self.lattice, torch.float32)
        self._costs_dev = self._to_dev(self.lattice_costs, torch.float32)
        if cost_aware:
            weights = 1.0 / np.maximum(self.lattice_costs, 1e-9)
        else:
            weights = np.ones(space.size)
        self._weights_dev = self._to_dev(weights, torch.float32)
        self._blocked_dev = torch.zeros(space.size, dtype=torch.bool,
                                        device=self.device)
        # Incrementally maintained max of Eq. 2 over everything told so far.
        self._best_obs_objective = 0.0
        # config -> masked EI score at selection time; consumed by tell.
        self._pending_ei: dict[tuple[int, ...], float] = {}

    def _to_dev(self, array, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), device=self.device).to(dtype)

    def _apply_cost_penalties(self) -> None:
        """(Re)build the lattice cost vector and the Eq. 2 normalizer from
        ``self.cost_penalties``.  With no penalties this is exactly the
        legacy ``space.costs`` / ``space.max_cost`` pair, bit-identical."""
        self.lattice_costs = self.space.costs(self.lattice)
        if self.cost_penalties is None:
            self._max_cost = self.space.max_cost
            return
        if len(self.cost_penalties) != self.space.n_types:
            raise ValueError(
                f"cost_penalties has {len(self.cost_penalties)} entries for "
                f"{self.space.n_types} instance types")
        if any(p < 0 for p in self.cost_penalties):
            raise ValueError("cost_penalties must be non-negative")
        self.lattice_costs = (self.lattice_costs
                              + self.lattice @ np.asarray(self.cost_penalties))
        # Penalties inflate the most expensive lattice point past
        # space.max_cost; renormalize so feasible objectives stay in
        # [1/2, 1] (objective.py's two-regime split).
        self._max_cost = float(self.lattice_costs.max())

    def _blocked(self) -> torch.Tensor:
        """The device-resident sampled|pruned mask (maintained per tell)."""
        return self._blocked_dev

    def _rebuild_blocked_dev(self) -> None:
        """One-off upload from the host mirrors — only for state restores
        (checkpoint load), never on the tell/ask hot path."""
        self._blocked_dev = self._to_dev(self.sampled | self.prune.mask,
                                         torch.bool)

    # ------------------------------------------------------------------ ask
    def ask(self) -> tuple[int, ...] | None:
        """Next configuration to evaluate (None when the space is exhausted).

        Idempotent until the matching ``tell`` arrives.
        """
        batch = self.ask_batch(1)
        return batch[0] if batch else None

    def ask_batch(self, q: int) -> list[tuple[int, ...]]:
        """Top-q configurations to evaluate next, duplicate-free.

        Drains valid warm-start entries first, then fills the rest with the
        constant-liar EI selection.
        Never returns sampled or pruned lattice points; returns fewer than q
        (possibly zero, setting ``exhausted``) when the open set runs out.
        Idempotent until the matching ``tell``s arrive.
        """
        if q <= 0:
            return []
        out: list[tuple[int, ...]] = []
        i = 0
        while i < len(self._init_queue) and len(out) < q:
            cand = self._init_queue[i]
            idx = self.space.index_of(cand)
            if self.sampled[idx] or self.prune.mask[idx]:
                self._init_queue.pop(i)
                continue
            if cand not in out:
                out.append(cand)
            i += 1

        open_mask = ~(self.sampled | self.prune.mask)
        n_open = int(open_mask.sum()) - len(out)
        need = min(q - len(out), n_open)
        if need > 0:
            x, y, mask = self.gp.buffers()
            blocked = self._blocked()
            if out:
                blocked = blocked.clone()
                blocked[[self.space.index_of(c) for c in out]] = True
            # The constant liar appends q-1 fake rows; clamp to the free GP
            # buffer rows (q=1 never writes a row that survives the trace).
            free_rows = self.gp.max_obs - self.gp.n_obs
            q_eff = min(need, max(free_rows, 1))
            picks, scores, _ = select_batch(
                x, y, mask, self._lattice_dev, self.gp.denom,
                float(self._best_obs_objective), blocked, self._weights_dev,
                q_eff)
            for idx, score in zip(picks.cpu().numpy(), scores.cpu().numpy()):
                if score <= _NEG / 2:   # everything left was blocked
                    break
                cfg = tuple(int(v) for v in self.lattice[int(idx)])
                out.append(cfg)
                self._pending_ei[cfg] = float(score)

        if not out:
            self.exhausted = True
        return out

    # ----------------------------------------------------------------- tell
    def tell(self, config, qos_rate: float, estimated: bool = False) -> None:
        config = tuple(int(v) for v in config)
        if self._init_queue and config == self._init_queue[0]:
            self._init_queue.pop(0)
        idx = self.space.index_of(config)
        cost = float(self.lattice_costs[idx])
        # A Python bool: a numpy rate (np.float64) gives np.bool_, which the
        # device prune rules cannot combine with a mask.
        feasible = bool(qos_rate >= self.qos_target)
        obj = ribbon_objective(qos_rate, cost, self.qos_target, self._max_cost)

        self.sampled[idx] = True
        self.gp.add(np.asarray(config, dtype=np.float32), obj)
        self.trace.record(config, qos_rate, cost, feasible, estimated=estimated)
        self._best_obs_objective = max(self._best_obs_objective, obj)

        # Low-EI streak, keyed to the ask that proposed this config: telling
        # an un-asked config (warm restart, external measurements) leaves the
        # streak alone, and repeated asks without a tell cannot double-count.
        ei = self._pending_ei.pop(config, None)
        if ei is not None:
            if ei <= self.ei_tol:
                self._low_ei_streak += 1
            else:
                self._low_ei_streak = 0

        apply_down = False
        if feasible:
            if obj > self.best_objective:
                self.best_objective = obj
                self.best_config = config
                self.best_cost = cost
            # Cost rule: nothing priced >= the incumbent can beat it.
            self.prune.prune_cost_at_least(self.best_cost)
        elif qos_rate < self.qos_target - self.theta:
            # Dominance rule: the whole down-set of a >θ violator is infeasible.
            self.prune.prune_down_set(config)
            apply_down = True
        # Same two rules on the device: the acquisition's blocked mask is
        # resident state, updated there instead of re-uploaded.
        rules = (apply_prune_rules_joint if self._joint_space
                 else apply_prune_rules)
        self._blocked_dev = rules(
            self._blocked_dev, self._lattice_dev, self._costs_dev,
            idx, self._to_dev(config, torch.float32),
            self._to_dev(self.best_cost if feasible else np.inf,
                         torch.float32),
            apply_down, feasible)

    def best_objective_observed(self) -> float:
        """Max Eq. 2 value over all tells — an O(1) maintained scalar."""
        return self._best_obs_objective

    @property
    def done(self) -> bool:
        return self.exhausted or self._low_ei_streak >= self.patience

    # --------------------------------------------------- load-change restart
    def warm_restart(self, new_qos_of_best: float) -> None:
        """Re-seed the BO for a changed load (paper §4, "RIBBON promptly
        responds to load changes").

        ``new_qos_of_best`` is the *measured* QoS rate of the previous optimal
        configuration under the new load.  We then:
          1. collect 𝕊 = previously-explored configs whose old QoS rate was
             <= the old optimum's old rate (they cannot satisfy the new load);
          2. estimate their new QoS rates by linear rescaling
             (rate_new ≈ rate_old * new_best_rate / old_best_rate);
          3. restart the GP/prune/sampled state and feed the old best (real
             measurement) + 𝕊 (estimates, flagged) as the starting posterior,
             with dominance pruning applied to every >θ violator among them.
        """
        if self.best_config is None:
            raise RuntimeError("warm_restart requires a previous optimum")
        old_best = self.best_config
        old_records = {e.config: e for e in self.trace.evaluations}
        old_best_rate = old_records[old_best].qos_rate
        scale = new_qos_of_best / max(old_best_rate, 1e-9)

        # Strictly-worse only: configs *tied* with the old optimum (e.g. both
        # at 100% satisfaction) may have more capacity than the optimum, so
        # "works as good" is not evidence they fail the new load; the paper's
        # own example uses a strictly lower rate (90% vs 99.9%).
        estimate_set = [
            e for e in self.trace.evaluations
            if e.config != old_best and e.qos_rate < old_best_rate
        ]

        # Reset search state (the objective function changed with the load).
        self.prune = PruneSet(self.space, costs=self.lattice_costs)
        self.gp = GaussianProcess(self.space.n_types, self.space.bounds,
                                  max_obs=self.gp.max_obs, device=self.device)
        self.sampled = np.zeros(self.space.size, dtype=bool)
        self.trace = SearchTrace()
        self.best_config, self.best_cost = None, np.inf
        self.best_objective = -np.inf
        self._init_queue = []
        self._low_ei_streak = 0
        self.exhausted = False
        self._blocked_dev = torch.zeros(self.space.size, dtype=torch.bool,
                                        device=self.device)
        self._best_obs_objective = 0.0
        self._pending_ei = {}

        self.tell(old_best, new_qos_of_best)
        for e in estimate_set:
            est_rate = float(np.clip(e.qos_rate * scale, 0.0, 1.0))
            self.tell(e.config, est_rate, estimated=True)

    def replay_from(self, other: "RibbonOptimizer", *,
                    pessimistic: bool = False) -> int:
        """Transfer still-valid history from another optimizer over the same
        workload: every *real* (non-estimated) evaluation whose config fits
        this space's bounds is replayed as a real observation.

        This is the warm-restart plumbing shared by every event kind whose
        QoS measurements stay valid — capacity loss/restock (the load per
        instance is unchanged; the reference's fault.recover_from_failure) and
        price changes (QoS is price-independent; its fault.reprice).  Load
        changes invalidate the measurements themselves and go through
        ``warm_restart`` estimation instead.  Returns the number of
        evaluations replayed.

        ``pessimistic=True`` replays only the *infeasible* history, flagged
        as estimates: when the new search scores under strictly harsher
        conditions than the history was measured in (a live queue backlog,
        cold starts charged to replacement capacity), evidence that a pool
        failed still holds — its dominance pruning and GP mass transfer —
        but evidence that a pool passed does not, and must not shadow the
        honestly re-scored probes in ``best_feasible`` or cost-prune the
        headroom configurations the harsher conditions demand.
        """
        replayed = 0
        for e in other.trace.evaluations:
            if e.estimated:
                continue
            if pessimistic and e.qos_rate >= other.qos_target:
                continue
            if not all(0 <= c <= b for c, b in zip(e.config,
                                                   self.space.bounds)):
                continue
            if not self.sampled[self.space.index_of(e.config)]:
                self.tell(e.config, e.qos_rate, estimated=pessimistic)
                replayed += 1
        return replayed

    # ------------------------------------------------------------ checkpoint
    def state_dict(self) -> dict:
        return {
            "gp": self.gp.state_dict(),
            "prune": self.prune.state_dict(),
            "sampled": self.sampled.copy(),
            "best_config": None if self.best_config is None else list(self.best_config),
            "best_cost": self.best_cost,
            "best_objective": self.best_objective,
            "qos_target": self.qos_target,
            "theta": self.theta,
            "cost_penalties": (None if self.cost_penalties is None
                               else list(self.cost_penalties)),
            "init_queue": [list(c) for c in self._init_queue],
            "trace": [
                [list(e.config), e.qos_rate, e.cost, e.feasible, e.estimated]
                for e in self.trace.evaluations
            ],
        }

    def load_state_dict(self, state: dict) -> None:
        self.gp.load_state_dict(state["gp"])
        self.prune.load_state_dict(state["prune"])
        self.sampled = np.asarray(state["sampled"], dtype=bool).copy()
        bc = state["best_config"]
        self.best_config = None if bc is None else tuple(int(v) for v in bc)
        self.best_cost = float(state["best_cost"])
        self.best_objective = float(state["best_objective"])
        self.qos_target = float(state["qos_target"])
        self.theta = float(state["theta"])
        cp = state.get("cost_penalties")   # absent in pre-tier checkpoints
        self.cost_penalties = None if cp is None else tuple(float(p) for p in cp)
        self._apply_cost_penalties()
        self.prune.costs = self.lattice_costs
        self._costs_dev = self._to_dev(self.lattice_costs, torch.float32)
        if self.cost_aware:
            self._weights_dev = self._to_dev(
                1.0 / np.maximum(self.lattice_costs, 1e-9), torch.float32)
        self._init_queue = [tuple(int(v) for v in c) for c in state["init_queue"]]
        self.trace = SearchTrace()
        self._rebuild_blocked_dev()
        self._pending_ei = {}
        self._best_obs_objective = 0.0
        for cfg, rate, cost, feas, est in state["trace"]:
            self.trace.record(cfg, rate, cost, feas, estimated=est)
            self._best_obs_objective = max(
                self._best_obs_objective,
                ribbon_objective(rate, cost, self.qos_target,
                                 self._max_cost))


def run_ribbon(space: SearchSpace, evaluate_qos, qos_target: float = 0.99,
               budget: int = 60, start=None, theta: float = 0.01,
               cost_aware: bool = False, batch_q: int = 1,
               evaluate_qos_batch=None, device=None) -> SearchTrace:
    """Convenience runner: drive RibbonOptimizer against a QoS oracle.

    ``batch_q > 1`` asks for constant-liar batches and, when
    ``evaluate_qos_batch(configs) -> rates`` is given, evaluates each batch
    in one call.
    ``budget`` counts evaluations, not iterations.
    """
    opt = RibbonOptimizer(space, qos_target=qos_target, start=start,
                          theta=theta, cost_aware=cost_aware, device=device)
    n = 0
    while n < budget and not opt.done:
        configs = opt.ask_batch(min(batch_q, budget - n))
        if not configs:
            break
        if evaluate_qos_batch is not None and len(configs) > 1:
            rates = np.asarray(evaluate_qos_batch(configs), dtype=np.float64)
        else:
            rates = [float(evaluate_qos(c)) for c in configs]
        for config, rate in zip(configs, rates):
            opt.tell(config, float(rate))
            n += 1
            if opt.done:
                break
    return opt.trace
