"""Elastic scaling: load-change detection → RIBBON warm restart (paper §4,
"RIBBON promptly responds to load changes", and §5.5).

Counterpart of ``repro/serving/autoscaler.py``.  Detection follows the
paper: "when the load goes up, more queries get queued in the query
queue, and the QoS satisfaction rate will drop significantly due to the
wait time.  By monitoring the query queue size and the current QoS rate,
one can determine whether the load has changed."  ``rescale`` then
re-measures the incumbent under the new load, warm-restarts the BO and
searches to the new optimum, sequentially or over the evaluator's grid
lane, cold or warm from the live pool's backlog (``grid_from``), under an
optional routing policy; every candidate is one ``fcfs_scan`` dispatch on
``PoolEvaluator``'s device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.ribbon import RibbonOptimizer


@dataclass
class LoadMonitor:
    qos_target: float = 0.99
    qos_drop_threshold: float = 0.05    # rate drop that signals a shift
    queue_growth_threshold: float = 2.0  # mean queue-depth growth factor
    window: int = 200                    # queries per monitoring window
    _baseline_rate: float | None = field(default=None, init=False)
    _baseline_queue: float | None = field(default=None, init=False)

    @staticmethod
    def window_stats(latencies: np.ndarray, waits: np.ndarray,
                     qos_latency: float) -> tuple[float, float]:
        """(QoS rate, queue depth proxy) of one monitoring window.  The
        depth proxy is the fraction of queries that waited at all — the
        paper's "queries get queued in the query queue" signal."""
        rate = float(np.mean(latencies <= qos_latency))
        depth = float(np.mean(waits > 1e-9))
        return rate, depth

    def observe(self, latencies: np.ndarray, waits: np.ndarray,
                qos_latency: float) -> bool:
        """Feed one window; True when an upward load change is detected."""
        rate, depth = self.window_stats(latencies, waits, qos_latency)
        if self._baseline_rate is None:
            self._baseline_rate, self._baseline_queue = rate, max(depth, 1e-3)
            return False
        rate_drop = self._baseline_rate - rate
        queue_growth = depth / self._baseline_queue
        return (rate_drop > self.qos_drop_threshold
                or (queue_growth > self.queue_growth_threshold
                    and rate < self.qos_target))

    def downshift(self, latencies: np.ndarray, waits: np.ndarray,
                  qos_latency: float) -> bool:
        """True when the window shows sustained slack: QoS at target while
        the queue shrank by the growth threshold against the baseline — the
        mirror image of `observe` that lets an autoscaler release capacity
        on diurnal troughs.  Never trips before a baseline exists, and a
        baseline that never observed a queue (depth at the 1e-3 floor)
        cannot "shrink" — zero-wait steady state is not a down signal.
        Does not move the baseline."""
        if self._baseline_rate is None or self._baseline_queue is None:
            return False
        if self._baseline_queue <= 1e-3:
            return False
        rate, depth = self.window_stats(latencies, waits, qos_latency)
        return (rate >= self.qos_target
                and depth * self.queue_growth_threshold < self._baseline_queue)

    def reset(self):
        self._baseline_rate = None
        self._baseline_queue = None


@dataclass
class ScaleEvent:
    kind: str                 # "load_change" | "cell_failure"
    old_best: tuple
    old_cost: float
    new_best: tuple | None
    new_cost: float | None
    samples_used: int
    # Grid path only: measured QoS rate of the new optimum at every
    # monitored load level {factor: rate} — the autoscaler's robustness view.
    qos_by_load: dict | None = None
    # True when candidates (and qos_by_load) were scored warm — from the
    # live pool's carried backlog — rather than from an idle queue.
    warm_scored: bool = False
    # Name of the routing policy the candidates were scored under
    # (None = legacy FCFS dispatch).
    policy: str | None = None


def rescale(optimizer: RibbonOptimizer, evaluate_qos, *, budget: int = 40,
            kind: str = "load_change", load_factors=None,
            target_index: int = -1, batch_q: int = 8, warm_state=None,
            deployed=None, now=None, warmup=None,
            policy=None) -> ScaleEvent:
    """Respond to a detected change: measure the incumbent on the new load,
    warm-restart the BO with the paper's estimation/pruning transfer, and
    search to the new optimum.

    Two evaluation planes:

    * **Grid path** (``load_factors`` given, ``evaluate_qos`` a
      ``PoolEvaluator``-like object with a ``.grid`` method): the autoscaler-
      in-the-loop search.  Every round asks a constant-liar batch of up to
      ``batch_q`` candidates and evaluates **all of them across all monitored
      load levels in one device dispatch** (``PoolEvaluator.grid`` →
      the grid lane of ``PoolSimulator.qos``); the BO optimizes for
      ``load_factors[target_index]`` (default: the last, i.e. the new load)
      while the other monitored levels ride along in the same dispatch —
      deliberate extra lanes that buy the autoscaler its cross-level view
      (``ScaleEvent.qos_by_load``) and a warm memo for every level should
      the load shift again.  The incumbent's re-measurement under the new
      load is the first grid column.
    * **Legacy path** (``load_factors`` omitted): sequential single-config
      calls of ``evaluate_qos(config)`` — kept for plain-callable oracles
      (fault recovery, tests).

    ``warm_state`` (grid path only, with ``deployed``/``now``) switches
    candidate scoring to the warm lanes: every candidate is evaluated from
    the live pool's carried backlog via ``evaluate_qos.grid_from`` (each
    candidate's initial carry is the remap of the ``deployed`` pool's state
    at episode time ``now``, added slots paying their capacity tier's
    ``warmup`` cold start) instead of from an idle queue — the what-if
    adaptation view.  ``budget`` counts post-restart evaluations at the
    target level either way.

    ``policy=`` (a :class:`~repro_torch.serving.routing.RoutingPolicy`) scores
    every candidate — incumbent, batch and the winner's cross-level column —
    under that dispatch rule instead of legacy FCFS, and is recorded on the
    returned event.  Everything after ``evaluate_qos`` is keyword-only.
    """
    old_best = optimizer.best_config
    old_cost = optimizer.best_cost
    if load_factors is not None:
        warm = warm_state is not None
        needed = "grid_from" if warm else "grid"
        if not hasattr(evaluate_qos, needed):
            raise TypeError("rescale with load_factors needs an evaluator "
                            f"with a .{needed}(configs, load_factors) "
                            "method")
        factors = [float(f) for f in load_factors]

        def sweep(configs):
            if warm:
                return evaluate_qos.grid_from(warm_state, configs, factors,
                                              deployed=deployed, now=now,
                                              warmup=warmup, policy=policy)
            return evaluate_qos.grid(configs, factors, policy=policy)

        incumbent = sweep([old_best])
        optimizer.warm_restart(float(incumbent[target_index, 0]))
        n0 = optimizer.trace.n_samples
        while optimizer.trace.n_samples - n0 < budget and not optimizer.done:
            room = budget - (optimizer.trace.n_samples - n0)
            configs = optimizer.ask_batch(min(batch_q, room))
            if not configs:
                break
            rates = sweep(configs)
            for j, cfg in enumerate(configs):
                optimizer.tell(cfg, float(rates[target_index, j]))
                if (optimizer.trace.n_samples - n0 >= budget
                        or optimizer.done):
                    break
        best = optimizer.trace.best_feasible()
        qos_by_load = None
        if best is not None:
            # Cache hits: the winner was already swept across every level.
            column = sweep([best.config])[:, 0]
            qos_by_load = {f: float(r) for f, r in zip(factors, column)}
        return ScaleEvent(kind=kind, old_best=old_best, old_cost=old_cost,
                          new_best=best.config if best else None,
                          new_cost=best.cost if best else None,
                          samples_used=optimizer.trace.n_samples - n0 + 1,
                          qos_by_load=qos_by_load, warm_scored=warm,
                          policy=None if policy is None else policy.name)

    if policy is not None:
        # Sequential oracles that route (PoolEvaluator.__call__) take the
        # policy per call; plain callables keep their legacy signature.
        base = evaluate_qos

        def evaluate_qos(cfg):
            return base(cfg, policy=policy)

    new_rate = float(evaluate_qos(old_best))
    optimizer.warm_restart(new_rate)
    n0 = optimizer.trace.n_samples
    while optimizer.trace.n_samples - n0 < budget and not optimizer.done:
        cfg = optimizer.ask()
        if cfg is None:
            break
        optimizer.tell(cfg, float(evaluate_qos(cfg)))
    best = optimizer.trace.best_feasible()
    return ScaleEvent(kind=kind, old_best=old_best, old_cost=old_cost,
                      new_best=best.config if best else None,
                      new_cost=best.cost if best else None,
                      samples_used=optimizer.trace.n_samples - n0 + 1,
                      policy=None if policy is None else policy.name)
