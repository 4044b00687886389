"""Structured episode results: windows, events, control actions, phases.

Everything is plain-data and JSON-safe (``EpisodeReport.to_dict`` emits only
finite numbers, strings, lists and nulls).  Counterpart of
``repro/scenario/report.py``, copied so that the port imports nothing of the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class WindowStat:
    """One monitoring window: the unit of QoS accounting and detection."""

    phase: int
    start: int                 # episode-global query index (inclusive)
    end: int                   # episode-global query index (exclusive)
    qos_rate: float
    config: tuple
    price: float               # $/h of the pool during this window
    cost: float                # price x window arrival span, in $
    violation: bool
    # Queue backlog (in-flight busy seconds) carried across the segment's
    # opening control-plane cut, attributed to the segment's first window
    # (0 elsewhere, and everywhere under idle-restart accounting).
    carried_wait: float = 0.0
    # Telemetry enrichment (serving/telemetry.py, spec.window_stats): the
    # window's latency percentiles from the log-bucket histogram, mean
    # utilization per instance type, and per-type QoS-miss attribution.
    # Defaults when the plane has no telemetry source (live plane).
    p50: float = 0.0
    p95: float = 0.0
    p99: float = 0.0
    util_by_type: tuple = ()
    miss_by_type: tuple = ()
    # Drift detection (scenario/planes.SimulatorPlane.infer_dist): which
    # registered batch distribution the window's *measured* service residuals
    # matched, or None when the plane cannot classify.  The engine scores
    # adaptations against this belief, not the spec's phase label.
    dist_est: str | None = None
    # Per-bucket mean waits over the window (bucketed streams only; () when
    # the stream carries no bucket annotation) — what dist-drift detection
    # and the observability plane read instead of trusting the spec's mix.
    bucket_waits: tuple = ()


@dataclass
class EventOutcome:
    """An injected event and how long QoS took to return to target.

    ``recovery_queries`` is the adaptation latency in queries: from the
    event's injection point to the end of the first subsequent window back
    at the QoS target.  ``None`` means the episode ended still in violation.
    """

    kind: str
    phase: int
    at_query: int
    detail: str = ""
    recovery_queries: int | None = None


@dataclass
class ControlAction:
    """One control-plane reaction (rescale / recover / reprice / restock)."""

    kind: str                  # rescale_up|rescale_down|recover_failure|...
    trigger: str               # "monitor" | "event" | "phase_start"
    phase: int
    at_query: int
    old_config: tuple | None
    new_config: tuple | None
    old_price: float
    new_price: float
    bo_evals: int
    recovery_queries: int | None = None
    # Idle-minus-warm QoS of the *incumbent* pool at the searched load
    # level: the optimism idle-restart candidate scoring held about the
    # pool this action replaced at its cut.  None when the action was
    # scored cold (idle-restart accounting, or a plane without the grid
    # lanes).
    warm_idle_delta: float | None = None
    # Routing-policy name in force after this action ; set by
    # "reroute" actions (the router absorbed the shift — same pool, 0 BO
    # evaluations) and carried on later actions scored under that router.
    policy: str | None = None


@dataclass
class PhaseReport:
    name: str
    batch_dist: str
    load_factor: float
    n_queries: int
    qos_rate: float
    cost: float
    n_windows: int
    violation_windows: int


@dataclass
class EpisodeReport:
    """Everything the scenario engine measured over one episode."""

    scenario: str
    plane: str
    qos_target: float
    phases: list[PhaseReport] = field(default_factory=list)
    windows: list[WindowStat] = field(default_factory=list)
    events: list[EventOutcome] = field(default_factory=list)
    actions: list[ControlAction] = field(default_factory=list)
    total_queries: int = 0
    total_cost: float = 0.0
    bo_evals: int = 0
    final_config: tuple = ()
    # Simulator plane only: full-stream QoS of the final config under every
    # phase's conditions, swept in one stacked-table grid dispatch.
    final_qos_by_phase: list[float] | None = None
    # Warm twin: the same sweep with each phase row started from the carry
    # the episode held entering that phase (the states= grid axis).
    final_qos_by_phase_warm: list[float] | None = None

    # ------------------------------------------------------------ summaries
    @property
    def qos_rate(self) -> float:
        """Query-weighted mean QoS satisfaction rate over the episode."""
        total = sum(p.n_queries for p in self.phases)
        if total == 0:
            return 0.0
        return sum(p.qos_rate * p.n_queries for p in self.phases) / total

    @property
    def n_windows(self) -> int:
        return len(self.windows)

    @property
    def violation_windows(self) -> int:
        return sum(1 for w in self.windows if w.violation)

    @property
    def carried_wait_total(self) -> float:
        """Total queue backlog (busy seconds) carried across control-plane
        cuts over the episode — exactly the mass idle-restart segment
        accounting used to drop."""
        return float(sum(w.carried_wait for w in self.windows))

    @property
    def warm_idle_delta_total(self) -> float:
        """Summed |idle − warm| candidate-scoring gap over the control
        actions: how far idle-restart scoring would have mis-estimated the
        QoS of the pools this episode actually chose.  0.0 when every
        action was scored cold (or no action fired)."""
        return float(sum(abs(a.warm_idle_delta) for a in self.actions
                         if a.warm_idle_delta is not None))

    @property
    def recovered_all_events(self) -> bool:
        """True when every injected event's QoS recovered to target."""
        return all(e.recovery_queries is not None for e in self.events)

    def _windows_summary(self) -> dict:
        """Fixed-size digest of the per-window list: counts plus a
        percentile summary of the window QoS rates — what the bench
        artifact keeps instead of a list that grows with episode length."""
        rates = sorted(float(w.qos_rate) for w in self.windows)

        def pctl(p: float) -> float:
            if not rates:
                return 0.0
            k = min(max(int(p / 100.0 * len(rates)), 0), len(rates) - 1)
            return rates[k]

        return {
            "mode": "summary",
            "count": self.n_windows,
            "violations": self.violation_windows,
            "last_violation": (bool(self.windows[-1].violation)
                               if self.windows else False),
            "qos_rate_min": rates[0] if rates else 0.0,
            "qos_rate_p10": pctl(10.0),
            "qos_rate_p50": pctl(50.0),
            "qos_rate_p90": pctl(90.0),
            "qos_rate_max": rates[-1] if rates else 0.0,
            "carried_wait_total": float(self.carried_wait_total),
        }

    def to_dict(self, windows: str = "full") -> dict:
        """JSON-safe dump.  ``windows="summary"`` replaces the per-window
        list (which grows linearly with episode length) with the fixed-size
        digest of :meth:`_windows_summary`; ``"full"`` keeps the list."""
        if windows not in ("full", "summary"):
            raise ValueError(f'windows must be "full" or "summary", '
                             f"got {windows!r}")
        return {
            "scenario": self.scenario,
            "plane": self.plane,
            "qos_target": float(self.qos_target),
            "qos_rate": float(self.qos_rate),
            "total_queries": int(self.total_queries),
            "total_cost": float(self.total_cost),
            "bo_evals": int(self.bo_evals),
            "final_config": [int(c) for c in self.final_config],
            "final_qos_by_phase": (
                None if self.final_qos_by_phase is None
                else [float(r) for r in self.final_qos_by_phase]),
            "final_qos_by_phase_warm": (
                None if self.final_qos_by_phase_warm is None
                else [float(r) for r in self.final_qos_by_phase_warm]),
            "n_windows": self.n_windows,
            "violation_windows": self.violation_windows,
            "carried_wait_total": float(self.carried_wait_total),
            "warm_idle_delta_total": float(self.warm_idle_delta_total),
            "n_events": len(self.events),
            "recovered_all_events": bool(self.recovered_all_events),
            "phases": [{
                "name": p.name, "batch_dist": p.batch_dist,
                "load_factor": float(p.load_factor),
                "n_queries": int(p.n_queries),
                "qos_rate": float(p.qos_rate), "cost": float(p.cost),
                "n_windows": int(p.n_windows),
                "violation_windows": int(p.violation_windows),
            } for p in self.phases],
            "events": [{
                "kind": e.kind, "phase": int(e.phase),
                "at_query": int(e.at_query), "detail": e.detail,
                "recovery_queries": (None if e.recovery_queries is None
                                     else int(e.recovery_queries)),
            } for e in self.events],
            "actions": [{
                "kind": a.kind, "trigger": a.trigger, "phase": int(a.phase),
                "at_query": int(a.at_query),
                "old_config": (None if a.old_config is None
                               else [int(c) for c in a.old_config]),
                "new_config": (None if a.new_config is None
                               else [int(c) for c in a.new_config]),
                "old_price": float(a.old_price),
                "new_price": float(a.new_price),
                "bo_evals": int(a.bo_evals),
                "recovery_queries": (None if a.recovery_queries is None
                                     else int(a.recovery_queries)),
                "warm_idle_delta": (None if a.warm_idle_delta is None
                                    else float(a.warm_idle_delta)),
                "policy": a.policy,
            } for a in self.actions],
            "windows": self._windows_summary() if windows == "summary"
            else [{
                "phase": int(w.phase), "start": int(w.start),
                "end": int(w.end), "qos_rate": float(w.qos_rate),
                "config": [int(c) for c in w.config],
                "price": float(w.price), "cost": float(w.cost),
                "violation": bool(w.violation),
                "carried_wait": float(w.carried_wait),
                "p50": float(w.p50), "p95": float(w.p95),
                "p99": float(w.p99),
                "util_by_type": [float(u) for u in w.util_by_type],
                "miss_by_type": [int(m) for m in w.miss_by_type],
            } for w in self.windows],
        }
