"""Scenario engine: compiles a ScenarioSpec into the detection → adaptation
event loop over an evaluation plane.

The episode advances in *queries* over a **continuous-time clock**: each
phase's stream is cut into segments at control-plane moments (injected
events, monitor detections, provisioning switches), and every segment is
served **warm** from the pool state the previous segment left behind — the
plane threads per-slot next-free times (plus a clock offset mapping each
phase's local time into episode time) across cuts, reconfigurations
(surviving instances keep their in-flight work, removed slots drop it,
added slots start idle after any provisioning delay), and phase boundaries.
Queue backlog therefore *survives* a control-plane cut instead of being
silently dropped: the violation windows RIBBON's load monitor exists to
catch ("more queries get queued in the query queue", paper §5) stay visible
while the new pool drains them, and adaptation latency is measured against
that warmed pool.  Each window's share of backlog that crossed its
segment's opening cut is reported as ``WindowStat.carried_wait``.

A constant no-event episode is a single segment from the idle carry at
clock 0, which reproduces the single-config ``PoolSimulator.qos`` lane bit
for bit — the same
whole-stream accounting every QoS path in this repo uses.  Passing
``carry_queue_state=False`` restores the legacy idle-restart accounting
(every segment from a drained pool); the scenario bench runs both and
reports the violation mass the idle restarts were hiding.  Fixed-size
windows inside a segment feed the :class:`LoadMonitor` and the report
either way.

Segments are measured speculatively: when an adaptation fires mid-segment,
the engine rewinds to the cut and asks the plane to ``commit`` only the
queries actually consumed, so the carried state never includes rolled-back
serving.  The commit happens *before* the adaptation search runs, because
the search itself is warm: every candidate pool is scored from the pool
state at the cut (``plane.candidate_state()`` → the batched
``PoolEvaluator.grid_from`` lanes on the simulator plane, measured
``initial_busy`` probe serves on the live plane) — what-if adaptation
under the current queue, not from an idle restart.  Each resulting control
action records ``warm_idle_delta``, the QoS optimism idle scoring would
have baked into that decision, and the bounds over-provision fallback now
fires only when even warm-scored candidates come back infeasible.

Control policy per event kind:

  * **load changes** (phase boundaries, ``load_spike`` events) are *not*
    told to the control plane — the monitor must detect them from the
    served windows.  The engine then estimates the new load factor from the
    window's arrival span (x a small provisioning headroom), and rescales:
    on a grid-capable plane via the autoscaler's joint (load x config)
    sweep, else via the sequential legacy path.  A monitor-independent
    guard forces adaptation after ``forced_patience`` consecutive windows
    more than ``forced_slack`` below target, so a mis-set baseline can
    never wedge the loop in violation.
  * **capacity events** (``cell_failure``, ``spot_preemption``) reach the
    control plane directly (cloud providers signal both); recovery replays
    the still-valid history into a reduced space
    (``recover_from_capacity_change``).  Preempted capacity is restocked
    at the next phase boundary through the same plumbing with negative
    loss.
  * **tier-scoped capacity events** (``preemption_storm``,
    ``tier_outage``) kill capacity on *every* type procured on one
    capacity tier at once (the correlated-failure surface
    serving/tiers.py models) — one multi-type recovery over the jointly
    reduced space.  When even warm-scored candidates come back infeasible
    (the spot tier just evaporated mid-search), the engine degrades
    gracefully to the surviving tiers' full bounds — on-demand
    over-provisioning — instead of wedging in violation; the market
    restocks the tier at the next phase boundary, which *re-enters* the
    tier's absolute-clock hazard process rather than resetting it.
  * **price changes** (per-type ``price_change``, tier-wide
    ``price_spike``) rebuild the optimizer over the same bounds with new
    prices (``reprice``): QoS history replays wholesale, so the search is
    usually memo-saturated and costs no new measurements.

Every event kind in ``spec.EVENT_KIND_SPECS`` must have a handler in
``ScenarioEngine._EVENT_HANDLERS`` — checked at import time, so a kind
added to the registry without engine wiring fails loudly instead of being
silently skipped.  On a tiered plane the engine also prices risk into the
search (the plane's ``cost_penalties`` premium per type) and charges added
slots their tier's cold start (``cold_starts``) in every warm what-if
sweep.

Re-optimization is instantaneous in episode time — its price is reported as
BO evaluations (the paper's exploration cost), while *adaptation latency*
is reported in queries: from an event's injection to the end of the first
subsequent window back at the QoS target.

Counterpart of ``repro/scenario/engine.py``, on the port's optimizer,
autoscaler and fault handling.  The engine's optimizers run their GP on
``device`` (default ``cuda``), independently of the plane's simulators.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from ..core.ribbon import RibbonOptimizer
from ..core.search_space import SearchSpace
from ..device import resolve_device
from ..serving.autoscaler import LoadMonitor, rescale
from ..serving.fault import (continue_search,
                             recover_from_capacity_change,
                             recover_from_failure, reprice)
from ..serving.routing import RoutingPolicy, named_policy
from .planes import slice_stream
from .report import (ControlAction, EpisodeReport, EventOutcome, PhaseReport,
                     WindowStat)
from .spec import EVENT_KINDS, EventSpec, ScenarioSpec, Timeline
from .trace import TID_EVENTS, TID_PHASES, TID_WINDOWS, TraceRecorder


def _near_seed_candidates(seed: tuple, bounds, exclude: tuple,
                          radius: int = 2) -> list[tuple]:
    """Pool configs in a bounded Hamming ball around ``seed``: every
    per-type count shifted by -1/0/+1 with at most ``radius`` total moves,
    clipped to ``[0, bounds]`` and with the current pool (``exclude``)
    dropped.  Seed-first ordering (the all-zero delta is the first tuple
    ``itertools.product`` yields), so a price tie resolves toward the exact
    pre-storm pool."""
    out = []
    for delta in itertools.product((0, -1, 1), repeat=len(seed)):
        if sum(abs(d) for d in delta) > radius:
            continue
        cand = tuple(int(c) + d for c, d in zip(seed, delta))
        if cand == exclude:
            continue
        if all(0 <= c <= int(b) for c, b in zip(cand, bounds)):
            out.append(cand)
    return out


class ScenarioEngine:
    """Drives one episode over one plane.  Single-shot: build, ``run()``."""

    def __init__(self, spec: ScenarioSpec, plane, space: SearchSpace,
                 monitor: LoadMonitor | None = None, start=None,
                 allow_downscale: bool = True, forced_slack: float = 0.03,
                 forced_patience: int = 2, down_patience: int = 2,
                 max_adapts_per_phase: int = 4,
                 carry_queue_state: bool = True,
                 warm_candidate_scoring: bool | None = None,
                 trace: TraceRecorder | None = None, device=None):
        self.device = resolve_device(device)
        self.spec = spec.validate()
        self.plane = plane
        self.space = space
        # Control-plane trace export (scenario/trace.py): when set, run()
        # records phases, windows, events, searches and deploys as Chrome
        # trace events.  Pure observability — nothing reads it back.
        self.trace = trace
        self.monitor = monitor or LoadMonitor(qos_target=spec.qos_target)
        self.start = start
        self.allow_downscale = allow_downscale
        # False = legacy idle-restart segment accounting (the bench's
        # baseline mode): every segment served from a drained pool.
        self.carry_queue_state = bool(carry_queue_state)
        # Whether adaptation searches score candidates from the carried
        # backlog (warm lanes) or from idle.  Default: follow the
        # accounting mode.  Forcing False on a carried run isolates the
        # accounting change — the comparison where both control
        # trajectories score identically and the carried clock can only
        # surface violations (the invariant the fuzz harness checks on
        # matched-scoring runs).
        self.warm_scoring = (self.carry_queue_state
                             if warm_candidate_scoring is None
                             else bool(warm_candidate_scoring))
        self.forced_slack = float(forced_slack)
        self.forced_patience = int(forced_patience)
        # One slack window is Poisson noise; sustained slack is a trough.
        self.down_patience = int(down_patience)
        self.max_adapts_per_phase = int(max_adapts_per_phase)
        self._factors: list[float] = []
        # In-flight provisioning: (global query index, config) — the pool a
        # capacity-event recovery booked, taking effect provision_queries
        # after the event (spec.provision_queries > 0).
        self._pending_switch: tuple[int, tuple] | None = None
        # Second stage of a restock trim (tiered planes): the cheap steady
        # pool to drop back to once the union stage's added slots are warm.
        self._pending_trim: tuple | None = None
        # Tiered-plane surface (None/absent on legacy planes): per-type risk
        # premium folded into every BO cost objective, and per-type cold
        # start charged to slots added in warm what-if sweeps.
        self._cost_penalties = getattr(plane, "cost_penalties", None)
        self._cold_starts = getattr(plane, "cold_starts", None)
        # Warm-up grace (global query index, tiered planes only): monitor
        # triggers hold off until freshly added capacity has lived through
        # its cold start plus one full judging window — otherwise every
        # wake shows up as a violation and the monitor buys yet more cold
        # slots on top of the ones already warming.
        self._grace_until = 0
        # The steady pool that was serving when transient capacity loss
        # first struck (tiered planes): re-seeded into the restock search
        # as an honestly re-scored candidate, so the portfolio can return
        # to its cheap pre-storm mix instead of staying on the panic pool.
        self._pre_loss_config = None
        # The routing policy currently dispatching queries (None = FCFS).
        # Set by a successful reroute (spec.route_policies): the engine
        # then serves, scores and searches under that dispatch rule.
        self._route_policy = None
        # Measured drift belief: which registered batch distribution the
        # plane's window classifier (``infer_dist``) last matched this
        # phase, or None.  Adaptation searches score against this belief,
        # not the spec's phase label — a mislabeled spec still recovers.
        # Reset at each phase boundary so the belief never crosses a label
        # change (correctly-labeled episodes behave bit-identically: every
        # in-phase adaptation runs after at least one window has confirmed
        # the label).
        self._dist_belief: str | None = None

    def _cold_horizon(self, old_config, new_config,
                      factor: float) -> int | None:
        """Queries until the slots this deploy *adds* have lived through
        their cold starts; ``None`` when nothing was added (removals serve
        warm immediately) or the plane has no tiers."""
        if self._cold_starts is None or old_config is None:
            return None
        added = [t for t, (o, c) in enumerate(zip(old_config, new_config))
                 if int(c) > int(o)]
        if not added:
            return None
        cold = max(float(self._cold_starts[t]) for t in added)
        qps = float(self.plane.base_rate) * max(float(factor), 0.05)
        return int(np.ceil(cold * qps))

    def _note_deploy(self, old_config, new_config, at_query: int,
                     factor: float) -> None:
        """Start the warm-up grace clock after a deploy that *adds* slots
        on a tiered plane: cold start plus one full judging window."""
        horizon = self._cold_horizon(old_config, new_config, factor)
        if horizon is None:
            return
        self._grace_until = max(self._grace_until,
                                int(at_query) + horizon + self.spec.window)

    # ------------------------------------------------------------- searches
    def _candidate_state(self):
        """The plane's what-if (state, deployed) pair when warm candidate
        scoring is on and the plane carries one, else ``None`` (cold)."""
        if not self.warm_scoring:
            return None
        return self.plane.candidate_state()

    def _land_pending(self, config, at_query: int, factor: float):
        """Deploy the booked in-flight switch.  When it was the union stage
        of a restock trim (old slots + the cheap steady pool's slots side
        by side, so the additions wake cold while the old pool still
        serves), book the removal stage for as soon as the additions are
        warm — dropping slots never dips, so it needs no judging window."""
        prev_cfg = config
        config = self._pending_switch[1]
        self._pending_switch = None
        self.plane.deploy(config)
        self._note_deploy(prev_cfg, config, at_query, factor)
        if self._pending_trim is not None:
            trim = tuple(int(c) for c in self._pending_trim)
            self._pending_trim = None
            if trim != tuple(config):
                horizon = self._cold_horizon(prev_cfg, config, factor) or 0
                self._pending_switch = (at_query + horizon + 1, trim)
        self.monitor.reset()
        return config

    def _search_oracle(self, dist: str, factor: float):
        """Sequential QoS oracle for the recovery/reprice searches: scores
        hypothetical deployments from the live backlog when warm scoring
        is on (``warm_oracle`` itself falls back to cold when the plane
        has nothing to carry), else cold from idle.  Either way the probe
        dispatches under the routing policy currently in force."""
        if self.warm_scoring:
            return self.plane.warm_oracle(dist, factor,
                                          policy=self._route_policy)
        return self.plane.oracle(dist, factor, policy=self._route_policy)

    def _scoring_dist(self, phase) -> str:
        """The batch distribution adaptation searches score against: the
        measured belief when the plane's drift classifier holds one for the
        current phase, else the spec's label.  Serving always follows the
        spec's label (that is the physical traffic); only the *scoring* of
        hypothetical pools trusts measurements over labels."""
        return self._dist_belief or phase.batch_dist

    def _drive(self, opt: RibbonOptimizer, dist: str, factor: float,
               budget: int) -> int:
        """Ask/tell `opt` against the plane at one load level; returns the
        number of evaluations spent.  Uses the grid evaluator's batched
        dispatch when the plane has one — the warm candidate lanes when a
        backlog is carried, so every probe is scored under the current
        queue instead of from idle."""
        ev = self.plane.grid_evaluator(dist)
        if ev is None:
            return continue_search(opt, self._search_oracle(dist, factor),
                                   budget)
        cs = self._candidate_state()

        def sweep(cfgs):
            if cs is None:
                return ev.grid(cfgs, [factor], policy=self._route_policy)
            return ev.grid_from(cs[0], cfgs, [factor], deployed=cs[1],
                                warmup=self._cold_starts,
                                policy=self._route_policy)

        n0 = opt.trace.n_samples
        while opt.trace.n_samples - n0 < budget and not opt.done:
            room = budget - (opt.trace.n_samples - n0)
            cfgs = opt.ask_batch(min(self.spec.batch_q, room))
            if not cfgs:
                break
            rates = sweep(cfgs)
            for j, cfg in enumerate(cfgs):
                opt.tell(cfg, float(rates[0, j]))
                if opt.trace.n_samples - n0 >= budget or opt.done:
                    break
        return opt.trace.n_samples - n0

    def _score_delta(self, dist: str, factor: float, cfg):
        """Idle-minus-warm QoS of an action's *incumbent* pool at the
        searched load level — the optimism idle-restart candidate scoring
        held about the pool being replaced at this cut (a big replacement
        pool often drains the backlog invisibly, but the incumbent is the
        one drowning in it).  ``None`` when the plane scores cold or has no
        grid lanes (the live plane's measured probes)."""
        cs = self._candidate_state()
        ev = self.plane.grid_evaluator(dist)
        if cs is None or ev is None or cfg is None:
            return None
        warm = float(ev.grid_from(cs[0], [cfg], [factor], deployed=cs[1],
                                  warmup=self._cold_starts,
                                  policy=self._route_policy)[0, 0])
        idle = float(ev.grid([cfg], [factor],
                             policy=self._route_policy)[0, 0])
        return idle - warm

    def _fallback_helps(self, dist: str, factor: float, incumbent,
                        candidate) -> bool:
        """Whether the over-provision fallback actually out-serves the
        incumbent pool *under the live backlog and tier cold starts* (both
        scored through the warm lanes).  ``True`` when the plane cannot
        score warm — without evidence the legacy over-provision convention
        stands."""
        cs = self._candidate_state()
        ev = self.plane.grid_evaluator(dist)
        if cs is None or ev is None:
            return True
        rates = ev.grid_from(cs[0], [tuple(incumbent), tuple(candidate)],
                             [factor], deployed=cs[1],
                             warmup=self._cold_starts,
                             policy=self._route_policy)
        return float(rates[0, 1]) > float(rates[0, 0])

    def _initial_search(self, bounds, prices, dist: str,
                        factor: float) -> tuple[RibbonOptimizer, int]:
        space = SearchSpace(bounds=tuple(bounds), prices=tuple(prices))
        opt = RibbonOptimizer(space, qos_target=self.spec.qos_target,
                              start=self.start,
                              cost_penalties=self._cost_penalties,
                              device=self.device)
        used = self._drive(opt, dist, factor, self.spec.init_budget)
        return opt, used

    @staticmethod
    def _pick_config(opt: RibbonOptimizer, bounds) -> tuple[int, ...]:
        best = opt.trace.best_feasible()
        if best is not None:
            return tuple(int(c) for c in best.config)
        return tuple(int(b) for b in bounds)    # over-provision, stay honest

    def _estimate_factor(self, seg_arrivals, lo: int, hi: int,
                         fallback: float) -> float:
        """Load factor estimate from a window's observed arrival rate —
        the engine never reads the spec's factors for control decisions."""
        n = hi - lo
        if n < 2:
            return fallback
        span = float(seg_arrivals[hi - 1] - seg_arrivals[lo])
        if span <= 0:
            return fallback
        qps = (n - 1) / span
        est = qps / float(self.plane.base_rate)
        return float(np.clip(est, 0.05, 20.0))

    def _adapt_load(self, opt: RibbonOptimizer, dist: str,
                    factor_est: float, kind: str):
        """Monitor-triggered re-optimization at an estimated load level."""
        if kind == "rescale_down" or opt.best_config is None:
            # Fresh bounded search.  Down-shifts cannot use the paper's
            # warm-restart transfer: its linear rescaling models loads going
            # *up* (rates only degrade), so it would replay the cheap
            # previously-violating configs as still-violating samples —
            # exactly the configurations a downscale must rediscover.  The
            # incumbent seeds the start point; the memoized evaluator makes
            # re-visits at known levels cheap.
            start = opt.best_config or tuple(opt.space.bounds)
            fresh = RibbonOptimizer(opt.space,
                                    qos_target=self.spec.qos_target,
                                    start=start,
                                    cost_penalties=opt.cost_penalties,
                                    device=self.device)
            used = self._drive(fresh, dist, factor_est,
                               self.spec.rescale_budget)
            best = fresh.trace.best_feasible()
            return fresh, (best.config if best else None), used
        ev = self.plane.grid_evaluator(dist)
        if ev is not None:
            factors = [f for f in self._factors[-3:]
                       if abs(f - factor_est) > 1e-9] + [factor_est]
            cs = self._candidate_state()
            event = rescale(opt, ev, budget=self.spec.rescale_budget,
                            kind=kind, load_factors=factors,
                            batch_q=self.spec.batch_q,
                            warm_state=cs[0] if cs else None,
                            deployed=cs[1] if cs else None,
                            warmup=self._cold_starts,
                            policy=self._route_policy)
        else:
            event = rescale(opt, self._search_oracle(dist, factor_est),
                            budget=self.spec.rescale_budget, kind=kind)
            # The sequential path cannot see inside its oracle; label the
            # scoring mode the engine actually wired up.
            event.warm_scored = self._candidate_state() is not None
        self._factors.append(factor_est)
        return opt, event.new_best, event.samples_used

    def _try_reroute(self, dist: str, factor_est: float, config, prices,
                     p: int, at_q: int, report, pending) -> bool:
        """Absorb an upshift with the *router* before touching the pool:
        warm-sweep the current config under every candidate policy
        (``spec.route_policies``) in one stacked-policy dispatch and, if
        some dispatch rule restores QoS at the estimated level, switch to
        it — same capacity, zero BO evaluations, no provisioning delay.
        Returns True when a reroute was adopted (the rescale is skipped).
        """
        if not self.spec.route_policies:
            return False
        ev = self.plane.grid_evaluator(dist)
        if ev is None:
            return False          # no routed kernels on the live plane
        cands = [(name, named_policy(name, prices))
                 for name in self.spec.route_policies]
        stacked = RoutingPolicy.stack([pol for _, pol in cands])
        cfg = [tuple(int(c) for c in config)]
        cs = self._candidate_state()
        if cs is not None:
            rates = ev.sim.qos(cfg, workloads=[factor_est], state=cs[0],
                               deployed=cs[1], warmup=self._cold_starts,
                               policy=stacked).rates       # (1, P, 1)
        else:
            rates = ev.sim.qos(cfg, workloads=[factor_est],
                               policy=stacked).rates
        rates = np.asarray(rates, dtype=np.float64).reshape(len(cands))
        feasible = rates >= self.spec.qos_target
        if not feasible.any():
            return False
        best = int(np.argmax(np.where(feasible, rates, -np.inf)))
        name, pol = cands[best]
        current = getattr(self._route_policy, "name", None)
        if name == current:
            return False          # already routing this way; really rescale
        self._route_policy = pol
        price = float(np.dot(prices, config))
        action = ControlAction(
            kind="reroute", trigger="monitor", phase=p, at_query=at_q,
            old_config=tuple(int(c) for c in config),
            new_config=tuple(int(c) for c in config),
            old_price=price, new_price=price, bo_evals=0,
            warm_idle_delta=None, policy=name)
        report.actions.append(action)
        pending.append(action)
        return True

    # ------------------------------------------------------------------ run
    def run(self) -> EpisodeReport:
        spec, plane = self.spec, self.plane
        timeline = Timeline.compile(spec)
        qos_lat = plane.qos_latency
        report = EpisodeReport(scenario=spec.name, plane=plane.name,
                               qos_target=spec.qos_target)
        bounds = list(self.space.bounds)
        prices = [float(p) for p in self.space.prices]
        restock_next: dict[int, int] = {}   # type -> count back next phase

        dist0 = spec.phases[0].batch_dist
        f0 = spec.phases[0].load_factor
        self._factors = [f0]
        self._total_queries = sum(ph.n_queries for ph in spec.phases)
        self._route_policy = None
        plane.begin_episode(carry=self.carry_queue_state)
        trace = self.trace
        # Episode time of the current stream's local t=0: phase boundaries
        # advance it by the finished stream's span, a load spike's stream
        # rebuild by the re-anchor delta — the same continuity the planes'
        # advance_clock keeps for the carried pool state.
        ep_base = 0.0
        t0 = time.perf_counter()
        opt, used = self._initial_search(bounds, prices, dist0, f0)
        if trace is not None:
            trace.span("search:initial", 0.0, time.perf_counter() - t0,
                       args={"bo_evals": int(used),
                             "wall_ms": (time.perf_counter() - t0) * 1e3})
        report.bo_evals += used
        config = self._pick_config(opt, bounds)
        plane.deploy(config)
        if trace is not None:
            trace.instant("deploy", 0.0,
                          args={"config": [int(c) for c in config]})
        self.monitor.reset()
        pending: list = []                  # open recovery trackers
        gq = 0                              # global index of phase start
        phase_states: list = []             # entry carry per phase (or None)

        for p, phase in enumerate(spec.phases):
            if self._pending_switch and self._pending_switch[0] <= gq:
                config = self._land_pending(config, gq, phase.load_factor)
            if restock_next:
                t0 = time.perf_counter()
                config, opt = self._restock(restock_next, p, gq, phase,
                                            bounds, prices, config, opt,
                                            report, pending)
                if trace is not None:
                    wall = time.perf_counter() - t0
                    trace.span("search:restock", ep_base, wall,
                               args={"wall_ms": wall * 1e3,
                                     "config": [int(c) for c in config]})
                restock_next = {}
            factor = phase.load_factor
            events = list(timeline.cuts[p])
            stream = plane.phase_stream(phase.batch_dist, phase.n_queries,
                                        factor)
            # The carry the episode holds entering this phase, for the
            # warm final sweep (None while cold / before the first deploy).
            phase_states.append(plane.candidate_state())
            ph_t0 = ep_base
            self._dist_belief = None     # beliefs never cross a phase cut
            i = 0
            ph_passed = 0
            ph_cost = 0.0
            ph_windows = 0
            ph_viol = 0
            bad_streak = 0
            down_streak = 0
            down_blocked = False     # hysteresis: no-op downscales stop
            adapts = 0
            while i < phase.n_queries:
                while events and events[0][0] <= i:
                    pos, ev_spec = events.pop(0)
                    prev_cfg = config
                    ev_at = ep_base + float(
                        stream.arrivals[min(pos, phase.n_queries - 1)])
                    t0 = time.perf_counter()
                    config, opt, factor = self._apply_event(
                        ev_spec, p, gq + pos, phase, factor, bounds, prices,
                        config, opt, restock_next, report, pending)
                    if trace is not None:
                        wall = time.perf_counter() - t0
                        trace.instant(f"event:{ev_spec.kind}", ev_at,
                                      tid=TID_EVENTS,
                                      args={"detail":
                                            report.events[-1].detail})
                        trace.span(f"handle:{ev_spec.kind}", ev_at, wall,
                                   args={"wall_ms": wall * 1e3,
                                         "config":
                                         [int(c) for c in config]})
                    self._note_deploy(prev_cfg, config, gq + pos, factor)
                    if ev_spec.kind == "load_spike":
                        new_stream = plane.phase_stream(phase.batch_dist,
                                                        phase.n_queries,
                                                        factor)
                        # Re-anchor the episode clock: the next unserved
                        # query keeps its episode arrival time across the
                        # recompression, so carried backlog durations
                        # survive the stream rebuild.
                        k = min(i, phase.n_queries - 1)
                        delta = (float(stream.arrivals[k])
                                 - float(new_stream.arrivals[k]))
                        plane.advance_clock(delta)
                        ep_base += delta
                        stream = new_stream
                    plane.deploy(config)
                    if trace is not None:
                        trace.instant("deploy", ev_at,
                                      args={"config":
                                            [int(c) for c in config]})
                    self.monitor.reset()
                    down_blocked = False    # the regime changed
                if (self._pending_switch
                        and self._pending_switch[0] - gq <= i):
                    config = self._land_pending(config, gq + i, factor)
                cut = events[0][0] if events else phase.n_queries
                if self._pending_switch:
                    cut = min(cut, self._pending_switch[0] - gq)
                seg = slice_stream(stream, i, cut)
                lat, waits = plane.measure(phase.batch_dist, seg, config,
                                           policy=self._route_policy)
                carried = plane.last_carried_wait
                consumed = len(lat)
                redeploy = False
                w = 0
                while w < len(lat):
                    w_hi = min(w + spec.window, len(lat))
                    wlat, wwaits = lat[w:w_hi], waits[w:w_hi]
                    # Update the measured drift belief *before* this
                    # window's adaptation check: the classifier reads only
                    # the window's own latencies/waits, never the spec, so
                    # a mislabeled phase is caught the moment it is served.
                    infer = getattr(plane, "infer_dist", None)
                    est_dist = None
                    if infer is not None:
                        est_dist = infer(i + w, wlat, wwaits, config)
                        if est_dist is not None:
                            self._dist_belief = est_dist
                    passed = int(np.sum(wlat <= qos_lat))
                    rate = passed / (w_hi - w)
                    price = float(np.dot(prices, config))
                    span = float(seg.arrivals[w_hi - 1] - seg.arrivals[w])
                    g_end = gq + i + w_hi
                    viol = rate < spec.qos_target
                    wstat = WindowStat(
                        phase=p, start=gq + i + w, end=g_end, qos_rate=rate,
                        config=config, price=price,
                        cost=price * span / 3600.0, violation=viol,
                        carried_wait=carried if w == 0 else 0.0,
                        dist_est=est_dist)
                    segb = getattr(plane, "segment_buckets", None)
                    if segb is not None:
                        wstat.bucket_waits = segb(w, w_hi, wwaits)
                    if spec.window_stats:
                        tel = plane.window_telemetry(w, w_hi)
                        if tel is not None:
                            wstat.p50 = tel.latency_percentile(50.0)
                            wstat.p95 = tel.latency_percentile(95.0)
                            wstat.p99 = tel.latency_percentile(99.0)
                            wstat.util_by_type = tuple(
                                float(u)
                                for u in tel.utilization(config, span))
                            wstat.miss_by_type = tuple(
                                int(m) for m in tel.miss)
                    report.windows.append(wstat)
                    if trace is not None:
                        w_at = ep_base + float(seg.arrivals[w])
                        trace.span("window", w_at, span, tid=TID_WINDOWS,
                                   args={"qos_rate": rate,
                                         "violation": viol,
                                         "p99": float(wstat.p99)})
                        trace.counter("qos_rate", w_at, {"rate": rate})
                    ph_passed += passed
                    ph_cost += price * span / 3600.0
                    ph_windows += 1
                    ph_viol += int(viol)
                    if not viol:
                        for rec in pending:
                            rec.recovery_queries = g_end - rec.at_query
                        pending.clear()
                        bad_streak = 0
                    else:
                        bad_streak += 1
                    up = self.monitor.observe(wlat, wwaits, qos_lat)
                    forced = (bad_streak >= self.forced_patience
                              and rate < spec.qos_target - self.forced_slack)
                    down_streak = (down_streak + 1
                                   if (not viol and self.allow_downscale
                                       and self.monitor.downshift(
                                           wlat, wwaits, qos_lat))
                                   else 0)
                    down = (down_streak >= self.down_patience
                            and not down_blocked)
                    # On tiered planes, two hold-offs suppress monitor
                    # triggers (forced ones included).  An in-flight
                    # provisioning booking: the control plane already
                    # acted and the replacement capacity is already
                    # arriving, so a second search at the same cut would
                    # only discard the booked pool to re-buy capacity
                    # that wakes cold anyway.  And the warm-up grace
                    # window after a deploy that added slots: a freshly
                    # woken pool *always* shows violations until its cold
                    # start elapses, and judging it early makes the
                    # monitor pile ever more cold capacity on top.  Both
                    # deferrals are bounded (provisioning lead time /
                    # cold start + one window); if the pool is genuinely
                    # inadequate the monitor fires right after.
                    held_off = (self._cold_starts is not None
                                and (self._pending_switch is not None
                                     or g_end < self._grace_until))
                    if (((up and viol) or forced or down) and not held_off
                            and adapts < self.max_adapts_per_phase):
                        kind = "rescale_down" if (down and not viol) \
                            else "rescale_up"
                        est = self._estimate_factor(seg.arrivals, w, w_hi,
                                                    fallback=factor)
                        est = float(np.clip(est * spec.headroom, 0.05, 20.0))
                        # Commit the consumed prefix *before* searching so
                        # what-if candidate scoring (and the redeploy remap)
                        # sees the pool exactly as it stands at the cut;
                        # the post-loop commit then no-ops.
                        consumed = w_hi
                        plane.commit(consumed)
                        # Cheapest fix first: on an upshift violation, see
                        # whether a different dispatch rule alone absorbs
                        # the new load on the *current* pool (0 BO evals,
                        # no capacity bought) before re-searching the pool.
                        cut_at = ep_base + float(seg.arrivals[w_hi - 1])
                        if kind == "rescale_up" and self._try_reroute(
                                self._scoring_dist(phase), est, config,
                                prices, p, g_end, report, pending):
                            if trace is not None:
                                trace.instant(
                                    "reroute", cut_at,
                                    args={"policy":
                                          report.actions[-1].policy})
                            self.monitor.reset()
                            adapts += 1
                            bad_streak = 0
                            down_streak = 0
                            break
                        t0 = time.perf_counter()
                        opt, new_best, used = self._adapt_load(
                            opt, self._scoring_dist(phase), est, kind)
                        if trace is not None:
                            wall = time.perf_counter() - t0
                            trace.span(f"search:{kind}", cut_at, wall,
                                       args={"bo_evals": int(used),
                                             "wall_ms": wall * 1e3,
                                             "load_est": est})
                        if kind == "rescale_down":
                            # only act on a strictly cheaper pool; a no-op
                            # (or upsizing) result blocks further downscale
                            # attempts until the regime changes
                            new_p = (float(np.dot(prices, new_best))
                                     if new_best is not None else price)
                            if new_best is None or new_p >= price:
                                down_blocked = True
                                new_best = None
                        else:
                            down_blocked = False
                            if new_best is None:
                                # The transfer pruned the space (or the
                                # budgeted search found nothing feasible at
                                # the estimated level): over-provision to
                                # the bounds — the _pick_config convention —
                                # rather than stay wedged in violation.
                                # Idle-restart accounting used to mask this
                                # wedge by draining the queue for free at
                                # the next cut; the continuous clock keeps
                                # the backlog honest, so the control plane
                                # must actually act.
                                fallback = tuple(int(b) for b in bounds)
                                if fallback != tuple(config):
                                    new_best = fallback
                                if (new_best is not None
                                        and self._cold_starts is not None
                                        and not self._fallback_helps(
                                            self._scoring_dist(phase), est,
                                            config, new_best)):
                                    # Tier cold starts change the calculus:
                                    # the blown-up pool's added slots wake
                                    # cold, so "max capacity" is no longer
                                    # "max QoS" over the next windows.  When
                                    # the warm lanes say the bounds pool
                                    # serves this backlog no better than the
                                    # incumbent, keep the (far cheaper)
                                    # incumbent and let the booked
                                    # provisioning / phase-boundary restock
                                    # land instead.
                                    new_best = None
                        action = ControlAction(
                            kind=kind, trigger="monitor", phase=p,
                            at_query=g_end, old_config=config,
                            new_config=new_best,
                            old_price=price,
                            new_price=float(np.dot(prices, new_best))
                            if new_best else price,
                            bo_evals=used,
                            warm_idle_delta=self._score_delta(
                                self._scoring_dist(phase), est, config),
                            policy=getattr(self._route_policy, "name",
                                           None))
                        report.actions.append(action)
                        pending.append(action)
                        report.bo_evals += used
                        if new_best is not None:
                            prev_cfg = config
                            config = tuple(int(c) for c in new_best)
                            # a real redeployment supersedes in-flight
                            # provisioning; a no-op keeps the booking
                            self._pending_switch = None
                            self._pending_trim = None
                            self._note_deploy(prev_cfg, config, g_end, est)
                        redeploy = True
                        self.monitor.reset()
                        adapts += 1
                        bad_streak = 0
                        down_streak = 0
                        break
                    w = w_hi
                # Commit only the consumed prefix into the carried pool
                # state, *then* redeploy: the remap must see the pool as it
                # stood at the adaptation cut, not past rolled-back serving.
                # (A no-op when an adaptation already committed at its cut.)
                plane.commit(consumed)
                if redeploy:
                    plane.deploy(config)
                    if trace is not None:
                        trace.instant(
                            "deploy",
                            ep_base + float(seg.arrivals[consumed - 1]),
                            args={"config": [int(c) for c in config]})
                i += consumed
            report.phases.append(PhaseReport(
                name=phase.name, batch_dist=phase.batch_dist,
                load_factor=factor, n_queries=phase.n_queries,
                qos_rate=ph_passed / phase.n_queries, cost=ph_cost,
                n_windows=ph_windows, violation_windows=ph_viol))
            ph_end = ep_base + float(stream.arrivals[-1])
            if trace is not None:
                trace.span(f"phase:{phase.name}", ph_t0, ph_end - ph_t0,
                           tid=TID_PHASES,
                           args={"n_queries": int(phase.n_queries),
                                 "load_factor": float(factor),
                                 "batch_dist": phase.batch_dist,
                                 "qos_rate": ph_passed / phase.n_queries})
            # The next phase's local t=0 is this phase's end.
            plane.advance_clock(float(stream.arrivals[-1]))
            ep_base = ph_end
            gq += phase.n_queries

        report.total_queries = gq
        report.total_cost = float(sum(w.cost for w in report.windows))
        report.final_config = config
        report.final_qos_by_phase = plane.phase_sweep(
            config, list(spec.phases), policy=self._route_policy)
        if report.final_qos_by_phase is not None:
            # Warm twin of the summary sweep: each phase row starts from
            # the carry the episode actually held entering that phase —
            # still one stacked-table dispatch (the states= grid axis).
            report.final_qos_by_phase_warm = plane.phase_sweep(
                config, list(spec.phases), policy=self._route_policy,
                states=phase_states)
        return report

    # ----------------------------------------------------------- event ops
    # kind -> handler method.  Import-time-checked to cover every kind in
    # spec.EVENT_KIND_SPECS (see the module-level assertion below the
    # class): a kind added to the registry without a handler here fails
    # loudly instead of being silently dropped from episodes.
    _EVENT_HANDLERS = {
        "load_spike": "_ev_load_spike",
        "price_change": "_ev_price_change",
        "cell_failure": "_ev_capacity_loss",
        "spot_preemption": "_ev_capacity_loss",
        "preemption_storm": "_ev_preemption_storm",
        "tier_outage": "_ev_tier_outage",
        "price_spike": "_ev_price_spike",
    }

    def _apply_event(self, ev: EventSpec, p: int, at_q: int, phase, factor,
                     bounds, prices, config, opt, restock_next, report,
                     pending):
        """Dispatch one injected event to its handler.  Mutates
        bounds/prices/restock_next in place; returns the new
        (config, optimizer, effective load factor)."""
        outcome = EventOutcome(kind=ev.kind, phase=p, at_query=at_q)
        report.events.append(outcome)
        pending.append(outcome)
        clears = ev.kind != "load_spike"
        if (clears and self._cold_starts is not None
                and ev.kind in ("price_change", "price_spike")):
            # On tiered planes price moves leave the bounds (and hence the
            # booking's deployability) intact; ``_apply_reprice`` decides
            # whether the in-flight transition still pays under the new
            # prices instead of discarding it wholesale.
            clears = False
        if clears:
            # Capacity and price events change the space/objective under
            # any in-flight provisioning: the booking was computed for the
            # old regime (it could even exceed the post-event bounds), and
            # each handler books or deploys its own replacement.
            self._pending_switch = None
            self._pending_trim = None
        handler = getattr(self, self._EVENT_HANDLERS[ev.kind])
        return handler(ev, outcome, p, at_q, phase, factor, bounds, prices,
                       config, opt, restock_next, report)

    def _tier_indices(self, tier: str, n_types: int) -> list[int]:
        """Indices of the pool types procured on ``tier``.  Planes without
        a ``type_tiers`` surface are all on-demand, so tier events against
        any other tier are no-ops there (and recover trivially)."""
        tiers = getattr(self.plane, "type_tiers", None)
        if tiers is None:
            tiers = ("on_demand",) * n_types
        return [i for i, name in enumerate(tiers) if name == tier]

    def _ev_load_spike(self, ev, outcome, p, at_q, phase, factor, bounds,
                       prices, config, opt, restock_next, report):
        outcome.detail = f"x{ev.factor:g} traffic"
        return config, opt, factor * ev.factor

    def _apply_reprice(self, targets, outcome, p, at_q, phase, factor,
                       prices, config, opt, report):
        """Shared repricing path: multiply each target type's unit price,
        tell the plane, rebuild the optimizer over the new cost landscape
        (full history replays — QoS is price-independent)."""
        old_price = float(np.dot(prices, config))
        for t, mult in sorted(targets.items()):
            prices[t] = prices[t] * mult
            self.plane.apply_price(t, prices[t])
        oracle = self._search_oracle(self._scoring_dist(phase), factor)
        opt, sev = reprice(opt, prices, oracle,
                           budget=self.spec.recover_budget)
        new_cfg = sev.new_best or config
        if self._pending_switch is not None:
            target = self._pending_trim or self._pending_switch[1]
            if (all(int(a) <= int(c) for a, c in zip(target, config))
                    and float(np.dot(prices, target))
                    <= float(np.dot(prices, new_cfg))):
                # The in-flight transition ends in a pure removal that is
                # still at least as cheap under the new prices as the
                # repriced search's own pick: let it land as planned
                # (re-buying its slots later would wake them cold again).
                new_cfg = config
            else:
                self._pending_switch = None
                self._pending_trim = None
        report.actions.append(ControlAction(
            kind="reprice", trigger="event", phase=p, at_query=at_q,
            old_config=config, new_config=new_cfg,
            old_price=old_price,
            new_price=float(np.dot(prices, new_cfg)),
            bo_evals=sev.samples_used,
            warm_idle_delta=self._score_delta(self._scoring_dist(phase),
                                              factor, config)))
        report.bo_evals += sev.samples_used
        return tuple(int(c) for c in new_cfg), opt

    def _ev_price_change(self, ev, outcome, p, at_q, phase, factor, bounds,
                         prices, config, opt, restock_next, report):
        t = ev.type_index
        if not 0 <= t < len(bounds):
            raise ValueError(f"event {ev.kind}: type_index {t} out of range "
                             f"for a pool with {len(bounds)} instance types")
        outcome.detail = f"type {t} price x{ev.factor:g}"
        config, opt = self._apply_reprice({t: ev.factor}, outcome, p, at_q,
                                          phase, factor, prices, config,
                                          opt, report)
        return config, opt, factor

    def _ev_price_spike(self, ev, outcome, p, at_q, phase, factor, bounds,
                        prices, config, opt, restock_next, report):
        idx = self._tier_indices(ev.tier, len(bounds))
        outcome.detail = f"{ev.tier} price x{ev.factor:g}"
        if not idx:
            return config, opt, factor
        config, opt = self._apply_reprice({t: ev.factor for t in idx},
                                          outcome, p, at_q, phase, factor,
                                          prices, config, opt, report)
        return config, opt, factor

    def _recover_capacity(self, losses, kind, p, at_q, phase, factor,
                          bounds, prices, config, opt, restock_next, report,
                          transient: bool, fallback_bounds: bool = False):
        """Shared capacity-loss path: shrink the space by ``losses``
        (type -> count), run one joint multi-type recovery over the reduced
        bounds, book the replacement pool behind the provisioning delay.

        ``transient`` queues the losses for the next phase boundary's
        restock (spot capacity the market returns).  ``fallback_bounds``
        is the tier events' graceful degradation: when even the warm-scored
        recovery search finds nothing feasible, fall back to the surviving
        bounds (over-provision on what's left — typically the on-demand
        tier) instead of serving on the storm-degraded pool.
        """
        degraded = list(int(c) for c in config)
        for t, lost in sorted(losses.items()):
            self.plane.apply_capacity_loss(t, lost)
            degraded[t] = max(0, degraded[t] - lost)
            bounds[t] -= lost
        degraded = tuple(min(c, int(b)) for c, b in zip(degraded, bounds))
        search_factor = factor
        if self._cold_starts is not None and self.spec.provision_queries > 0:
            # The booked pool lands provision_queries later, after the
            # degraded pool has let that much demand pile up; by demand
            # conservation the replacement must absorb the lead-time mass
            # on top of the steady rate.  Size it to drain within a couple
            # of monitoring windows: an exactly-sized pool never catches up
            # (drain time = backlog / headroom), while amortizing over the
            # whole remaining episode leaves per-window QoS violated until
            # the tail.  The monitor downscales the headroom once drained.
            n_rem = max(self._total_queries - at_q
                        - self.spec.provision_queries, self.spec.window)
            drain = min(n_rem, 2 * self.spec.window)
            search_factor = factor * (1.0
                                      + self.spec.provision_queries / drain)
        oracle = self._search_oracle(self._scoring_dist(phase),
                                     search_factor)
        opt, sev = recover_from_capacity_change(
            opt, oracle, losses, budget=self.spec.recover_budget, kind=kind,
            # Tiered planes score from the live backlog with cold starts
            # charged to freshly-bought slots; pre-event history was taken
            # warm and backlog-free, so replaying it lets a stale-scored
            # incumbent shadow every honestly-scored probe.
            replay=self._cold_starts is None)
        if transient:
            for t, lost in losses.items():
                restock_next[t] = restock_next.get(t, 0) + lost
            if self._pre_loss_config is None:
                self._pre_loss_config = tuple(int(c) for c in config)
        new_cfg = sev.new_best
        if new_cfg is None and fallback_bounds:
            fallback = tuple(int(b) for b in bounds)
            new_cfg = fallback if fallback != degraded else None
        new_cfg = tuple(int(c) for c in (new_cfg or degraded))
        report.actions.append(ControlAction(
            kind=kind, trigger="event", phase=p, at_query=at_q,
            old_config=config, new_config=new_cfg,
            old_price=float(np.dot(prices, config)),
            new_price=float(np.dot(prices, new_cfg)),
            bo_evals=sev.samples_used,
            warm_idle_delta=self._score_delta(self._scoring_dist(phase),
                                              factor, config)))
        report.bo_evals += sev.samples_used
        if self.spec.provision_queries > 0 and new_cfg != degraded:
            # replacement capacity boots asynchronously: the degraded pool
            # serves until the booked switch point
            self._pending_switch = (at_q + self.spec.provision_queries,
                                    new_cfg)
            return degraded, opt
        return new_cfg, opt

    def _ev_capacity_loss(self, ev, outcome, p, at_q, phase, factor, bounds,
                          prices, config, opt, restock_next, report):
        t = ev.type_index
        if not 0 <= t < len(bounds):
            raise ValueError(f"event {ev.kind}: type_index {t} out of range "
                             f"for a pool with {len(bounds)} instance types")
        lost = min(int(ev.count), int(bounds[t]))
        outcome.detail = f"type {t} -{lost}"
        if lost == 0:
            return config, opt, factor
        kind = ("recover_preemption" if ev.kind == "spot_preemption"
                else "recover_failure")
        config, opt = self._recover_capacity(
            {t: lost}, kind, p, at_q, phase, factor, bounds, prices, config,
            opt, restock_next, report,
            transient=(ev.kind == "spot_preemption"))
        return config, opt, factor

    def _ev_preemption_storm(self, ev, outcome, p, at_q, phase, factor,
                             bounds, prices, config, opt, restock_next,
                             report):
        """Correlated same-tier kill: fraction ``ev.factor`` of each tier
        type's *deployed* capacity is preempted at once; the market
        restocks the losses at the next phase boundary (re-entering —
        never resetting — the tier's absolute-clock hazard process)."""
        losses = {}
        for t in self._tier_indices(ev.tier, len(bounds)):
            lost = min(int(np.ceil(ev.factor * config[t])), int(bounds[t]))
            if lost > 0:
                losses[t] = lost
        hit = ", ".join(f"type {t} -{c}" for t, c in sorted(losses.items()))
        outcome.detail = (f"{ev.tier} storm kill {ev.factor:g}: "
                          f"{hit or 'no capacity deployed'}")
        if not losses:
            return config, opt, factor
        config, opt = self._recover_capacity(
            losses, "recover_storm", p, at_q, phase, factor, bounds, prices,
            config, opt, restock_next, report, transient=True,
            fallback_bounds=True)
        return config, opt, factor

    def _ev_tier_outage(self, ev, outcome, p, at_q, phase, factor, bounds,
                        prices, config, opt, restock_next, report):
        """The whole tier's capacity (its full search bounds) evaporates
        until the next phase boundary's restock; the survivors' bounds are
        the degradation floor when no feasible pool remains."""
        losses = {t: int(bounds[t])
                  for t in self._tier_indices(ev.tier, len(bounds))
                  if bounds[t] > 0}
        hit = ", ".join(f"type {t} -{c}" for t, c in sorted(losses.items()))
        outcome.detail = (f"{ev.tier} outage: "
                          f"{hit or 'no capacity procured'}")
        if not losses:
            return config, opt, factor
        config, opt = self._recover_capacity(
            losses, "recover_outage", p, at_q, phase, factor, bounds,
            prices, config, opt, restock_next, report, transient=True,
            fallback_bounds=True)
        return config, opt, factor

    def _restock(self, restock_next, p, gq, phase, bounds, prices, config,
                 opt, report, pending):
        """Return preempted spot capacity at a phase boundary: the same
        replay plumbing as failure recovery, with negative loss."""
        # the restock search supersedes any switch still booked for the
        # degraded (pre-restock) space
        self._pending_switch = None
        self._pending_trim = None
        seed, self._pre_loss_config = self._pre_loss_config, None
        for t, cnt in sorted(restock_next.items()):
            oracle = self._search_oracle(self._scoring_dist(phase),
                                         phase.load_factor)
            opt, sev = recover_from_failure(opt, oracle, failed_type=t,
                                            lost=-cnt,
                                            budget=self.spec.recover_budget,
                                            kind="restock",
                                            replay=self._cold_starts is None)
            bounds[t] += cnt
            new_cfg = sev.new_best or config
            action = ControlAction(
                kind="restock", trigger="phase_start", phase=p, at_query=gq,
                old_config=config, new_config=new_cfg,
                old_price=float(np.dot(prices, config)),
                new_price=float(np.dot(prices, new_cfg)),
                bo_evals=sev.samples_used,
                warm_idle_delta=self._score_delta(
                    self._scoring_dist(phase), phase.load_factor, config))
            report.actions.append(action)
            pending.append(action)
            report.bo_evals += sev.samples_used
            prev_cfg = config
            config = tuple(int(c) for c in new_cfg)
            self._note_deploy(prev_cfg, config, gq, phase.load_factor)
        if (seed is not None and self._cold_starts is not None
                and self.spec.provision_queries > 0):
            # With the market restocked, try to walk the portfolio back to
            # the pool that served before the storm.  The candidate is
            # judged for the *steady state* (idle grid score at the phase
            # load): its cold starts are a one-off transition cost that the
            # serving plane charges honestly at the landing, not a property
            # of the pool, and scoring them into the search record would
            # brand the cheap mix infeasible forever.  Booked behind the
            # provisioning lead like any other deploy; the monitor cannot
            # trigger this return on its own because a drained steady
            # state shows no queue slack to release.
            ev = self.plane.grid_evaluator(self._scoring_dist(phase))
            # Not only the exact pre-storm pool: the whole bounded Hamming
            # neighborhood around it (the storm may have shifted bounds or
            # prices so the precise seed is gone or no longer the cheapest
            # feasible return point), scored in one grid dispatch.
            cands = [c for c in _near_seed_candidates(
                         tuple(int(x) for x in seed), bounds, tuple(config))
                     if float(np.dot(prices, c))
                     < float(np.dot(prices, config))]
            if ev is not None and cands:
                rates = ev.grid(cands, [phase.load_factor],
                                policy=self._route_policy)[0]
                feasible = [(float(np.dot(prices, c)), i)
                            for i, c in enumerate(cands)
                            if float(rates[i]) >= self.spec.qos_target]
                if feasible:
                    # Cheapest feasible; ties break seed-first (stable min
                    # over the generation order via the index tiebreak).
                    trim = cands[min(feasible)[1]]
                    # Two-stage transition: first the union pool (the trim
                    # slots wake cold beside the still-warm incumbents),
                    # then — via ``_land_pending`` — the pure-removal drop
                    # to the trim once the grace clock says they are warm.
                    union = tuple(max(int(c), int(s))
                                  for c, s in zip(config, trim))
                    self._pending_switch = (
                        gq + self.spec.provision_queries, union)
                    self._pending_trim = trim
                    report.actions.append(ControlAction(
                        kind="restock_trim", trigger="phase_start", phase=p,
                        at_query=gq, old_config=config, new_config=trim,
                        old_price=float(np.dot(prices, config)),
                        new_price=float(np.dot(prices, trim)),
                        bo_evals=1, warm_idle_delta=None))
        self.plane.deploy(config)
        self.monitor.reset()
        return config, opt


# Import-time guard: the registry and the dispatch table must agree, so a
# new event kind cannot be silently ignored by every episode that uses it.
_UNHANDLED = [k for k in EVENT_KINDS
              if k not in ScenarioEngine._EVENT_HANDLERS]
if _UNHANDLED:    # pragma: no cover - tripped only by a wiring bug
    raise RuntimeError(
        "event kinds registered in spec.EVENT_KIND_SPECS but missing from "
        f"ScenarioEngine._EVENT_HANDLERS: {_UNHANDLED}")
