"""Evaluation planes the scenario engine drives.

Both planes speak one small protocol:

  * ``phase_stream(dist, n, factor)`` — the phase's query stream (a prefix
    of the episode base stream for that batch distribution, compressed by
    the load factor);
  * ``begin_episode(carry=True)`` — reset the continuous-time episode
    clock; ``carry=False`` restores the legacy idle-restart accounting
    (every segment from a drained pool — the scenario bench's baseline);
  * ``measure(dist, workload, config)`` — per-query ``(latencies, waits)``
    float64 arrays of serving that stream with that pool, warm-started
    from the carried pool state (``last_carried_wait`` holds the backlog
    that crossed the segment's opening cut).  The serve is speculative:
  * ``commit(n_served)`` — roll the carried state forward past only the
    first ``n_served`` queries of the last measured segment (the engine
    rewinds a segment to an adaptation cut);
  * ``deploy(config)`` — put a pool configuration in force, remapping the
    carried slot state through the reconfiguration (surviving instances
    keep their in-flight work, removed slots drop it, added slots start
    idle — or, on a tiered plane, busy for their capacity tier's cold
    start: a pool scaled to zero pays its wake-up backlog through the
    carry, bit-exactly.  Any *control-plane* provisioning delay was
    already modeled by the engine's deferred switch);
  * ``advance_clock(delta)`` — shift the local-time origin (phase
    boundary: the previous stream's span; mid-phase stream rebuild, e.g. a
    load spike: the anchor-arrival delta that keeps episode time
    continuous);
  * ``oracle(dist, factor)`` — a sequential ``config -> QoS rate`` callable
    for the search loops (cold whole-stream evaluations — hypothetical
    deployments scored from an idle queue);
  * ``warm_oracle(dist, factor)`` — the same callable scored from the
    carried pool state: each probe is a what-if redeploy of the live
    backlog onto that candidate (falls back to ``oracle`` when there is
    nothing to carry).  Probes never touch the carried episode state;
  * ``candidate_state()`` — the (state, deployed config) pair behind that
    what-if view, rebased to now, for callers driving the batched warm
    lanes directly (``PoolEvaluator.grid_from``, ``rescale(warm_state=)``);
    ``None`` when the plane scores cold;
  * ``grid_evaluator(dist)`` — a ``PoolEvaluator`` when the plane supports
    the joint (load x config) grid fast path, else ``None`` (the engine
    then drives the legacy sequential rescale path);
  * ``configure(config)`` — raw pool plumbing (a no-op on the simulator);
    the engine goes through ``deploy`` so state remapping is never skipped.

``SimulatorPlane`` is the fast path: segments run through
``PoolSimulator`` on ``device`` (default ``cuda``; warm starts via
``PoolSimulator.segment_from``), adaptation searches through the grid lane,
and the episode summary sweeps every phase in one stacked service-table
dispatch; every dispatch is one launch of the FCFS kernel
(``n_dispatches`` counts them).  ``LivePlane`` is the measured path: the
same loop drives a ``ClusterEngine`` that executes every query on the real
device — per-cell busy times thread across segments through
``ClusterEngine.serve(initial_busy=...)``; its episode clock and carried
``PoolState`` are the same float64 host code as the reference's.

Counterpart of ``repro/scenario/planes.py``.
"""

from __future__ import annotations

import numpy as np

from ..core.search_space import SearchSpace
from ..device import resolve_device
from ..serving.instance import (AWS_INSTANCES, MODEL_PROFILES, PAPER_POOLS,
                                InstanceType, ModelProfile,
                                service_table_for)
from ..serving.pool import DEFAULT_BOUNDS, PoolEvaluator, paper_workload
from ..serving.simulator import PoolSimulator, PoolState
from ..serving.tiers import TierCatalog, tiered_pool
from ..serving.workload import Workload
from .spec import PhaseSpec, ScenarioSpec


def _prefix(workload: Workload, n: int) -> Workload:
    if n >= workload.n_queries:
        return workload
    return Workload(arrivals=workload.arrivals[:n],
                    batches=workload.batches[:n],
                    rate_qps=workload.rate_qps,
                    bucket_of=None if workload.bucket_of is None
                    else workload.bucket_of[:n],
                    buckets=workload.buckets)


def slice_stream(workload: Workload, lo: int, hi: int) -> Workload:
    """A contiguous segment of a stream (absolute arrival times kept)."""
    return Workload(arrivals=workload.arrivals[lo:hi],
                    batches=workload.batches[lo:hi],
                    rate_qps=workload.rate_qps,
                    bucket_of=None if workload.bucket_of is None
                    else workload.bucket_of[lo:hi],
                    buckets=workload.buckets)


class _EpisodeClock:
    """Continuous-time threading of a plane: the carried
    :class:`PoolState`, the deployed config, and local-time bookkeeping.
    Subclasses set ``_n_slots`` and implement ``measure``/``commit``;
    tiered planes set ``_cold_starts`` (per-type cold-start seconds) so
    every redeploy's added slots start busy for their tier's wake-up."""

    _n_slots: int
    _cold_starts = None      # per-type cold-start seconds, or None (legacy)

    @property
    def cold_starts(self):
        """Per-type cold-start seconds the warm lanes charge slots added by
        a redeploy, or ``None`` on a plane without capacity tiers."""
        return self._cold_starts

    def _reset_clock(self, carry: bool) -> None:
        self._carry = bool(carry)
        self._state: PoolState | None = (
            PoolState.idle(self._n_slots) if carry else None)
        self._deployed: tuple[int, ...] | None = None
        self._local_now = 0.0
        self._pending = None
        self._tel_src = None
        self.last_carried_wait = 0.0

    def window_telemetry(self, lo: int, hi: int):
        """Telemetry over queries ``[lo, hi)`` of the last measured segment
        (serving/telemetry.Telemetry), or ``None`` on planes without a
        telemetry source (the live plane measures wall clock; it has no
        dispatch trace to reduce)."""
        return None

    def begin_episode(self, carry: bool = True) -> None:
        """Reset the episode clock to an idle pool at episode time 0.
        ``carry=False`` switches the plane to the legacy idle-restart
        accounting (every segment from a drained pool)."""
        self._reset_clock(carry)

    def deploy(self, config) -> None:
        """Put a pool configuration in force, threading the carried slot
        state through the reconfiguration (``PoolState.remap``); slots the
        switch adds pay their tier's cold start (``warmup``)."""
        cfg = tuple(int(c) for c in config)
        if (self._carry and self._state is not None
                and self._deployed is not None and cfg != self._deployed):
            now = self._state.clock + self._local_now
            self._state = self._state.remap(self._deployed, cfg, now,
                                            warmup=self._cold_starts)
        self._deployed = cfg
        self.configure(cfg)

    def advance_clock(self, delta: float) -> None:
        """Shift the local-time origin ``delta`` episode seconds forward
        (phase boundary / mid-phase stream rebuild)."""
        if not self._carry or self._state is None:
            return
        self._state = self._state.rebased(float(delta))
        self._local_now = max(self._local_now - float(delta), 0.0)

    def candidate_state(self):
        """(state, deployed_config) for what-if candidate scoring, or
        ``None`` when the plane scores cold (idle-restart accounting, or no
        pool deployed yet).  The state is rebased to *now* — its clock is
        the current episode time, so the remaining backlog reads against a
        candidate stream's local ``t=0`` and ``PoolState.remap`` at the
        default ``now`` models redeploying at this instant."""
        if not self._carry or self._state is None or self._deployed is None:
            return None
        return self._state.rebased(self._local_now), self._deployed


class SimulatorPlane(_EpisodeClock):
    """Queueing-simulator plane over per-distribution base workloads.

    ``workloads`` maps batch-distribution name -> base :class:`Workload`.
    All base workloads must share their arrival stream (generate them from
    one seed/rate/length — only the batch key differs), which is what lets
    ``phase_sweep`` stack per-phase service tables over one arrival grid.
    The simulators run on ``device`` (default ``cuda``).
    """

    name = "simulator"

    def __init__(self, profile: ModelProfile, types: list[InstanceType],
                 workloads: dict[str, Workload], max_instances: int = 40,
                 catalog=None, stream_chunk: int | None = None, device=None):
        self.device = resolve_device(device)
        if not workloads:
            raise ValueError("at least one base workload is required")
        if stream_chunk is not None and stream_chunk < 1:
            raise ValueError("stream_chunk must be >= 1")
        arrs = [wl.arrivals for wl in workloads.values()]
        for a in arrs[1:]:
            if not np.array_equal(a, arrs[0]):
                raise ValueError("base workloads must share arrival times "
                                 "(same seed/rate/length)")
        self.profile = profile
        self.types = list(types)
        self.max_instances = max_instances
        self._n_slots = max_instances
        # Streaming episodes: serve each measured segment in bounded query
        # blocks chained through the PoolState carry (segment chaining is
        # bit-exact across arbitrary cuts), so a million-query phase never
        # binds one million-row simulator.  None = monolithic.
        self._stream_chunk = stream_chunk
        self.workloads = dict(workloads)
        self.evaluators = {d: PoolEvaluator(profile, self.types, wl,
                                            max_instances=max_instances,
                                            device=self.device)
                           for d, wl in self.workloads.items()}
        # Dispatches of the simulators ``measure`` binds (one a block).
        self._measure_dispatches = 0
        # ``catalog`` (serving/tiers.TierCatalog) turns this into a tiered
        # plane: redeploys charge per-tier cold starts through the carry,
        # and the engine's BO sees per-type interruption risk premiums.
        # Without one the plane is bit-identical to the legacy behavior.
        self.catalog = catalog
        self.cost_penalties = None
        if catalog is not None:
            self._cold_starts = catalog.cold_starts(profile)
            self.cost_penalties = catalog.cost_penalties()
        self._dist_tables: dict[str, np.ndarray] = {}
        self._last_stream: Workload | None = None
        self._reset_clock(False)     # cold until an episode begins

    @property
    def type_tiers(self) -> tuple[str, ...]:
        """Capacity tier of each instance type (tier-scoped events resolve
        their targets against this)."""
        return tuple(getattr(t, "tier", "on_demand") for t in self.types)

    @property
    def qos_latency(self) -> float:
        return self.profile.qos_latency

    @property
    def base_rate(self) -> float:
        return next(iter(self.workloads.values())).rate_qps

    @property
    def n_evals(self) -> int:
        return sum(ev.n_evals for ev in self.evaluators.values())

    @property
    def n_dispatches(self) -> int:
        """Simulator dispatches made so far: the evaluators' searches and
        sweeps, and the segments ``measure`` served."""
        return self._measure_dispatches + sum(
            ev.sim.n_dispatches for ev in self.evaluators.values())

    def configure(self, config) -> None:     # the simulator pool is stateless
        pass

    def apply_capacity_loss(self, type_index: int, count: int) -> None:
        """No-op: the simulator models capacity purely through the engine's
        bounds + the configs it is asked to simulate."""

    def apply_price(self, type_index: int, price: float) -> None:
        """No-op: simulator QoS is price-free; cost accounting lives in the
        scenario engine's price vector."""

    def phase_stream(self, dist: str, n: int, factor: float) -> Workload:
        return _prefix(self.workloads[dist].scaled(factor), n)

    def measure(self, dist: str, workload: Workload, config, *, policy=None):
        """Serve one phase stream, in one shot or — with ``stream_chunk``
        set — as a chain of bounded query blocks, each block's
        :class:`PoolSimulator` bound to its slice alone and warm-started
        from the previous block's final carry.  Block boundaries are
        invisible to the results: the carry threads bit-exactly
        (``segment_from`` chaining), so latencies, waits, the committed
        state, and window telemetry all match the monolithic serve."""
        n = workload.n_queries
        chunk = self._stream_chunk
        if chunk is None or n <= chunk:
            cuts = [(0, n)]
        else:
            cuts = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
        cfg_tuple = tuple(int(c) for c in config)
        cold = not self._carry
        self._last_stream = workload
        parts = []
        lats, waits = [], []
        st = None
        for lo, hi in cuts:
            sim = PoolSimulator(self.profile, self.types,
                                slice_stream(workload, lo, hi),
                                max_instances=self.max_instances,
                                device=self.device)
            if st is None:
                # Cold segments start from the idle carry at clock 0 — the
                # warm identity element, bit-identical to the cold simulate
                # lane — so both accounting modes leave a telemetry source.
                st = sim.initial_state() if cold else self._state
            seg = sim.segment_from(st, config, policy=policy)
            self._measure_dispatches += sim.n_dispatches
            st = seg.state
            parts.append((sim, seg, cfg_tuple, lo, hi - lo))
            lats.append(seg.lat)
            waits.append(seg.waits)
        self._tel_src = parts
        if cold:
            self._pending = None
            self.last_carried_wait = 0.0
        else:
            at = float(workload.arrivals[0]) if n else 0.0
            self.last_carried_wait = parts[0][0].carried_wait(
                self._state, config, at)
            self._pending = (parts, np.asarray(workload.arrivals,
                                               dtype=np.float64))
        if len(parts) == 1:
            return parts[0][1].lat, parts[0][1].waits
        return np.concatenate(lats), np.concatenate(waits)

    def window_telemetry(self, lo: int, hi: int):
        """Telemetry over queries ``[lo, hi)`` of the last measured segment
        — host-side from the segment's recorded dispatch trace
        (``PoolSimulator.segment_telemetry``), so window enrichment never
        re-runs the scan.  On a chunked serve the window's overlap with
        each block reduces separately and the pieces merge exactly
        (``Telemetry.merge`` is integer accumulation)."""
        if self._tel_src is None:
            return None
        tel = None
        for sim, seg, cfg, off, m in self._tel_src:
            w_lo, w_hi = max(lo - off, 0), min(hi - off, m)
            if w_lo >= w_hi:
                continue
            piece = sim.segment_telemetry(seg, cfg, w_lo, w_hi)
            tel = piece if tel is None else tel.merge(piece)
        if tel is None:
            # Empty window: an all-zero plane of the right type arity.
            sim, seg, cfg = self._tel_src[0][:3]
            return sim.segment_telemetry(seg, cfg, 0, 0)
        return tel

    def commit(self, n_served: int) -> None:
        """Fold the first ``n_served`` queries of the last measured segment
        into the carried state (the rest was rolled back by the engine)."""
        if not self._carry or self._pending is None:
            return
        parts, arr = self._pending
        self._pending = None
        n = int(n_served)
        for sim, seg, cfg, off, m in parts:
            if n <= off + m:
                self._state = seg.state_at(max(n - off, 0))
                break
        else:
            self._state = parts[-1][1].state
        if n > 0:
            self._local_now = float(arr[n - 1])

    def _dist_table(self, dist: str) -> np.ndarray:
        tab = self._dist_tables.get(dist)
        if tab is None:
            tab = np.asarray(service_table_for(self.profile, self.types,
                                               self.workloads[dist]),
                             dtype=np.float64)
            self._dist_tables[dist] = tab
        return tab

    def infer_dist(self, start: int, lat, waits, config) -> str | None:
        """Classify which registered batch distribution produced a measured
        window, from the measurements alone.

        FCFS latency decomposes as wait + service, so ``lat - waits`` is
        the service time each query actually drew on whichever active
        instance served it.  Each registered distribution predicts a small
        set of admissible service values per query (its service-table
        column, restricted to types the deployed ``config`` runs); the
        distribution whose predictions match the largest fraction of the
        window wins, if that fraction clears 0.9.  Returns ``None`` when no
        distribution matches (or the plane registers only one, where the
        question is moot).  This is what lets the engine adapt to drift in
        the *measured* traffic even when the spec's phase labels lie."""
        if len(self.workloads) < 2:
            return None
        resid = (np.asarray(lat, dtype=np.float64)
                 - np.asarray(waits, dtype=np.float64))
        ok = np.isfinite(resid)
        if not ok.any():
            return None
        active = [t for t, c in enumerate(config) if int(c) > 0]
        if not active:
            return None
        lo, hi = int(start), int(start) + len(resid)
        best, best_frac = None, 0.0
        for d in self.workloads:
            tab = self._dist_table(d)
            if hi > tab.shape[1]:
                continue
            cols = tab[np.ix_(active, range(lo, hi))]
            rel = np.abs(cols - resid[None, :]) / np.maximum(cols, 1e-12)
            frac = float((rel.min(axis=0) <= 1e-3)[ok].mean())
            if frac > best_frac:
                best, best_frac = d, frac
        return best if best_frac >= 0.9 else None

    def segment_buckets(self, lo: int, hi: int, waits) -> tuple:
        """Per-bucket mean waits over queries ``[lo, hi)`` of the last
        measured segment, ordered by bucket index; ``()`` when the stream
        carries no bucket annotation."""
        wl = self._last_stream
        if wl is None or wl.bucket_of is None:
            return ()
        ids = np.asarray(wl.bucket_of[lo:hi])
        w = np.asarray(waits, dtype=np.float64)
        out = []
        for b in range(len(wl.buckets)):
            sel = ids == b
            out.append(float(w[sel].mean()) if sel.any() else 0.0)
        return tuple(out)

    def grid_evaluator(self, dist: str) -> PoolEvaluator:
        return self.evaluators[dist]

    def oracle(self, dist: str, factor: float, *, policy=None):
        ev = self.evaluators[dist]
        return lambda cfg: float(
            ev.grid([cfg], [factor], policy=policy)[0, 0])

    def warm_oracle(self, dist: str, factor: float, *, policy=None):
        """Sequential ``config -> QoS rate`` scored from the live backlog:
        each probe is a what-if redeploy of the carried pool state as that
        candidate (``PoolEvaluator.grid_from``).  Falls back to the cold
        ``oracle`` when the plane has nothing to carry."""
        cs = self.candidate_state()
        if cs is None:
            return self.oracle(dist, factor, policy=policy)
        state, dep = cs
        ev = self.evaluators[dist]
        return lambda cfg: float(ev.grid_from(
            state, [cfg], [factor], deployed=dep,
            warmup=self._cold_starts, policy=policy)[0, 0])

    def phase_sweep(self, config, phases: list[PhaseSpec], *,
                    policy=None, states=None) -> list[float]:
        """Full-stream QoS of one config under every phase's conditions —
        one stacked service-table grid dispatch (W = n_phases lanes over
        the shared arrival grid, each with its phase's batch stream).

        ``states=`` (one entry per phase: ``None`` or a ``(PoolState,
        deployed_config)`` pair, e.g. the plane's ``candidate_state()``
        captured at each phase start) warm-starts every phase row from the
        carry the episode actually held entering that phase — the whole
        multi-phase warm sweep still runs in the one dispatch."""
        sim = next(iter(self.evaluators.values())).sim
        tables = np.stack([
            service_table_for(self.profile, self.types,
                              self.workloads[ph.batch_dist])
            for ph in phases])
        factors = [ph.load_factor for ph in phases]
        kwargs = {}
        if states is not None:
            kwargs = {"states": list(states), "warmup": self._cold_starts}
        rates = sim.qos([tuple(int(c) for c in config)],
                        workloads=factors, service_tables=tables,
                        policy=policy, **kwargs).rates
        return [float(r) for r in rates[:, 0]]


class LivePlane(_EpisodeClock):
    """Measured plane: the same scenario loop over a live ``ClusterEngine``.

    Every measurement executes the real models on the engine's device;
    service times are wall clock (scaled by cell speed), so results are
    *measured, not simulated* — and correspondingly expensive.  Search
    oracles serve only a short probe prefix per candidate
    (``probe_queries``) to bound the cost of an adaptation; probes never
    touch the carried episode state.  ``engine`` is a
    ``repro_torch.serving.engine.ClusterEngine``; ``qos_latency`` must be
    supplied (live cells measure a different speed regime than the
    analytical instance profiles).  The carried state holds per-cell
    next-free times in unscaled episode seconds; ``measure`` converts to
    the serve's scaled virtual-time frame and back.  Counterpart of the
    reference's ``LivePlane``, the same float64 host code.
    """

    name = "live"

    def __init__(self, engine, workloads: dict[str, Workload],
                 qos_latency: float, time_scale: float = 1.0,
                 probe_queries: int = 40, max_slots: int = 64):
        self.engine = engine
        self.workloads = dict(workloads)
        self.qos_latency = float(qos_latency)
        self.time_scale = float(time_scale)
        self.probe_queries = int(probe_queries)
        self.n_evals = 0
        self._n_slots = int(max_slots)
        self._reset_clock(False)     # cold until an episode begins

    @property
    def base_rate(self) -> float:
        return next(iter(self.workloads.values())).rate_qps

    @property
    def type_tiers(self) -> tuple[str, ...]:
        return tuple(getattr(ct, "tier", "on_demand")
                     for ct in self.engine.cell_types)

    def configure(self, config) -> None:
        self.engine.configure(tuple(int(c) for c in config))

    def apply_capacity_loss(self, type_index: int, count: int) -> None:
        """The market reclaims live cells: they fail in place and keep
        failing until the next re-provisioning `configure`."""
        self.engine.preempt(type_index, count)

    def apply_price(self, type_index: int, price: float) -> None:
        self.engine.cell_types[type_index].price = float(price)

    def phase_stream(self, dist: str, n: int, factor: float) -> Workload:
        return _prefix(self.workloads[dist].scaled(factor), n)

    @staticmethod
    def _no_routing(policy) -> None:
        if policy is not None:
            raise ValueError("the live plane dispatches FCFS on the host; "
                             "routing policies are simulator-plane only")

    def measure(self, dist: str, workload: Workload, config, *, policy=None):
        self._no_routing(policy)
        self.configure(config)
        total = int(sum(int(c) for c in config))
        initial = None
        if self._carry and total > 0:
            rel = (np.asarray(self._state.free[:total], dtype=np.float64)
                   - self._state.clock)
            initial = rel * self.time_scale
            # Report the backlog in unscaled episode seconds (the
            # simulator plane's frame), not the serve's stretched
            # virtual-time frame.
            a0 = (float(workload.arrivals[0]) if workload.n_queries
                  else 0.0)
            self.last_carried_wait = float(
                np.maximum(rel - a0, 0.0).sum())
        else:
            self.last_carried_wait = 0.0
        self.engine.serve(workload, self.qos_latency,
                          time_scale=self.time_scale, initial_busy=initial)
        lat, waits = self.engine.served_arrays()
        self._pending = None
        if len(lat) < workload.n_queries:
            # an empty/fully-failed pool serves nothing: every query
            # violates (the simulator plane's +inf convention); the carry
            # passes through unchanged
            n = workload.n_queries
            return np.full(n, np.inf), np.full(n, np.inf)
        if self._carry:
            # Snapshot the dispatch trace now — search probes between this
            # measure and the engine's commit overwrite engine.records.
            recs = self.engine.records
            self._pending = (
                np.asarray([r.slot for r in recs], dtype=np.int64),
                np.asarray([r.arrival + r.latency for r in recs],
                           dtype=np.float64),
                np.asarray(initial if initial is not None
                           else np.zeros(total), dtype=np.float64),
                np.asarray(workload.arrivals, dtype=np.float64),
                total,
            )
        return lat, waits

    def commit(self, n_served: int) -> None:
        """Fold the first ``n_served`` served queries of the last measured
        segment into the carried per-cell state."""
        if not self._carry or self._pending is None:
            return
        slots, fins, initial, arr, total = self._pending
        self._pending = None
        n = int(n_served)
        busy = initial.copy()
        # Per-cell virtual finishes are nondecreasing: max == last.
        np.maximum.at(busy, slots[:n], fins[:n])
        free = self._state.free.copy()
        free[:total] = self._state.clock + busy / self.time_scale
        self._state = PoolState(free=free, clock=self._state.clock)
        if n > 0:
            self._local_now = float(arr[n - 1])

    def grid_evaluator(self, dist: str):
        return None                      # no batched path on the live plane

    def oracle(self, dist: str, factor: float, *, policy=None):
        self._no_routing(policy)
        probe = _prefix(self.workloads[dist].scaled(factor),
                        self.probe_queries)

        def evaluate(cfg) -> float:
            self.configure(cfg)
            self.n_evals += 1
            return float(self.engine.serve(probe, self.qos_latency,
                                           time_scale=self.time_scale))
        return evaluate

    def warm_oracle(self, dist: str, factor: float, *, policy=None):
        """Measured what-if scoring from the carried per-cell state: each
        candidate probe serves with ``initial_busy`` set to the remap of the
        live pool's backlog onto that candidate (survivors keep in-flight
        work, added cells start idle) — the live analogue of the
        simulator's warm candidate lanes.  Probes still never touch the
        carried episode state."""
        self._no_routing(policy)
        cs = self.candidate_state()
        if cs is None:
            return self.oracle(dist, factor)
        state, dep = cs
        probe = _prefix(self.workloads[dist].scaled(factor),
                        self.probe_queries)

        def evaluate(cfg) -> float:
            cfgt = tuple(int(c) for c in cfg)
            self.configure(cfgt)
            self.n_evals += 1
            total = sum(cfgt)
            rel = (np.asarray(state.remap(dep, cfgt, state.clock,
                                          warmup=self._cold_starts
                                          ).free[:total],
                              dtype=np.float64) - state.clock)
            return float(self.engine.serve(
                probe, self.qos_latency, time_scale=self.time_scale,
                initial_busy=rel * self.time_scale))
        return evaluate

    def phase_sweep(self, config, phases, *, policy=None,
                    states=None) -> None:
        return None                      # re-serving every phase is not free


def paper_simulator_plane(model_name: str, spec: ScenarioSpec,
                          max_instances: int = 40,
                          stream_chunk: int | None = None, device=None):
    """(plane, space) for a named paper model: Table 3 diverse pool, the
    standard per-model stream for every batch distribution the spec's
    phases use (shared arrivals from ``spec.seed``), and the default
    search-space bounds.  ``stream_chunk`` bounds per-segment simulator
    memory for long episodes (see ``SimulatorPlane``); the simulators run
    on ``device`` (default ``cuda``)."""
    profile = MODEL_PROFILES[model_name]
    types = [AWS_INSTANCES[n] for n in PAPER_POOLS[model_name]["diverse"]]
    workloads = {d: paper_workload(model_name, seed=spec.seed,
                                   n_queries=spec.n_base_queries,
                                   batch_dist=d)
                 for d in spec.batch_dists}
    plane = SimulatorPlane(profile, types, workloads,
                           max_instances=max_instances,
                           stream_chunk=stream_chunk, device=device)
    prices = tuple(t.price for t in types)
    space = SearchSpace(bounds=DEFAULT_BOUNDS[model_name], prices=prices)
    return plane, space


def tiered_simulator_plane(model_name: str, spec: ScenarioSpec,
                           max_instances: int = 40,
                           stream_chunk: int | None = None, device=None):
    """(plane, space) for a named model on its hybrid capacity-tier pool
    (serving/tiers.TIERED_POOLS): the same per-model streams as
    ``paper_simulator_plane``, but the pool mixes on-demand, spot and
    serverless procurements of the paper hardware.  The plane charges
    per-tier cold starts through the carry and exposes per-type risk
    premiums (``cost_penalties``) to the engine's BO; the search space
    keeps *market* prices for billing."""
    profile = MODEL_PROFILES[model_name]
    types, bounds = tiered_pool(model_name)
    catalog = TierCatalog(types)
    workloads = {d: paper_workload(model_name, seed=spec.seed,
                                   n_queries=spec.n_base_queries,
                                   batch_dist=d)
                 for d in spec.batch_dists}
    plane = SimulatorPlane(profile, types, workloads,
                           max_instances=max_instances, catalog=catalog,
                           stream_chunk=stream_chunk, device=device)
    prices = tuple(t.price for t in types)
    space = SearchSpace(bounds=bounds, prices=prices)
    return plane, space
