"""Declarative multi-phase traffic episodes (pure data).

A :class:`ScenarioSpec` generalizes the paper's §5.5 adaptation studies into
a long-running *episode*: an ordered sequence of traffic phases (length in
queries, load factor relative to the bound base workload, batch
distribution) plus a timeline of injected infrastructure events — the
interleaved regime heterogeneous-serving systems (KAIROS, INFaaS) are
evaluated under.  Events come in two scopes: *type-scoped* kinds hit one
instance type by index, *tier-scoped* kinds (``preemption_storm``,
``tier_outage``, ``price_spike``) hit every type procured on one capacity
tier at once — the correlated-failure surface serving/tiers.py models.

Every kind lives in :data:`EVENT_KIND_SPECS`, the **single event registry**:
``validate`` checks membership against it, the engine's dispatch table is
import-time-verified to cover it, and the fuzz builder draws its kinds from
it (``fuzz_kinds``) — adding a kind without wiring all three fails loudly
instead of silently never being exercised.

Specs are pure data: nothing here touches torch, the simulator, or the
live engine.  The scenario engine (engine.py) compiles a spec into the detection
→ adaptation event loop over an evaluation plane (planes.py), and the
registry (registry.py) names the canonical episodes.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class EventKind:
    """Registry entry for one event kind.

    ``capacity``     — the event destroys pool capacity (the engine books a
                       bounds shrink and, for transient kinds, a restock);
    ``tier_scoped``  — the event targets a capacity tier (``EventSpec.tier``)
                       instead of a single ``type_index``;
    ``fuzz``         — eligible for ``registry.composite`` sampling.
    """

    name: str
    capacity: bool = False
    tier_scoped: bool = False
    fuzz: bool = True


# Single source of truth for event kinds.  Order matters: ``fuzz_kinds``
# preserves it, and the non-tiered composite fuzz draw sequence is pinned
# seed-for-seed to the first four entries (the reference's fuzz harness).
EVENT_KIND_SPECS: dict[str, EventKind] = {
    "cell_failure": EventKind("cell_failure", capacity=True),
    "spot_preemption": EventKind("spot_preemption", capacity=True),
    "price_change": EventKind("price_change"),
    "load_spike": EventKind("load_spike"),
    "preemption_storm": EventKind("preemption_storm", capacity=True,
                                  tier_scoped=True),
    "tier_outage": EventKind("tier_outage", capacity=True, tier_scoped=True),
    "price_spike": EventKind("price_spike", tier_scoped=True),
}

EVENT_KINDS = tuple(EVENT_KIND_SPECS)
BATCH_DISTS = ("lognormal", "gaussian", "bucketed-small",
               "bucketed-large")


def fuzz_kinds(tiered: bool = False) -> tuple[str, ...]:
    """Event kinds the composite fuzz builder samples from, in registry
    order.  ``tiered=False`` excludes tier-scoped kinds (they are no-ops on
    planes without tiered types, and the legacy draw sequence stays
    bit-identical per seed)."""
    return tuple(name for name, kind in EVENT_KIND_SPECS.items()
                 if kind.fuzz and (tiered or not kind.tier_scoped))


@dataclass(frozen=True)
class PhaseSpec:
    """One traffic phase: a window of the episode with stationary load.

    The phase's query stream is the first ``n_queries`` of the episode base
    stream for ``batch_dist``, compressed by ``load_factor``
    (``Workload.scaled`` semantics: 1.5 = 1.5x heavier traffic).
    """

    name: str
    n_queries: int
    load_factor: float = 1.0
    batch_dist: str = "lognormal"


@dataclass(frozen=True)
class EventSpec:
    """One injected infrastructure event.

    Type-scoped kinds (target ``type_index``):
      * ``cell_failure``     — ``count`` instances of ``type_index`` die;
        capacity is gone for the rest of the episode.
      * ``spot_preemption``  — like a failure, but the market returns the
        capacity at the next phase boundary (the engine restocks).
      * ``price_change``     — the unit price of ``type_index`` is
        multiplied by ``factor``; QoS history stays valid, only the cost
        landscape moves.
      * ``load_spike``       — the remaining phase traffic is multiplied by
        ``factor``.  Unlike the capacity events (which the control plane is
        told about), a spike must be *detected* by the load monitor.

    Tier-scoped kinds (target every type procured on capacity tier
    ``tier`` — serving/tiers.py):
      * ``preemption_storm`` — a correlated kill: fraction ``factor`` of
        each tier type's *deployed* capacity is preempted at once; the
        market restocks the losses at the next phase boundary (which
        re-enters, not resets, the tier's hazard timeline).
      * ``tier_outage``      — the whole tier's capacity (its full search
        bounds) evaporates until the next phase boundary's restock.
      * ``price_spike``      — the tier's unit prices are multiplied by
        ``factor`` (spot-market drift/spike; see
        serving/tiers.SpotPriceProcess).

    ``at_frac`` positions the event within its phase's query stream.
    """

    kind: str
    phase: int
    at_frac: float = 0.5
    type_index: int = 0
    count: int = 1
    factor: float = 1.0
    tier: str = ""


@dataclass(frozen=True)
class ScenarioSpec:
    """A complete episode: phases + events + control-loop parameters."""

    name: str
    phases: tuple[PhaseSpec, ...]
    events: tuple[EventSpec, ...] = ()
    seed: int = 0
    qos_target: float = 0.99
    window: int = 100            # queries per monitoring window
    init_budget: int = 60        # BO evaluations for the initial search
    rescale_budget: int = 25     # per load-change adaptation
    recover_budget: int = 25     # per capacity/price adaptation
    batch_q: int = 8             # constant-liar batch size (grid planes)
    headroom: float = 1.05       # safety factor on estimated load upshifts
    # Queries served on the degraded pool before a capacity-event recovery
    # takes effect (cloud instances take time to boot).  0 = instantaneous.
    provision_queries: int = 0
    # Candidate routing policies (serving/routing.NAMED_POLICIES names) the
    # engine may switch the dispatch rule to *before* rescaling: on an
    # upshift violation it warm-sweeps the current pool under every
    # candidate in one dispatch and, if some router restores QoS, reroutes
    # (0 BO evaluations) instead of re-searching the pool.  () disables.
    route_policies: tuple[str, ...] = ()
    # Enrich every WindowStat with telemetry-derived stats (latency
    # percentiles from the log-bucket histogram, per-type utilization and
    # QoS-miss attribution) on planes that expose a telemetry source
    # (serving/telemetry.py).  Pure reporting: control decisions never
    # read these fields.
    window_stats: bool = True

    def validate(self) -> "ScenarioSpec":
        if not self.phases:
            raise ValueError("a scenario needs at least one phase")
        for p, ph in enumerate(self.phases):
            if ph.n_queries < 1:
                raise ValueError(f"phase {p} ({ph.name}): n_queries < 1")
            if not ph.load_factor > 0:
                raise ValueError(f"phase {p} ({ph.name}): load_factor <= 0")
            if ph.batch_dist not in BATCH_DISTS:
                raise ValueError(f"phase {p} ({ph.name}): unknown "
                                 f"batch_dist {ph.batch_dist!r}")
        for e in self.events:
            kind = EVENT_KIND_SPECS.get(e.kind)
            if kind is None:
                raise ValueError(f"unknown event kind {e.kind!r}")
            if not 0 <= e.phase < len(self.phases):
                raise ValueError(f"event {e.kind}: phase {e.phase} out of "
                                 f"range for {len(self.phases)} phases")
            if not 0.0 <= e.at_frac < 1.0:
                raise ValueError(f"event {e.kind}: at_frac must be in "
                                 f"[0, 1), got {e.at_frac}")
            if e.type_index < 0:
                raise ValueError(f"event {e.kind}: type_index must be >= 0, "
                                 f"got {e.type_index}")
            if kind.tier_scoped:
                # Imported here so plain specs keep this module pure data.
                from ..serving.tiers import TIER_NAMES
                if e.tier not in TIER_NAMES:
                    raise ValueError(
                        f"event {e.kind}: tier must be one of {TIER_NAMES}, "
                        f"got {e.tier!r}")
            elif e.tier:
                raise ValueError(f"event {e.kind}: tier is only valid for "
                                 "tier-scoped kinds")
            if e.kind in ("cell_failure", "spot_preemption") and e.count < 1:
                raise ValueError(f"event {e.kind}: count must be >= 1")
            if e.kind in ("price_change", "load_spike") and not e.factor > 0:
                raise ValueError(f"event {e.kind}: factor must be > 0")
            if e.kind == "preemption_storm" and not 0.0 < e.factor <= 1.0:
                raise ValueError(f"event {e.kind}: factor is the kill "
                                 f"fraction, must be in (0, 1], got "
                                 f"{e.factor}")
            if e.kind == "price_spike" and not e.factor > 0:
                raise ValueError(f"event {e.kind}: factor must be > 0")
        if self.route_policies:
            # Imported here so plain specs keep this module pure data
            # (same pattern as the TIER_NAMES check above).
            from ..serving.routing import NAMED_POLICIES
            for name in self.route_policies:
                if name not in NAMED_POLICIES:
                    raise ValueError(
                        f"unknown routing policy {name!r} in route_policies;"
                        f" known: {NAMED_POLICIES}")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.provision_queries < 0:
            raise ValueError("provision_queries must be >= 0")
        if not self.qos_target > 0:
            raise ValueError("qos_target must be > 0")
        return self

    # ------------------------------------------------------------- queries
    @property
    def n_base_queries(self) -> int:
        """Length of the episode base stream (phases are prefixes of it)."""
        return max(ph.n_queries for ph in self.phases)

    @property
    def batch_dists(self) -> tuple[str, ...]:
        """Distinct batch distributions, in first-phase order."""
        out: list[str] = []
        for ph in self.phases:
            if ph.batch_dist not in out:
                out.append(ph.batch_dist)
        return tuple(out)

    def events_in_phase(self, phase: int) -> list[EventSpec]:
        """Events of one phase, in stream order."""
        return sorted((e for e in self.events if e.phase == phase),
                      key=lambda e: e.at_frac)


@dataclass
class Timeline:
    """Compiled view of a spec: per-phase event cut positions.

    ``cuts[p]`` is the list of (query index within phase, EventSpec) pairs,
    sorted by position — the segment boundaries the engine iterates.
    """

    cuts: list[list[tuple[int, EventSpec]]] = field(default_factory=list)

    @classmethod
    def compile(cls, spec: ScenarioSpec) -> "Timeline":
        cuts = []
        for p, ph in enumerate(spec.phases):
            cuts.append([(int(e.at_frac * ph.n_queries), e)
                         for e in spec.events_in_phase(p)])
        return cls(cuts=cuts)
