"""Named canonical episodes (counterpart of ``repro/scenario/registry.py``,
copied).

Each builder returns a :class:`ScenarioSpec` scaled by ``n`` (queries per
phase) and ``window`` (queries per monitoring window) so the same episode
runs as a CI smoke (small ``n``) or a full study.  Phases are prefixes of
one base stream per batch distribution, so every episode is deterministic
from its seed — including :func:`composite`, which *samples* its event
timeline from the seed (fuzz-style robustness sweeps over the other
builders' building blocks).

Episodes run under the engine's continuous-time clock: queue backlog
survives every control-plane cut these timelines inject, so the
capacity-loss episodes (``failure-storm``, ``spot-churn``) and the
traffic-surprise ones (``flash-crowd``) report the violation mass a
degraded pool actually accumulates while replacements provision — not the
optimistic idle-restart view (``ScenarioEngine(carry_queue_state=False)``
replays that as a baseline).

The tier episodes (``spot-storm``, ``tier-outage``) exercise the hybrid
capacity-tier surface (serving/tiers.py): their timelines are generated by
the tier's seeded hazard / spot-price processes and inject the tier-scoped
event kinds (correlated ``preemption_storm``, full ``tier_outage``,
tier-wide ``price_spike``).  On a plane without tiered types those events
are no-ops that recover trivially — run them on
``planes.tiered_simulator_plane`` to mean anything.
"""

from __future__ import annotations

import numpy as np

from ..serving.tiers import SpotPriceProcess, TierHazard
from .spec import EventSpec, PhaseSpec, ScenarioSpec, fuzz_kinds


def diurnal(n: int = 500, window: int = 100, seed: int = 0,
            qos_target: float = 0.99) -> ScenarioSpec:
    """Day/night traffic swing: no injected events — every adaptation is
    monitor-detected (up on the morning ramp, down on the evening fall)."""
    return ScenarioSpec(
        name="diurnal", seed=seed, qos_target=qos_target, window=window,
        phases=(
            PhaseSpec("night", n, load_factor=0.7),
            PhaseSpec("morning", n, load_factor=1.0),
            PhaseSpec("peak", n, load_factor=1.4),
            PhaseSpec("evening", n, load_factor=1.0),
            PhaseSpec("late-night", n, load_factor=0.6),
        ))


def diurnal_day(n: int = 200_000, window: int = 20_000, seed: int = 0,
                qos_target: float = 0.99) -> ScenarioSpec:
    """The diurnal swing at day scale: the same five phases, sized so the
    default build streams a ~million-query episode end to end.  Meant for
    the streaming plane (``SimulatorPlane(stream_chunk=...)``):
    constant-memory chunked serving with the carry threaded across blocks.  Budgets are trimmed and per-window
    enrichment disabled — at this scale the point is throughput of the
    serving path, not control-plane telemetry detail."""
    return ScenarioSpec(
        name="diurnal-day", seed=seed, qos_target=qos_target, window=window,
        init_budget=25, rescale_budget=12, recover_budget=12,
        window_stats=False,
        phases=(
            PhaseSpec("night", n, load_factor=0.7),
            PhaseSpec("morning", n, load_factor=1.0),
            PhaseSpec("peak", n, load_factor=1.4),
            PhaseSpec("evening", n, load_factor=1.0),
            PhaseSpec("late-night", n, load_factor=0.6),
        ))


def flash_crowd(n: int = 500, window: int = 100, seed: int = 0,
                qos_target: float = 0.99,
                routed: bool = False) -> ScenarioSpec:
    """A sudden mid-phase traffic spike (paper §5.5's load change, but
    injected *inside* a phase so detection latency is measured).

    ``routed=True`` arms the reroute-before-rescale control move: on the
    surge the engine first warm-sweeps the incumbent pool under every
    named routing policy (serving/routing.NAMED_POLICIES) in one stacked
    dispatch, and only falls back to a BO re-search when no router alone
    restores QoS."""
    return ScenarioSpec(
        name="flash-crowd" + ("-routed" if routed else ""),
        seed=seed, qos_target=qos_target, window=window,
        phases=(
            PhaseSpec("steady", n, load_factor=1.0),
            PhaseSpec("surge", n, load_factor=1.0),
            PhaseSpec("cooldown", n, load_factor=1.0),
        ),
        events=(
            EventSpec("load_spike", phase=1, at_frac=0.3, factor=1.6),
        ),
        route_policies=(("fcfs", "cost_aware", "affinity", "hedged")
                        if routed else ()))


def spot_churn(n: int = 500, window: int = 100, seed: int = 0,
               qos_target: float = 0.99) -> ScenarioSpec:
    """Spot-market churn: the anchor type is preempted mid-phase (capacity
    returns at the next phase boundary), then repriced upward — the
    KAIROS/INFaaS heterogeneous-pool economics regime."""
    return ScenarioSpec(
        name="spot-churn", seed=seed, qos_target=qos_target, window=window,
        provision_queries=window,
        phases=(
            PhaseSpec("steady", n, load_factor=1.0),
            PhaseSpec("churn", n, load_factor=1.0),
            PhaseSpec("restored", n, load_factor=1.0),
        ),
        events=(
            EventSpec("spot_preemption", phase=1, at_frac=0.4, type_index=0,
                      count=2),
            EventSpec("price_change", phase=2, at_frac=0.5, type_index=0,
                      factor=1.25),
        ))


def failure_storm(n: int = 500, window: int = 100, seed: int = 0,
                  qos_target: float = 0.99) -> ScenarioSpec:
    """Correlated node losses across consecutive phases; capacity never
    comes back, so the pool must re-optimize over a shrinking space."""
    return ScenarioSpec(
        name="failure-storm", seed=seed, qos_target=qos_target,
        window=window, provision_queries=window,
        phases=(
            PhaseSpec("calm", n, load_factor=1.0),
            PhaseSpec("first-loss", n, load_factor=1.0),
            PhaseSpec("second-loss", n, load_factor=1.0),
        ),
        events=(
            EventSpec("cell_failure", phase=1, at_frac=0.4, type_index=0,
                      count=1),
            EventSpec("cell_failure", phase=2, at_frac=0.4, type_index=1,
                      count=2),
        ))


def spot_storm(n: int = 500, window: int = 100, seed: int = 0,
               qos_target: float = 0.99) -> ScenarioSpec:
    """Spot-market weather: the episode's storm timeline is *drawn from the
    spot tier's own hazard process* (serving/tiers.TierHazard — exponential
    interarrivals on the absolute phase axis, at least one storm, final
    phase storm-free so losses restock in-episode) and its price timeline
    from the seeded spot price walk (SpotPriceProcess).  Each storm is a
    correlated same-tier kill; preempted capacity restocks at the next
    phase boundary, re-entering the same hazard timeline."""
    n_phases = 4
    phases = tuple(PhaseSpec(f"weather{p}", n, load_factor=1.0)
                   for p in range(n_phases))
    events = [EventSpec("preemption_storm", phase=ph, at_frac=round(af, 3),
                        tier="spot", factor=round(kill, 3))
              for ph, af, kill in TierHazard("spot", seed, n_phases).storms()]
    events += [EventSpec("price_spike", phase=ph, at_frac=round(af, 3),
                         tier="spot", factor=round(f, 3))
               for ph, af, f in SpotPriceProcess(seed).events(n_phases)]
    return ScenarioSpec(name="spot-storm", seed=seed, qos_target=qos_target,
                        window=window, provision_queries=window,
                        phases=phases,
                        events=tuple(sorted(events,
                                            key=lambda e: (e.phase,
                                                           e.at_frac))))


def tier_outage(n: int = 500, window: int = 100, seed: int = 0,
                qos_target: float = 0.99) -> ScenarioSpec:
    """The entire spot tier evaporates mid-episode (an AZ-wide capacity
    crunch): every spot type's full bounds are lost at once, the engine
    degrades to the surviving tiers (over-provisioning on-demand when no
    feasible pool remains), and the market returns the tier at the next
    phase boundary — straight into a price spike."""
    return ScenarioSpec(
        name="tier-outage", seed=seed, qos_target=qos_target, window=window,
        provision_queries=window,
        phases=(
            PhaseSpec("steady", n, load_factor=1.0),
            PhaseSpec("outage", n, load_factor=1.0),
            PhaseSpec("squeeze", n, load_factor=1.0),
            PhaseSpec("restored", n, load_factor=1.0),
        ),
        events=(
            EventSpec("tier_outage", phase=1, at_frac=0.35, tier="spot"),
            EventSpec("price_spike", phase=2, at_frac=0.5, tier="spot",
                      factor=1.3),
        ))


def dist_drift(n: int = 500, window: int = 100, seed: int = 0,
               qos_target: float = 0.99,
               bucketed: bool = False) -> ScenarioSpec:
    """Batch-size distribution drift (paper Fig. 11): the arrival process is
    unchanged but the batch stream flips log-normal → Gaussian and back, so
    service times — and the optimal pool — move under the monitor's feet.

    ``bucketed=True`` drifts the *request-size mix* instead: the batch
    stream stays lognormal while the per-query bucket annotation flips
    small-skewed → large-skewed and back (``serving.pool.BUCKET_DIST_MIXES``).
    Either way the engine detects the move from measured waits, not from the
    spec's phase labels — a mislabeled spec still recovers."""
    if bucketed:
        return ScenarioSpec(
            name="dist-drift-bucketed", seed=seed, qos_target=qos_target,
            window=window,
            phases=(
                PhaseSpec("small", n, load_factor=1.0,
                          batch_dist="bucketed-small"),
                PhaseSpec("large", n, load_factor=1.0,
                          batch_dist="bucketed-large"),
                PhaseSpec("back", n, load_factor=1.0,
                          batch_dist="bucketed-small"),
            ))
    return ScenarioSpec(
        name="dist-drift", seed=seed, qos_target=qos_target, window=window,
        phases=(
            PhaseSpec("lognormal", n, load_factor=1.0,
                      batch_dist="lognormal"),
            PhaseSpec("gaussian", n, load_factor=1.0,
                      batch_dist="gaussian"),
            PhaseSpec("back", n, load_factor=1.0, batch_dist="lognormal"),
        ))


def composite(n: int = 500, window: int = 100, seed: int = 0,
              qos_target: float = 0.99, n_events: int = 4,
              tiered: bool = False) -> ScenarioSpec:
    """Randomized fuzz episode: a seeded timeline sampled from the event
    registry (``spec.fuzz_kinds`` — the single source the engine's dispatch
    table is checked against, so an unhandled kind can never slip into a
    fuzz run silently) over phases with randomized load factors.

    Sampling is fully determined by ``seed`` (one ``default_rng`` stream),
    so every composite replays bit-for-bit — a fuzz harness can sweep
    seeds and assert the continuous-clock invariants (every event recovers, finite carried backlog, warm
    violation mass >= the idle-restart baseline) on each one.  Sampling is
    constrained to keep episodes recoverable by construction: events land
    in the first 55% of a non-final phase, at most one spike per phase, at
    most two capacity losses per instance type (count 1 each), and spike /
    price factors stay in moderate ranges.

    ``tiered=True`` widens the draw to the tier-scoped kinds (correlated
    ``preemption_storm``, ``tier_outage``, ``price_spike``), all targeting
    the spot tier, with at most one storm and one outage per episode —
    meant for planes built by ``planes.tiered_simulator_plane``.  The
    default draw excludes them (they are no-ops on untiered planes) and its
    per-seed sequence is bit-identical to the legacy four-kind fuzz.
    """
    if n_events < 1:
        raise ValueError("n_events must be >= 1")
    rng = np.random.default_rng(seed)
    n_phases = int(min(n_events, 3)) + 1
    phases = tuple(
        PhaseSpec(f"phase{p}", n,
                  load_factor=round(float(rng.uniform(0.8, 1.1)), 3))
        for p in range(n_phases))
    kinds = fuzz_kinds(tiered=tiered)
    losses = {0: 0, 1: 0}
    spiked: set[int] = set()
    storms = outages = 0
    events = []
    for _ in range(int(n_events)):
        kind = str(rng.choice(kinds))
        phase = int(rng.integers(0, n_phases - 1))
        at = round(float(rng.uniform(0.15, 0.55)), 3)
        if kind == "load_spike" and phase not in spiked:
            spiked.add(phase)
            events.append(EventSpec("load_spike", phase=phase, at_frac=at,
                                    factor=round(float(rng.uniform(1.2,
                                                                   1.5)),
                                                 3)))
            continue
        if kind in ("cell_failure", "spot_preemption"):
            t = int(rng.integers(0, 2))
            if losses[t] < 2:
                losses[t] += 1
                events.append(EventSpec(kind, phase=phase, at_frac=at,
                                        type_index=t, count=1))
                continue
        if kind == "preemption_storm" and storms < 1:
            storms += 1
            events.append(EventSpec("preemption_storm", phase=phase,
                                    at_frac=at, tier="spot",
                                    factor=round(float(rng.uniform(0.4,
                                                                   0.7)),
                                                 3)))
            continue
        if kind == "tier_outage" and outages < 1:
            outages += 1
            events.append(EventSpec("tier_outage", phase=phase, at_frac=at,
                                    tier="spot"))
            continue
        if kind == "price_spike":
            events.append(EventSpec("price_spike", phase=phase, at_frac=at,
                                    tier="spot",
                                    factor=round(float(rng.uniform(0.8,
                                                                   1.6)),
                                                 3)))
            continue
        # Saturated samples (second spike in a phase, third loss of a type,
        # second storm/outage) degrade to a price change — always safe,
        # always recoverable.
        events.append(EventSpec("price_change", phase=phase, at_frac=at,
                                type_index=int(rng.integers(0, 2)),
                                factor=round(float(rng.uniform(0.7, 1.5)),
                                             3)))
    return ScenarioSpec(name="composite", seed=seed,
                        qos_target=qos_target, window=window,
                        provision_queries=window, phases=phases,
                        events=tuple(events))


EPISODES = {
    "diurnal": diurnal,
    "diurnal-day": diurnal_day,
    "flash-crowd": flash_crowd,
    "spot-churn": spot_churn,
    "failure-storm": failure_storm,
    "spot-storm": spot_storm,
    "tier-outage": tier_outage,
    "dist-drift": dist_drift,
    "dist-drift-bucketed": lambda **kw: dist_drift(bucketed=True, **kw),
    "composite": composite,
}


def build_episode(name: str, **kwargs) -> ScenarioSpec:
    """Instantiate a named episode (see :data:`EPISODES`)."""
    try:
        builder = EPISODES[name]
    except KeyError:
        raise KeyError(f"unknown episode {name!r}; known: "
                       f"{sorted(EPISODES)}") from None
    return builder(**kwargs)
