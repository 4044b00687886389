"""Capacity tiers: serverless / spot / on-demand procurement economics.

RIBBON's diversity story (paper §3) is about *hardware* heterogeneity; this
module adds the orthogonal **capacity-tier** axis that public-cloud serving
actually buys capacity on (Gunasekaran et al., INFaaS): the same hardware can
be procured

  * **on_demand** — full price, stable, minutes-scale provisioning;
  * **spot**      — deep discount, but interruptible: a seeded hazard process
                    emits correlated *preemption storms* that kill a fraction
                    of everything deployed in the tier at once, and the spot
                    market reprices between phases;
  * **serverless** — premium price, near-instant start, never preempted — the
                    backstop tier when spot evaporates.

Three deterministic processes hang off a tier:

  * cold start — a slot *added* to the pool mid-episode starts busy for its
    tier's cold-start time.  This is priced bit-exactly through the existing
    ``PoolState`` carry: ``PoolState.remap(..., warmup=...)`` seeds the new
    slot's next-free time at ``now + cold_start`` instead of ``now``, so the
    backlog a waking pool accrues flows through the same warm lanes as any
    other queue debt.
  * interruption hazard — ``TierHazard`` samples storm instants from a seeded
    exponential-interarrival process on the *absolute* episode phase axis.
    Because the axis is absolute, capacity restocked after a storm re-enters
    the same timeline: a later storm hits it again.  Restocking never resets
    the hazard clock.
  * price process — ``SpotPriceProcess`` emits per-phase drift/spike
    multipliers for the spot market, consumed by the ``price_spike`` scenario
    event.

``TierCatalog`` is the bridge to the search layer: per-type cold-start
seconds for the warm lanes, and per-type **risk premiums** added to the BO's
cost landscape (see :meth:`TierCatalog.cost_penalties`) so the portfolio
search weighs spot's discount against its expected interruption and
cold-start debt instead of seeing only the sticker price.

Counterpart of ``repro/serving/tiers.py`` (numpy only), copied so that the
port imports nothing of the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .instance import AWS_INSTANCES, InstanceType, ModelProfile


@dataclass(frozen=True)
class CapacityTier:
    """Economics of one procurement tier.

    ``cold_start_qos`` is expressed in multiples of the served model's QoS
    latency target so one catalog works for a 20 ms recsys model and an
    800 ms VGG alike; ``interrupt_rate`` is expected storms per episode
    phase; ``kill_fraction`` the correlated fraction of deployed capacity a
    storm takes; ``price_factor`` multiplies the base on-demand price.
    """

    name: str
    cold_start_qos: float
    interrupt_rate: float
    kill_fraction: float
    price_factor: float


TIERS: dict[str, CapacityTier] = {
    # Stable anchor: slow-ish provisioning, never preempted.
    "on_demand": CapacityTier("on_demand", cold_start_qos=5.0,
                              interrupt_rate=0.0, kill_fraction=0.0,
                              price_factor=1.0),
    # Deep discount, slow to warm, and the only tier the hazard touches.
    # Cold starts are scaled so a spot wake costs a couple of monitoring
    # windows of QoS debt — painful, but recoverable inside a phase.
    "spot": CapacityTier("spot", cold_start_qos=12.0,
                         interrupt_rate=1.2, kill_fraction=0.6,
                         price_factor=0.35),
    # Premium per hour, near-instant start, preemption-free backstop.
    "serverless": CapacityTier("serverless", cold_start_qos=1.0,
                               interrupt_rate=0.0, kill_fraction=0.0,
                               price_factor=1.75),
}

TIER_NAMES: tuple[str, ...] = tuple(TIERS)

# Weight of the cold-start term in the risk premium: a tier's cold start is
# paid in queue backlog (in kind, through the warm carry), so the $ premium
# only amortizes the *re-warm churn* a pool expects over an hour of serving.
_COLD_AMORTIZATION = 1e-3


class TierHazard:
    """Deterministic seeded interruption-storm process for one tier.

    Storm instants are exponential interarrivals (rate = the tier's
    ``interrupt_rate`` per phase) on the **absolute** phase axis
    ``[0, n_phases - 1)`` — the final phase is storm-free so every loss can
    restock in-episode.  The axis being absolute is the point: restocked
    capacity re-enters the same timeline and later storms hit it again; the
    hazard clock never resets on restock.  At most one storm lands per phase
    (the correlated kill already models the within-phase burst).
    """

    def __init__(self, tier: str, seed: int, n_phases: int,
                 rate: float | None = None):
        spec = TIERS[tier]
        self.tier = tier
        self.seed = int(seed)
        self.n_phases = int(n_phases)
        self.rate = spec.interrupt_rate if rate is None else float(rate)
        self.kill_fraction = spec.kill_fraction

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng([self.seed, TIER_NAMES.index(self.tier)])

    def storms(self) -> list[tuple[int, float, float]]:
        """``[(phase, at_frac, kill_fraction), ...]`` — one entry per storm,
        sorted by phase, at least one storm whenever the rate is positive."""
        if self.rate <= 0.0 or self.n_phases < 2:
            return []
        rng = self._rng()
        horizon = float(self.n_phases - 1)
        times: list[float] = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / self.rate))
            if t >= horizon:
                break
            times.append(t)
        if not times:
            # Storm-guarantee: an episode built on this hazard must exercise
            # the recovery path even for unlucky seeds.
            times = [float(rng.uniform(0.0, horizon))]
        out: list[tuple[int, float, float]] = []
        seen_phases: set[int] = set()
        for t in times:
            phase = int(t)
            if phase in seen_phases:
                continue
            seen_phases.add(phase)
            at_frac = 0.15 + 0.4 * (t - phase)
            kill = float(np.clip(self.kill_fraction * rng.uniform(0.85, 1.15),
                                 0.05, 0.95))
            out.append((phase, float(at_frac), kill))
        return sorted(out)


class SpotPriceProcess:
    """Seeded spot-market price walk: per-phase drift plus rare spikes.

    ``events(n_phases)`` yields ``(phase, at_frac, factor)`` multipliers for
    the ``price_spike`` scenario event.  Factors are *cumulative* (the engine
    applies each multiplicatively to the live price), so the walk is clipped
    to keep the cumulative level inside ``band``.
    """

    def __init__(self, seed: int, drift: float = 0.08,
                 spike_prob: float = 0.35,
                 spike_mag: tuple[float, float] = (1.25, 1.6),
                 band: tuple[float, float] = (0.6, 1.8)):
        self.seed = int(seed)
        self.drift = float(drift)
        self.spike_prob = float(spike_prob)
        self.spike_mag = spike_mag
        self.band = band

    def events(self, n_phases: int) -> list[tuple[int, float, float]]:
        rng = np.random.default_rng([self.seed, len(TIER_NAMES)])
        out: list[tuple[int, float, float]] = []
        level = 1.0
        for phase in range(max(0, int(n_phases) - 1)):
            factor = float(np.exp(rng.normal(0.0, self.drift)))
            if rng.uniform() < self.spike_prob:
                factor *= float(rng.uniform(*self.spike_mag))
            target = float(np.clip(level * factor, *self.band))
            factor = target / level
            level = target
            if abs(factor - 1.0) < 0.02:
                continue
            out.append((phase, float(rng.uniform(0.3, 0.6)), factor))
        return out


class TierCatalog:
    """Tier view over a concrete pool of :class:`InstanceType`."""

    def __init__(self, types):
        self.types = tuple(types)
        self.tiers = tuple(getattr(t, "tier", "on_demand") for t in self.types)
        unknown = sorted(set(self.tiers) - set(TIER_NAMES))
        if unknown:
            raise ValueError(f"unknown capacity tiers {unknown}; "
                             f"expected one of {TIER_NAMES}")

    def tier_indices(self, tier: str) -> tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.tiers) if t == tier)

    def cold_starts(self, profile: ModelProfile) -> np.ndarray:
        """Per-type cold-start seconds — the ``warmup`` vector the warm
        ``*_from`` lanes seed newly added slots with."""
        return np.asarray(
            [TIERS[t].cold_start_qos * profile.qos_latency for t in self.tiers],
            dtype=np.float64)

    def cost_penalties(self) -> tuple[float, ...]:
        """Per-type additive $/h risk premium for the BO cost landscape.

        Documented heuristic, two terms per type:

        * expected interruption loss — ``price * interrupt_rate *
          kill_fraction``: the share of paid-for capacity the tier's hazard
          is expected to destroy (and that recovery must re-buy) per unit
          time;
        * cold-start amortization — ``price * cold_start_qos *
          _COLD_AMORTIZATION``: the re-warm churn of a tier that keeps
          scaling from zero.  (The backlog itself is paid in kind through
          the warm carry; this is only the churn premium.)

        The engine keeps *market* prices for window-cost accounting; only
        the optimizer's objective sees the risk-adjusted landscape.
        """
        out = []
        for ty, tier in zip(self.types, self.tiers):
            spec = TIERS[tier]
            out.append(ty.price * (spec.interrupt_rate * spec.kill_fraction
                                   + _COLD_AMORTIZATION * spec.cold_start_qos))
        return tuple(float(p) for p in out)


_TIER_SUFFIX = {"on_demand": "od", "spot": "spot", "serverless": "sls"}


def tiered_variant(base: InstanceType, tier: str) -> InstanceType:
    """The same hardware procured on a different tier: identical roofline,
    tier-scaled price, ``name`` suffixed so the two coexist in one pool.
    (``ModelProfile.eff`` resolves ``"g4dn:spot"`` back to ``"g4dn"``.)"""
    spec = TIERS[tier]
    return replace(base, name=f"{base.name}:{_TIER_SUFFIX[tier]}",
                   price=base.price * spec.price_factor, tier=tier)


# Hybrid pools per model: (base instance, tier, per-type bound).  The spot
# twin of the QoS anchor carries the bulk between storms; on-demand anchors
# tail QoS through storms; serverless is the outage backstop.
TIERED_POOLS: dict[str, tuple[tuple[str, str, int], ...]] = {
    "mtwnd": (("g4dn", "on_demand", 8), ("g4dn", "spot", 8),
              ("c5", "on_demand", 8), ("c5", "serverless", 6)),
    "dien":  (("g4dn", "on_demand", 8), ("g4dn", "spot", 8),
              ("c5", "on_demand", 8), ("c5", "serverless", 6)),
}


def tiered_pool(model_name: str) -> tuple[list[InstanceType], tuple[int, ...]]:
    """(types, bounds) of the hybrid capacity-tier pool for a model."""
    entries = TIERED_POOLS[model_name]
    types = [tiered_variant(AWS_INSTANCES[name], tier)
             for name, tier, _ in entries]
    bounds = tuple(int(b) for _, _, b in entries)
    return types, bounds
