"""Batched FCFS queueing simulator over heterogeneous pools.

The paper's serving discipline (§5.1): queries are served first come,
first served; an arriving query takes the first idle instance in the
pool's type order, or else waits for the instance that frees first.

Counterpart of ``repro/serving/simulator.py``.  Every lane here runs one
dispatch of ``kernels.ops.fcfs_scan`` (on the card, the CUDA kernel
``csrc/fcfs_scan.cu``; on the CPU, its plain version), padded to
``max_instances`` slots per pool:

* the **single** lane: one pool, ``configs`` (n_types,);
* the **batch** lane: B pools in one dispatch, ``configs`` (B, n_types);
* the **grid** lane: W load levels (``workloads=``, each the bound stream
  compressed as ``Workload.scaled`` does) × B pools in one dispatch,
  optionally with one service table per load level
  (``service_tables=``).

Each lane runs cold (every pool idle at the stream's start) or warm from a
continuous-clock carry: ``state=`` (a :class:`PoolState`) starts the scan
from that carry, ``deployed=``/``now=``/``warmup=`` remap it per candidate
(``PoolState.remap_batch``: the what-if carry of redeploying the live pool
as each candidate), and the ``states=`` grid starts each workload row from
its own carry, one ``free0`` row per workload row in the kernel.
``segment_from`` serves one pool as a segment whose carry after any prefix
is exact (``SegmentResult.state_at``), from the kernel's dispatch trace.
``policy=`` (a :class:`~repro_torch.serving.routing.RoutingPolicy`) routes
the dispatch on any lane, through the kernel's routed flavour; a stacked
policy folds P policies into the lane axis (P·B lanes, policy-major).
``telemetry=True`` returns a
:class:`~repro_torch.serving.telemetry.Telemetry` per lane: from the
kernel's in-carry counters on the batch and grid lanes, from the dispatch
trace on the host on the single and segment lanes, as the reference.

Latencies, rates, counts, carries and telemetry are the reference's bit
for bit on the same arrays: the scan's float32 arithmetic is the same
(the routed keys one fused multiply-add each, ROADMAP C-R18), the slot
layout, remaps and telemetry finalisation are the same numpy code, and the
rates are the same host float64 mean (the single lane and the warm batch
lane) or the same device counts against the float32 threshold
(``_qos_threshold_f32``: the cold batch lane and the grid lane, which copy
no latencies to the host), equal to that mean bit for bit.  All-zero
configs serve nothing: +inf latencies, rate 0, zero telemetry.

Not ported yet, refused with ``NotImplementedError`` naming its ROADMAP
item: the streaming simulator (A-10).  The reference's deprecated aliases
(``latencies*``, ``qos_rate*``, ``*_from``) are not ported: ``simulate``
and ``qos`` take every lane.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import fcfs_scan as _fcfs
from ..kernels import ops
from .instance import InstanceType, ModelProfile, service_table_for
from .routing import RoutingPolicy
from .telemetry import Telemetry, from_arrays, queue_depth
from .workload import Workload

_INF = 1e30
# Offset ranking idle slots strictly below any busy slot's next-free time:
# far above any simulated timestamp, and small enough that float32 keeps
# unit-spaced priorities distinct after the shift (ulp(1e6) = 0.0625).  The
# kernel's own constant.
_BIG = _fcfs.BIG
# Guarded horizon of one scan: beyond it float32 timestamps are too coarse
# for the dispatch key; exceeding it raises.
_MAX_HORIZON = _BIG / 8.0
# Rank-band separator of the routed idle key: ``(pref + affinity·svc) ·
# _TIE + priority``; a power of two, so the identity policy's key is exactly
# ``priority`` (the kernel's own constant).
_TIE = _fcfs.TIE


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def _check_horizon(t_max: float, context: str) -> None:
    if t_max > _MAX_HORIZON:
        raise ValueError(
            f"{context}: simulation horizon {t_max:.4g}s exceeds the safe "
            f"dispatch-priority envelope ({_MAX_HORIZON:.4g}s = _BIG/8); "
            "float32 timestamps this large corrupt the fused idle-vs-busy "
            "dispatch key.  Rebase the episode clock so segment-local times "
            "stay small (PoolState.rebased), or split the stream.")


def _qos_threshold_f32(qos_latency: float) -> float:
    """Largest float32 ``t`` with {f32 x: x <= t} == {f32 x: x <= qos}: the
    device's float32 comparison then admits exactly the latencies the
    host's float64 comparison admits."""
    t = np.float32(qos_latency)
    if float(t) > qos_latency:
        t = np.nextafter(t, np.float32(-np.inf))
    return float(t)


def _cold_free0(active: np.ndarray) -> np.ndarray:
    """(..., S) float32 idle initial carry: 0 for active slots, _INF for
    absent ones."""
    return np.where(active, np.float32(0.0), np.float32(_INF))


def _expand_slots(configs, n_types: int,
                  max_instances: int) -> tuple[np.ndarray, np.ndarray]:
    """Config→slot expansion for a (B, n_types) batch: slot ``s`` of row
    ``b`` holds type ``t`` iff ``cumsum(configs[b])[t-1] <= s <
    cumsum(configs[b])[t]``.  Returns (type_of_slot (B, max_inst) int32,
    active (B, max_inst) bool)."""
    counts = np.asarray(configs, dtype=np.int64)
    if counts.ndim != 2 or counts.shape[1] != n_types:
        raise ValueError(f"expected (B, {n_types}) config batch, "
                         f"got shape {counts.shape}")
    cum = np.cumsum(counts, axis=1)                      # (B, T)
    total = cum[:, -1]
    if (total > max_instances).any():
        raise ValueError("config exceeds max_instances padding")
    slots = np.arange(max_instances)
    active = slots[None, :] < total[:, None]             # (B, S)
    type_of_slot = (slots[None, None, :] >= cum[:, :, None]).sum(
        axis=1).astype(np.int32)                         # (B, S)
    return np.where(active, type_of_slot, 0).astype(np.int32), active


def _fold_policy(policy: RoutingPolicy, type_of_slot: np.ndarray,
                 free0: np.ndarray) -> tuple:
    """Fold a policy's (optional) stacked axis into the lane axis.

    ``type_of_slot`` (B, S) int32 and ``free0`` (B, S) are the batch lane
    operands; the per-type preference table is gathered to per-slot rows
    here, so the kernel never indexes by type for it.  Returns
    ``(type_of_slot, free0, pref_slot, affinity, hedge, n_policies)`` with
    a P·B lane axis for a stacked policy — policy-major, lane ``p·B + b``
    is (policy ``p``, config ``b``) — and the original B lanes otherwise.
    """
    pref = np.asarray(policy.type_pref, dtype=np.float32)
    n_b, n_s = type_of_slot.shape
    if pref.ndim == 1:
        return (type_of_slot, free0, pref[type_of_slot],
                np.full(n_b, policy.affinity, dtype=np.float32),
                np.full(n_b, policy.hedge, dtype=np.float32), 1)
    n_p = len(pref)
    return (np.tile(type_of_slot, (n_p, 1)), np.tile(free0, (n_p, 1)),
            pref[:, type_of_slot].reshape(n_p * n_b, n_s),
            np.repeat(np.asarray(policy.affinity, dtype=np.float32), n_b),
            np.repeat(np.asarray(policy.hedge, dtype=np.float32), n_b), n_p)


def _telemetry(tel: torch.Tensor, n_types: int, zero=None,
               shape=None) -> Telemetry:
    """A host :class:`Telemetry` from the kernel's (..., L, width) int32
    counters (int32 → int64), zeroing the lanes of all-zero configs (they
    serve nothing) and optionally unfolding a stacked-policy lane axis to
    ``shape``."""
    served, miss, busy, lath, waith, dsum, dpeak = [
        np.asarray(x.cpu().numpy(), dtype=np.int64)
        for x in _fcfs.split_tel(tel, n_types)]
    if zero is not None and np.asarray(zero).any():
        for a in (served, miss, busy, lath, waith):
            a[..., zero, :] = 0
        dsum[..., zero] = 0
        dpeak[..., zero] = 0
    if shape is not None:
        served, miss, busy, lath, waith = (
            a.reshape(shape + a.shape[-1:])
            for a in (served, miss, busy, lath, waith))
        dsum, dpeak = dsum.reshape(shape), dpeak.reshape(shape)
    return Telemetry(served=served, miss=miss, busy_ms=busy, lat_hist=lath,
                     wait_hist=waith, depth_sum=dsum, depth_peak=dpeak)


@dataclass(frozen=True)
class PoolState:
    """Continuous-time carry of an FCFS pool between simulation segments.

    ``free`` holds one next-free time per instance slot in **episode time**
    (float64, monotone across the whole episode); ``clock`` is the episode
    time of the currently bound stream's local ``t=0``, so a scan over
    local arrivals starts from ``free - clock``.  Slots beyond the active
    pool carry placeholder times that no entry point reads.
    """

    free: np.ndarray            # (max_instances,) float64 episode next-free
    clock: float = 0.0          # episode time of the local stream origin

    @classmethod
    def idle(cls, max_instances: int, clock: float = 0.0) -> "PoolState":
        """Fully drained pool: every slot free at ``clock``."""
        return cls(free=np.full(max_instances, float(clock),
                                dtype=np.float64),
                   clock=float(clock))

    def rebased(self, delta: float) -> "PoolState":
        """Shift the local-time origin ``delta`` episode seconds forward
        (a phase boundary, or a stream rebuilt mid-phase); the episode-time
        facts (``free``) are untouched, only the mapping moves."""
        return PoolState(free=self.free, clock=self.clock + float(delta))

    def remap(self, old_config, new_config, now: float,
              warmup=None) -> "PoolState":
        """Thread slot state through a pool reconfiguration at episode time
        ``now``: per type, the first ``min(old, new)`` slots survive with
        their in-flight work, removed slots drop theirs, and added slots
        start idle at ``now`` — or, with ``warmup`` (per-type seconds of
        cold start), busy until ``now + warmup[t]``."""
        old = np.asarray(old_config, dtype=np.int64)
        new = np.asarray(new_config, dtype=np.int64)
        if old.shape != new.shape or old.ndim != 1:
            raise ValueError("old/new configs must be 1-D with equal length")
        if old.sum() > len(self.free) or new.sum() > len(self.free):
            raise ValueError("config exceeds the state's slot padding")
        free = np.full_like(self.free, float(now))
        oc = np.concatenate([[0], np.cumsum(old)])
        nc = np.concatenate([[0], np.cumsum(new)])
        if warmup is not None:
            w = np.asarray(warmup, dtype=np.float64)
            if w.shape != new.shape:
                raise ValueError("warmup must give one per-type cold-start "
                                 "time matching the config length")
            for t in range(len(new)):
                free[nc[t]:nc[t + 1]] = float(now) + w[t]
        for t in range(len(old)):
            k = int(min(old[t], new[t]))
            free[nc[t]:nc[t] + k] = self.free[oc[t]:oc[t] + k]
        return PoolState(free=free, clock=self.clock)

    def remap_batch(self, old_config, new_configs, now: float,
                    warmup=None) -> np.ndarray:
        """Vectorized what-if remap: row ``b`` of the returned
        ``(B, n_slots)`` float64 matrix equals ``remap(old_config,
        new_configs[b], now, warmup).free`` exactly — the warm batch and
        grid lanes' initial carries from one live pool's state."""
        old = np.asarray(old_config, dtype=np.int64)
        new = np.asarray(new_configs, dtype=np.int64)
        if old.ndim != 1 or new.ndim != 2 or new.shape[1] != len(old):
            raise ValueError("new_configs must be (B, n_types) with n_types "
                             "matching old_config")
        n_slots = len(self.free)
        if old.sum() > n_slots or (new.sum(axis=1) > n_slots).any():
            raise ValueError("config exceeds the state's slot padding")
        n_b = len(new)
        slots = np.arange(n_slots)
        cum = np.cumsum(new, axis=1)                         # (B, T)
        active = slots[None, :] < cum[:, -1:]                # (B, S)
        # Type of each new slot (clamped for inactive slots), its index
        # within the type, and the matching old slot — all closed-form.
        t_of = np.minimum((slots[None, None, :] >= cum[:, :, None]).sum(
            axis=1), len(old) - 1)                           # (B, S)
        rows = np.arange(n_b)[:, None]
        j = slots[None, :] - (cum - new)[rows, t_of]         # idx within type
        survive = active & (j < np.minimum(old, new)[rows, t_of])
        oc = np.concatenate([[0], np.cumsum(old)])
        src = np.clip(oc[:-1][t_of] + j, 0, n_slots - 1)
        base = np.full((n_b, n_slots), float(now))
        if warmup is not None:
            w = np.asarray(warmup, dtype=np.float64)
            if w.shape != old.shape:
                raise ValueError("warmup must give one per-type cold-start "
                                 "time matching the config length")
            # Same float64 sum as the per-row remap: now + warmup[type] for
            # active (added) slots, plain now for the inactive padding.
            base = np.where(active, float(now) + w[t_of], float(now))
        return np.where(survive, self.free[src], base)


@dataclass
class SegmentResult:
    """One warm-start segment: per-query outputs + the carry at any prefix.

    ``lat``/``waits`` cover the whole bound stream.  ``state_at(k)`` is the
    pool state after serving only the first ``k`` queries; ``state`` (=
    ``state_at(n)``) is the scan's own final carry, bit-exact; interior
    prefixes are rebuilt from the recorded per-query (slot, finish) trace
    with the same float32 arithmetic the scan performed.  ``telemetry`` is
    set by ``segment_from(..., telemetry=True)``; window slices come from
    ``PoolSimulator.segment_telemetry``.
    """

    lat: np.ndarray
    waits: np.ndarray
    _state0: "PoolState"
    _active: np.ndarray | None          # (S,) bool; None for empty segments
    _rel0: np.ndarray | None            # (S,) float64 of the f32 carry in
    _fin: np.ndarray | None             # (nq,) float64-exact f32 finishes
    _slots: np.ndarray | None           # (nq,) int dispatch trace
    _final_rel: np.ndarray | None       # (S,) float64 of the f32 carry out
    _start: np.ndarray | None = None    # (nq,) float32 start times
    telemetry: "Telemetry | None" = None

    @property
    def n_queries(self) -> int:
        return len(self.lat)

    @property
    def state(self) -> "PoolState":
        """Carry after the whole segment."""
        return self.state_at(self.n_queries)

    def state_at(self, upto: int) -> "PoolState":
        """Carry after the first ``upto`` served queries."""
        if not 0 <= upto <= self.n_queries:
            raise ValueError(f"upto={upto} outside [0, {self.n_queries}]")
        if self._active is None:        # empty pool or empty stream
            return self._state0
        if upto == self.n_queries:
            rel = self._final_rel
        else:
            # Per-slot finishes are nondecreasing, so max == the last
            # assignment — exactly the scan's carry at step ``upto``.
            rel = self._rel0.copy()
            np.maximum.at(rel, self._slots[:upto], self._fin[:upto])
        free = np.where(self._active, rel + self._state0.clock,
                        self._state0.free)
        return PoolState(free=free, clock=self._state0.clock)


@dataclass
class SimResult:
    """Per-query outcome of one ``PoolSimulator.simulate`` call: ``lat``
    (n_queries,) single, (B, n_queries) batch, (P, B, n_queries) stacked
    policy × batch, (W, [P,] B, n_queries) grid; ``waits`` (queue time,
    ``start - arrival`` clamped at zero) on the single lane only.
    ``state`` is the final carry of a warm call: a :class:`PoolState`
    (single), a list of them (batch) or a [P][B] nested list (stacked
    policy); None on cold and grid lanes.  ``telemetry`` (``telemetry=True``
    only) is a :class:`Telemetry` whose leading dims mirror the lane."""

    lat: np.ndarray
    waits: np.ndarray | None
    state: object | None
    telemetry: Telemetry | None = None


@dataclass
class QosResult:
    """QoS outcome of one ``PoolSimulator.qos`` call: ``rates``, the
    fraction of queries within the model's QoS latency — a float (single),
    (B,) or (P, B) (batch) or (W, [P,] B) (grid); ``state`` and
    ``telemetry`` mirror :class:`SimResult`'s."""

    rates: float | np.ndarray
    state: object | None
    telemetry: Telemetry | None = None


class PoolSimulator:
    """Simulator bound to (model profile, instance type order, workload).

    The arrivals, the service table and the slot priorities live on
    ``device`` (default ``cuda``); ``n_dispatches`` counts the scans run."""

    def __init__(self, model: ModelProfile, types: list[InstanceType],
                 workload: Workload, max_instances: int = 40, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.types = list(types)
        self.workload = workload
        self.max_instances = max_instances
        if workload.n_queries:
            _check_horizon(float(workload.arrivals[-1]),
                           "PoolSimulator workload")
        # Host float32 copies: the segment lanes rebuild finishes and
        # telemetry from them with the scan's own float32 arithmetic.
        self._service_host = np.asarray(
            service_table_for(model, self.types, workload), dtype=np.float32)
        self._arrivals_host = np.asarray(workload.arrivals, dtype=np.float32)
        self._service = self._to_dev(self._service_host)
        self._arrivals = self._to_dev(self._arrivals_host)
        self._priority = torch.arange(max_instances, dtype=torch.float32,
                                      device=self.device)
        self.n_dispatches = 0

    def _to_dev(self, array, dtype=np.float32) -> torch.Tensor:
        """numpy → ``device``, cast on the host (round to nearest, as
        ``jnp.asarray(..., float32)``)."""
        host = np.ascontiguousarray(np.asarray(array, dtype=dtype))
        return torch.from_numpy(host).to(self.device)

    def _slots_batch(self, configs) -> tuple[np.ndarray, np.ndarray]:
        return _expand_slots(configs, len(self.types), self.max_instances)

    def _slots(self, config) -> tuple[np.ndarray, np.ndarray]:
        type_of_slot, active = self._slots_batch(
            np.asarray(config, dtype=np.int64)[None, :])
        return type_of_slot[0], active[0]

    def _scan(self, arrivals, service, type_of_slot, free0, *, policy=None,
              n_active=None, want_lat=False, want_start=False,
              want_slot=False) -> _fcfs.ScanResult:
        """One dispatch of every lane of ``type_of_slot`` (L, S) from the
        float32 carries ``free0`` ((L, S), or (W, L, S) one per workload
        row) against arrivals (W, nq) and service (W or 1, n_types, nq);
        ``policy`` the folded (pref_slot, affinity, hedge), ``n_active``
        (L,) the active slots of each lane for the telemetry counters."""
        self.n_dispatches += 1
        return ops.fcfs_scan(
            arrivals, service, self._to_dev(type_of_slot, np.int32),
            self._priority, self._to_dev(free0),
            _qos_threshold_f32(self.model.qos_latency),
            policy=None if policy is None else tuple(
                self._to_dev(x) for x in policy),
            n_active=None if n_active is None else self._to_dev(
                n_active, np.int32),
            want_lat=want_lat, want_start=want_start, want_slot=want_slot)

    def _host(self, x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy().astype(np.float64)

    # --------------------------------------------------- unified surface
    def _check_policy(self, policy) -> RoutingPolicy | None:
        if policy is None:
            return None
        if not isinstance(policy, RoutingPolicy):
            raise TypeError("policy must be a RoutingPolicy or None, got "
                            f"{type(policy).__name__}")
        return policy.check_pool(len(self.types))

    @staticmethod
    def _check_warm_kwargs(state, deployed, now, warmup) -> None:
        if state is None and not (deployed is None and now is None
                                  and warmup is None):
            raise ValueError("deployed=/now=/warmup= describe a warm-start "
                             "redeploy and require state=")

    def simulate(self, configs, *, state=None, workloads=None,
                 service_tables=None, policy=None, deployed=None, now=None,
                 warmup=None, telemetry: bool = False) -> SimResult:
        """Serve the bound stream.  The lane is picked by the arguments:
        ``configs`` (n_types,) single, (B, n_types) batch; ``workloads=``
        (W load factors) the grid, optionally with ``service_tables=``
        (W, n_types, n_queries).  ``state=`` starts from a carry (the batch
        and grid lanes remapped per candidate by ``deployed=``/``now=``/
        ``warmup=``), ``policy=`` routes, a stacked policy adds a policy
        axis, ``telemetry=True`` adds a :class:`Telemetry`.  All-zero
        configs get +inf latencies."""
        policy = self._check_policy(policy)
        self._check_warm_kwargs(state, deployed, now, warmup)
        cfg = np.asarray(configs, dtype=np.int64)
        if workloads is not None:
            if cfg.ndim != 2:
                raise ValueError("the workload grid needs a (B, n_types) "
                                 "config batch")
            lat, tel = self._sim_grid(cfg, workloads, service_tables, policy,
                                      state, deployed, now, warmup,
                                      telemetry)
            return SimResult(lat=lat, waits=None, state=None, telemetry=tel)
        if service_tables is not None:
            raise ValueError("service_tables is a workload-grid axis; pass "
                             "workloads= as well")
        if cfg.ndim == 1:
            if policy is not None and policy.stacked:
                raise ValueError(
                    "a stacked policy needs a config batch; pass "
                    "configs=[config] to score one pool under P policies")
            if state is not None:
                seg = self.segment_from(state, cfg, policy=policy,
                                        telemetry=telemetry)
                return SimResult(lat=seg.lat, waits=seg.waits,
                                 state=seg.state, telemetry=seg.telemetry)
            if telemetry:
                # The idle carry at clock 0 is the warm identity element, so
                # the segment lane reproduces the cold bits exactly.
                seg = self.segment_from(self.initial_state(), cfg,
                                        policy=policy, telemetry=True)
                return SimResult(lat=seg.lat, waits=seg.waits, state=None,
                                 telemetry=seg.telemetry)
            lat, waits = self._lat_waits_single(cfg, policy)
            return SimResult(lat=lat, waits=waits, state=None)
        if cfg.ndim != 2:
            raise ValueError("configs must be (n_types,) or (B, n_types), "
                             f"got shape {cfg.shape}")
        if state is not None:
            lat, states, tel = self._sim_batch_from(state, cfg, policy,
                                                    deployed, now, warmup,
                                                    telemetry)
            return SimResult(lat=lat, waits=None, state=states,
                             telemetry=tel)
        lat, tel = self._sim_batch(cfg, policy, telemetry)
        return SimResult(lat=lat, waits=None, state=None, telemetry=tel)

    def qos(self, configs, *, state=None, states=None, workloads=None,
            service_tables=None, policy=None, deployed=None, now=None,
            warmup=None, telemetry: bool = False) -> QosResult:
        """QoS satisfaction rates (paper Eq. 2 R_sat) on ``simulate``'s
        lanes: the single lane and the warm batch lane take the host
        float64 mean of ``lat <= qos_latency``; the cold batch lane and the
        grid lane count on the device against the float32 threshold, and
        only ([W,] [P·]B) counts (and, with ``telemetry``, the counters)
        cross to the host, equal to that mean bit for bit.  ``states=`` is the
        grid's per-workload-row warm start: one entry per row, ``None``
        (cold) or a ``(PoolState, deployed_config)`` pair."""
        policy = self._check_policy(policy)
        if states is not None:
            if workloads is None:
                raise ValueError("states= is a per-workload-row grid axis; "
                                 "pass workloads= as well")
            if state is not None or deployed is not None or now is not None:
                raise ValueError("states= carries its own (state, deployed) "
                                 "pairs; state=/deployed=/now= do not apply")
            if telemetry:
                raise ValueError("telemetry is not supported on the "
                                 "per-row states= grid")
        else:
            self._check_warm_kwargs(state, deployed, now, warmup)
        cfg = np.asarray(configs, dtype=np.int64)
        qos = self.model.qos_latency
        if workloads is not None:
            if cfg.ndim != 2:
                raise ValueError("the workload grid needs a (B, n_types) "
                                 "config batch")
            rates, tel = self._qos_grid(cfg, workloads, service_tables,
                                        policy, state, deployed, now, warmup,
                                        telemetry, states=states)
            return QosResult(rates=rates, state=None, telemetry=tel)
        if service_tables is not None:
            raise ValueError("service_tables is a workload-grid axis; pass "
                             "workloads= as well")
        if cfg.ndim == 1:
            if policy is not None and policy.stacked:
                raise ValueError(
                    "a stacked policy needs a config batch; pass "
                    "configs=[config] to score one pool under P policies")
            if state is not None or telemetry:
                seg = self.segment_from(
                    self.initial_state() if state is None else state, cfg,
                    policy=policy, telemetry=telemetry)
                return QosResult(rates=float(np.mean(seg.lat <= qos)),
                                 state=None if state is None else seg.state,
                                 telemetry=seg.telemetry)
            lat = self._lat_single(cfg, policy)
            return QosResult(rates=float(np.mean(lat <= qos)), state=None)
        if cfg.ndim != 2:
            raise ValueError("configs must be (n_types,) or (B, n_types), "
                             f"got shape {cfg.shape}")
        if state is not None:
            lat, states, tel = self._sim_batch_from(state, cfg, policy,
                                                    deployed, now, warmup,
                                                    telemetry)
            return QosResult(rates=np.mean(lat <= qos, axis=-1),
                             state=states, telemetry=tel)
        rates, tel = self._qos_grid(cfg, [1.0], None, policy, None, None,
                                    None, None, telemetry)
        return QosResult(rates=rates[0], state=None,
                         telemetry=tel[0] if telemetry else None)

    def tail_latency(self, config, pct: float = 99.0, *, state=None,
                     policy=None) -> float:
        """Tail latency of one pool config from the telemetry plane's
        log-bucket histogram (the upper edge of the bucket where the CDF
        crosses the rank: within one bucket of the exact sample
        percentile), cold or warm, routed or not."""
        r = self.qos(config, state=state, policy=policy, telemetry=True)
        return r.telemetry.latency_percentile(pct)

    # -------------------------------------------------------- single lane
    def _single_scan(self, config, free0, policy, **want):
        """One pool's dispatch from the (S,) float32 carry ``free0``."""
        type_of_slot, _ = self._slots(config)
        tos = type_of_slot[None]
        folded = None
        if policy is not None:
            _, _, pref, aff, hed, _ = _fold_policy(policy, tos, free0[None])
            folded = (pref, aff, hed)
        return self._scan(self._arrivals[None], self._service[None], tos,
                          free0[None], policy=folded, **want)

    def _lat_single(self, config, policy) -> np.ndarray:
        """Per-query end-to-end latency (wait + service) for one pool."""
        if sum(int(c) for c in config) == 0:
            return np.full(self.workload.n_queries, np.inf)
        free0 = _cold_free0(self._slots(config)[1])
        r = self._single_scan(config, free0, policy, want_lat=True)
        return self._host(r.lat[0, 0])

    def _lat_waits_single(self, config,
                          policy) -> tuple[np.ndarray, np.ndarray]:
        """Per-query (latency, queue wait ``start - arrival``) for one pool,
        the latencies equal to ``_lat_single``'s."""
        n = self.workload.n_queries
        if sum(int(c) for c in config) == 0:
            return np.full(n, np.inf), np.full(n, np.inf)
        free0 = _cold_free0(self._slots(config)[1])
        r = self._single_scan(config, free0, policy, want_lat=True,
                              want_start=True)
        start = self._host(r.start[0, 0])
        return (self._host(r.lat[0, 0]),
                np.maximum(start - self._arrivals_host.astype(np.float64),
                           0.0))

    # --------------------------------------------------- continuous clock
    def initial_state(self) -> PoolState:
        """Idle pool at episode clock 0 — the warm-start identity element:
        every warm lane started here reproduces its cold counterpart bit
        for bit."""
        return PoolState.idle(self.max_instances)

    def _warm_free0(self, state: PoolState,
                    active: np.ndarray) -> np.ndarray:
        """(S,) float32 initial carry in the bound stream's local frame,
        with the horizon guard applied to arrivals and carried busy time."""
        if len(state.free) != self.max_instances:
            raise ValueError(
                f"state has {len(state.free)} slots, simulator pads to "
                f"{self.max_instances}")
        rel = np.asarray(state.free, dtype=np.float64) - float(state.clock)
        horizon = float(self.workload.arrivals[-1])
        if active.any():
            horizon = max(horizon, float(rel[active].max()))
        _check_horizon(horizon, "warm-start segment")
        return np.where(active, rel.astype(np.float32),
                        np.float32(_INF))

    def segment_from(self, state: PoolState, config, *, policy=None,
                     telemetry: bool = False) -> SegmentResult:
        """Serve the bound stream as one continuous-time segment from
        ``state``: ``lat``/``waits`` equal the cold single lane bit for bit
        from the idle carry at clock 0, and ``state_at(k)`` gives the pool
        state after the first ``k`` queries (``state_at(n_queries)`` is the
        scan's own final carry, so chained segments reproduce the
        whole-stream bits).  One dispatch with the kernel's dispatch trace;
        ``policy=`` routes (one unstacked policy); ``telemetry=True``
        attaches the segment's telemetry, computed on the host from the
        trace."""
        policy = self._check_policy(policy)
        if policy is not None and policy.stacked:
            raise ValueError("segment_from serves one pool; stacked "
                             "policies ride the batch/grid lanes")
        n = self.workload.n_queries
        total = sum(int(c) for c in config)
        if n == 0 or total == 0:
            # An empty pool or an empty stream serves nothing: the carry
            # passes through unchanged.
            return SegmentResult(
                lat=np.full(n, np.inf), waits=np.full(n, np.inf),
                _state0=state, _active=None, _rel0=None, _fin=None,
                _slots=None, _final_rel=None,
                telemetry=(Telemetry.zeros(len(self.types)) if telemetry
                           else None))
        type_of_slot, active = self._slots(config)
        free0 = self._warm_free0(state, active)
        r = self._single_scan(config, free0, policy, want_lat=True,
                              want_start=True, want_slot=True)
        lat64 = self._host(r.lat[0, 0])
        start32 = r.start[0, 0].cpu().numpy()
        slots = r.slot[0, 0].cpu().numpy()
        # Same float32-cast arrival baseline as the single lane's waits.
        waits = np.maximum(start32.astype(np.float64)
                           - self._arrivals_host.astype(np.float64), 0.0)
        # Per-query finishes with the scan's own float32 add, so a prefix
        # carry matches the scan's carry at that step.
        svc32 = self._service_host[type_of_slot[slots], np.arange(n)]
        fin = np.asarray(start32 + svc32, dtype=np.float64)
        seg = SegmentResult(lat=lat64, waits=waits, _state0=state,
                            _active=active, _rel0=free0.astype(np.float64),
                            _fin=fin, _slots=slots,
                            _final_rel=self._host(r.free[0, 0]),
                            _start=start32)
        if telemetry:
            seg.telemetry = self.segment_telemetry(seg, config)
        return seg

    def segment_telemetry(self, seg: SegmentResult, config, lo: int = 0,
                          hi: int | None = None) -> Telemetry:
        """Telemetry over queries ``[lo, hi)`` of a served segment, on the
        host from its dispatch trace with the kernel's float32 arithmetic:
        the whole segment's equals the in-carry counters of the batch and
        grid lanes, and windows merge back to it exactly."""
        n = seg.n_queries
        hi = n if hi is None else int(hi)
        if not 0 <= lo <= hi <= n:
            raise ValueError(f"window [{lo}, {hi}) outside [0, {n}]")
        n_types = len(self.types)
        if seg._active is None or lo == hi:
            return Telemetry.zeros(n_types)
        type_of_slot, active = self._slots(config)
        slots = seg._slots
        tslot = type_of_slot[slots]
        svc32 = self._service_host[tslot, np.arange(n)]
        arr32 = self._arrivals_host
        wait32 = np.maximum(seg._start - arr32, np.float32(0.0))
        depth = queue_depth(slots, seg._fin,
                            np.asarray(seg._rel0, dtype=np.float32),
                            active, arr32)
        qos_t = _qos_threshold_f32(self.model.qos_latency)
        return from_arrays(
            seg.lat[lo:hi], wait32[lo:hi], svc32[lo:hi], tslot[lo:hi],
            n_types, qos_t, depth=depth[lo:hi])

    def carried_wait(self, state: PoolState, config, at: float) -> float:
        """In-flight busy seconds carried into local time ``at``: the sum
        over the config's slots of (next-free − at), clamped at zero."""
        total = int(sum(int(c) for c in config))
        rel = (np.asarray(state.free[:total], dtype=np.float64)
               - float(state.clock))
        return float(np.maximum(rel - float(at), 0.0).sum())

    # ------------------------------------------------ warm batched / grid
    def _warm_free_matrix(self, state: PoolState, configs: np.ndarray,
                          deployed, now, warmup=None) -> np.ndarray:
        """(B, max_instances) float64 episode next-free matrix: candidate
        ``b``'s initial carry, the ``remap_batch`` of switching the live
        pool (``deployed``) to ``configs[b]`` at ``now`` (default
        ``state.clock``), or ``state.free`` itself for every candidate with
        ``deployed=None``."""
        if len(state.free) != self.max_instances:
            raise ValueError(
                f"state has {len(state.free)} slots, simulator pads to "
                f"{self.max_instances}")
        if deployed is None:
            return np.broadcast_to(
                np.asarray(state.free, dtype=np.float64),
                (len(configs), self.max_instances))
        t_now = float(state.clock) if now is None else float(now)
        return state.remap_batch(deployed, configs, t_now, warmup=warmup)

    def _warm_free0_rows(self, state: PoolState, free_matrix: np.ndarray,
                         active: np.ndarray, horizon: float,
                         context: str) -> np.ndarray:
        """(B, S) float32 initial carries in the bound stream's local frame
        — ``_warm_free0`` row by row (same float64 subtraction, float32
        cast and horizon guard)."""
        rel = np.asarray(free_matrix, dtype=np.float64) - float(state.clock)
        if active.any():
            horizon = max(horizon, float(rel[active].max()))
        _check_horizon(horizon, context)
        return np.where(active, rel.astype(np.float32), np.float32(_INF))

    def _states_free0(self, states, configs, active, arrivals,
                      warmup) -> np.ndarray:
        """(W, B, S) float32 per-workload-row initial carries for the
        ``states=`` grid: row ``w`` from that row's ``(PoolState,
        deployed)`` pair, or the idle carry for ``None``."""
        rows = []
        for w, entry in enumerate(states):
            if entry is None:
                rows.append(_cold_free0(active))
                continue
            st, dep = entry
            mat = self._warm_free_matrix(st, configs, dep, None, warmup)
            rows.append(self._warm_free0_rows(
                st, mat, active, float(arrivals[w, -1]),
                "warm-start phase grid"))
        return np.stack(rows)

    def _lanes(self, configs, free0, policy, telemetry: bool):
        """The lane operands of a (B, n_types) batch from its carries
        ``free0`` (B, S): (type_of_slot, free0, folded policy or None,
        n_active or None, zero, n_policies), a stacked policy folded into
        P·B lanes."""
        type_of_slot, active = self._slots_batch(configs)
        zero = configs.sum(axis=1) == 0
        folded, n_p = None, 1
        if policy is not None:
            type_of_slot, free0, pref, aff, hed, n_p = _fold_policy(
                policy, type_of_slot, free0)
            folded = (pref, aff, hed)
            zero = np.tile(zero, n_p)
            active = np.tile(active, (n_p, 1))
        n_active = (active.sum(axis=1).astype(np.int32) if telemetry
                    else None)
        return type_of_slot, free0, folded, n_active, zero, n_p

    def _sim_batch_from(self, state: PoolState, configs, policy, deployed,
                        now, warmup, telemetry: bool = False):
        """Warm batch core: B candidate pools served from the live backlog
        in one dispatch, plus each candidate's final carry.  Row ``i``
        equals ``segment_from(state_i, configs[i], policy=policy)``, where
        ``state_i`` is ``state`` (``deployed=None``) or ``state.remap(
        deployed, configs[i], now, warmup)``.  A stacked policy gives
        ``lat`` (P, B, n_queries) and a [P][B] list of states."""
        n = self.workload.n_queries
        n_b = len(configs)
        stacked = policy is not None and policy.stacked
        n_p = policy.n_policies if stacked else 1
        tel_shape = (n_p, n_b) if stacked else None
        zeros_tel = (Telemetry.zeros(len(self.types),
                                     (n_p, n_b) if stacked else (n_b,))
                     if telemetry else None)
        if configs.size == 0:
            if stacked:
                return (np.zeros((n_p, 0, n), dtype=np.float64),
                        [[] for _ in range(n_p)], zeros_tel)
            return np.zeros((0, n), dtype=np.float64), [], zeros_tel
        free_mat = self._warm_free_matrix(state, configs, deployed, now,
                                          warmup)
        _, active = self._slots_batch(configs)
        if n == 0:
            # Empty stream: every candidate's carry passes through unchanged.
            def carries() -> list[PoolState]:
                return [PoolState(free=free_mat[b].copy(),
                                  clock=state.clock) for b in range(n_b)]

            if stacked:
                return (np.zeros((n_p, n_b, 0), dtype=np.float64),
                        [carries() for _ in range(n_p)], zeros_tel)
            return np.zeros((n_b, 0), dtype=np.float64), carries(), zeros_tel
        free0 = self._warm_free0_rows(
            state, free_mat, active, float(self.workload.arrivals[-1]),
            "warm-start batch")
        tos, fr0, folded, n_active, zero, n_p = self._lanes(
            configs, free0, policy, telemetry)
        r = self._scan(self._arrivals[None], self._service[None], tos, fr0,
                       policy=folded, n_active=n_active, want_lat=True)
        out = self._host(r.lat[0])
        out[zero, :] = np.inf
        tel = (_telemetry(r.tel[0], len(self.types), zero, tel_shape)
               if telemetry else None)
        free_mat = np.tile(free_mat, (n_p, 1))
        active = np.tile(active, (n_p, 1))
        free_out = np.where(active, self._host(r.free[0]) + float(state.clock),
                            free_mat)
        states = [PoolState(free=free_out[b], clock=state.clock)
                  for b in range(len(free_out))]
        if stacked:
            return (out.reshape(n_p, n_b, n),
                    [states[p * n_b:(p + 1) * n_b] for p in range(n_p)], tel)
        return out, states, tel

    # --------------------------------------------------------- batch lane
    def _sim_batch(self, configs, policy, telemetry: bool = False):
        """Cold batch core: (B, n_queries) float64 latencies in one
        dispatch, all-zero rows +inf; row ``i`` equals the single lane on
        ``configs[i]``.  A stacked policy gives (P, B, n_queries)."""
        n = self.workload.n_queries
        n_b = len(configs)
        stacked = policy is not None and policy.stacked
        n_p = policy.n_policies if stacked else 1
        tel_shape = (n_p, n_b) if stacked else None
        if configs.size == 0 or n == 0:
            if configs.size:
                self._slots_batch(configs)  # keep shape/padding validation
            shape = (n_p, n_b, n) if stacked else (n_b, n)
            tel = (Telemetry.zeros(len(self.types), shape[:-1])
                   if telemetry else None)
            return np.zeros(shape, dtype=np.float64), tel
        free0 = _cold_free0(self._slots_batch(configs)[1])
        tos, fr0, folded, n_active, zero, n_p = self._lanes(
            configs, free0, policy, telemetry)
        r = self._scan(self._arrivals[None], self._service[None], tos, fr0,
                       policy=folded, n_active=n_active, want_lat=True)
        out = self._host(r.lat[0])
        out[zero, :] = np.inf
        if stacked:
            out = out.reshape(n_p, n_b, n)
        tel = (_telemetry(r.tel[0], len(self.types), zero, tel_shape)
               if telemetry else None)
        return out, tel

    # ---------------------------------------------------------- grid lane
    def _stacked_arrivals(self, load_factors) -> np.ndarray:
        """(W, n_queries) float64 arrivals of ``workload.scaled`` levels,
        divided in float64 before the float32 cast, as a simulator bound
        to ``workload.scaled(f)`` sees them."""
        factors = np.asarray(load_factors, dtype=np.float64)
        if factors.ndim != 1 or factors.size == 0:
            raise ValueError("load_factors must be a non-empty 1-D sequence")
        if (factors <= 0).any() or not np.isfinite(factors).all():
            raise ValueError("load factors must be finite and > 0")
        base = np.asarray(self.workload.arrivals, dtype=np.float64)
        out = base[None, :] / factors[:, None]
        if out.size:
            _check_horizon(float(out[:, -1].max()), "load-factor grid")
        return out

    def _stacked_service(self, service_tables, n_w: int):
        """Validate and cast an optional (W, n_types, n_queries) stack of
        per-workload service tables; the bound table when None."""
        if service_tables is None:
            return self._service[None]
        tables = np.asarray(service_tables, dtype=np.float64)
        expect = (n_w, len(self.types), self.workload.n_queries)
        if tables.shape != expect:
            raise ValueError(f"service_tables must have shape {expect} "
                             f"(W, n_types, n_queries), got {tables.shape}")
        return self._to_dev(tables)

    def _grid_free0(self, configs, arrivals, state, deployed, now, warmup,
                    states=None) -> np.ndarray:
        """The grid's initial carries: idle, warm from ``state`` (one (B, S)
        carry for every workload row) or per row from ``states``."""
        active = self._slots_batch(configs)[1]
        if states is not None:
            if len(states) != len(arrivals):
                raise ValueError(f"states= needs one entry per workload row "
                                 f"({len(arrivals)}), got {len(states)}")
            return self._states_free0(states, configs, active, arrivals,
                                      warmup)
        if state is None:
            return _cold_free0(active)
        free_mat = self._warm_free_matrix(state, configs, deployed, now,
                                          warmup)
        return self._warm_free0_rows(state, free_mat, active,
                                     float(arrivals[:, -1].max()),
                                     "warm-start grid")

    def _grid_lanes(self, configs, free0, policy, telemetry: bool):
        """``_lanes`` for a grid carry, which may be per row (W, B, S): the
        policy folds over the layout, and every row's carries tile across
        the policy axis (a carry does not depend on the policy)."""
        if free0.ndim == 2:
            return self._lanes(configs, free0, policy, telemetry)
        tos, _, folded, n_active, zero, n_p = self._lanes(
            configs, free0[0], policy, telemetry)
        return tos, np.tile(free0, (1, n_p, 1)), folded, n_active, zero, n_p

    def _sim_grid(self, configs, load_factors, service_tables, policy,
                  state, deployed, now, warmup, telemetry: bool = False):
        """(W, B, n_queries) float64 latencies, cell ``[w, b]`` equal to a
        simulator bound to ``workload.scaled(load_factors[w])`` on
        ``configs[b]`` (all-zero rows +inf), cold or warm, in one dispatch;
        (W, P, B, n_queries) under a stacked policy."""
        arrivals = self._stacked_arrivals(load_factors)
        service = self._stacked_service(service_tables, len(arrivals))
        n_w, n, n_b = len(arrivals), self.workload.n_queries, len(configs)
        stacked = policy is not None and policy.stacked
        n_p = policy.n_policies if stacked else 1
        if configs.size == 0 or n == 0:
            if configs.size:
                self._slots_batch(configs)
            shape = (n_w, n_p, n_b, n) if stacked else (n_w, n_b, n)
            tel = (Telemetry.zeros(len(self.types), shape[:-1])
                   if telemetry else None)
            return np.zeros(shape, np.float64), tel
        free0 = self._grid_free0(configs, arrivals, state, deployed, now,
                                 warmup)
        tos, fr0, folded, n_active, zero, n_p = self._grid_lanes(
            configs, free0, policy, telemetry)
        r = self._scan(self._to_dev(arrivals), service, tos, fr0,
                       policy=folded, n_active=n_active, want_lat=True)
        out = self._host(r.lat)
        out[:, zero, :] = np.inf
        tel = (_telemetry(r.tel, len(self.types), zero,
                          (n_w, n_p, n_b) if stacked else None)
               if telemetry else None)
        if stacked:
            out = out.reshape(n_w, n_p, n_b, n)
        return out, tel

    def _qos_grid(self, configs, load_factors, service_tables, policy,
                  state, deployed, now, warmup, telemetry: bool = False,
                  states=None):
        """(W, B) float64 rates from the device's QoS counts ((W, P, B)
        under a stacked policy), cell ``[w, b]`` equal to the single lane's
        rate on ``workload.scaled(f_w)``, cold, warm or warm per row."""
        arrivals = self._stacked_arrivals(load_factors)
        service = self._stacked_service(service_tables, len(arrivals))
        n_w, n, n_b = len(arrivals), self.workload.n_queries, len(configs)
        stacked = policy is not None and policy.stacked
        n_p = policy.n_policies if stacked else 1
        if configs.size == 0 or n == 0:
            shape = (n_w, n_p, n_b) if stacked else (n_w, n_b)
            tel = (Telemetry.zeros(len(self.types), shape)
                   if telemetry else None)
            if configs.size:
                self._slots_batch(configs)
                if n == 0:   # 0/0: an empty stream has no violations
                    return np.full(shape, np.nan, dtype=np.float64), tel
            return np.zeros(shape, dtype=np.float64), tel
        free0 = self._grid_free0(configs, arrivals, state, deployed, now,
                                 warmup, states)
        tos, fr0, folded, n_active, zero, n_p = self._grid_lanes(
            configs, free0, policy, telemetry)
        r = self._scan(self._to_dev(arrivals), service, tos, fr0,
                       policy=folded, n_active=n_active)
        rates = r.counts.cpu().numpy().astype(np.float64) / n
        tel = (_telemetry(r.tel, len(self.types), zero,
                          (n_w, n_p, n_b) if stacked else None)
               if telemetry else None)
        if stacked:
            rates = rates.reshape(n_w, n_p, n_b)
        return rates, tel


class StreamingSimulator:
    """The reference's chunked streaming simulator (ROADMAP A-10)."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("StreamingSimulator", "A-10")
