"""Batched FCFS queueing simulator over heterogeneous pools: the cold lanes.

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

Latencies, rates and counts are the reference's bit for bit on the same
arrays: the scan's float32 arithmetic is the same, the slot layout is the
same numpy code, and the batch lane's rates are the same host float64
mean, the grid lane's the same device counts against the float32 threshold
(``_qos_threshold_f32``).  All-zero configs serve nothing: +inf latencies,
rate 0.

Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP item: warm starts (``state=``, ``states=``, ``segment_from``;
A-7), routing policies (``policy=``; A-8), telemetry (``telemetry=True``,
``tail_latency``; A-9) and the streaming simulator (A-10).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import fcfs_scan as _fcfs
from ..kernels import ops
from .instance import InstanceType, ModelProfile, service_table_for
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
# Rank-band separator of the routing policies' dispatch key (ROADMAP A-8),
# kept with the other dispatch constants.
_TIE = 65536.0


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def _check_horizon(t_max: float, context: str) -> None:
    if t_max > _MAX_HORIZON:
        raise ValueError(
            f"{context}: simulation horizon {t_max:.4g}s exceeds the safe "
            f"dispatch-priority envelope ({_MAX_HORIZON:.4g}s = _BIG/8); "
            "float32 timestamps this large corrupt the fused idle-vs-busy "
            "dispatch key.  Split the stream.")


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


@dataclass
class SimResult:
    """Per-query outcome of one ``PoolSimulator.simulate`` call: ``lat``
    (n_queries,) single, (B, n_queries) batch, (W, B, n_queries) grid;
    ``waits`` (queue time, ``start - arrival`` clamped at zero) on the
    single lane only.  ``state`` and ``telemetry`` are the warm-start and
    telemetry lanes' outputs (ROADMAP A-7, A-9): None here."""

    lat: np.ndarray
    waits: np.ndarray | None
    state: object | None
    telemetry: object | None = None


@dataclass
class QosResult:
    """QoS outcome of one ``PoolSimulator.qos`` call: ``rates``, the
    fraction of queries within the model's QoS latency — a float (single),
    (B,) (batch) or (W, B) (grid)."""

    rates: float | np.ndarray
    state: object | None
    telemetry: object | None = None


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
        self._service = self._to_dev(
            service_table_for(model, self.types, workload))
        self._arrivals = self._to_dev(workload.arrivals)
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

    def _scan(self, arrivals, service, configs, *, want_lat=False,
              want_start=False) -> _fcfs.ScanResult:
        """One cold dispatch of every config in ``configs`` (B, n_types)
        against arrivals (W, nq) and service (W or 1, n_types, nq)."""
        type_of_slot, active = self._slots_batch(configs)
        self.n_dispatches += 1
        return ops.fcfs_scan(
            arrivals, service, self._to_dev(type_of_slot, np.int32),
            self._priority, self._to_dev(_cold_free0(active)),
            _qos_threshold_f32(self.model.qos_latency), want_lat=want_lat,
            want_start=want_start)

    def _host(self, x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy().astype(np.float64)

    @staticmethod
    def _refuse(state=None, states=None, policy=None, telemetry=False,
                **warm) -> None:
        if state is not None or states is not None or any(
                v is not None for v in warm.values()):
            raise _not_ported("warm starts (state=, states=, deployed=, "
                              "now=, warmup=)", "A-7")
        if policy is not None:
            raise _not_ported("routing policies (policy=)", "A-8")
        if telemetry:
            raise _not_ported("telemetry (telemetry=True)", "A-9")

    def simulate(self, configs, *, state=None, workloads=None,
                 service_tables=None, policy=None, deployed=None, now=None,
                 warmup=None, telemetry: bool = False) -> SimResult:
        """Serve the bound stream.  The lane is picked by the arguments:
        ``configs`` (n_types,) single, (B, n_types) batch; ``workloads=``
        (W load factors) the grid, optionally with ``service_tables=``
        (W, n_types, n_queries).  All-zero configs get +inf latencies."""
        self._refuse(state=state, policy=policy, telemetry=telemetry,
                     deployed=deployed, now=now, warmup=warmup)
        cfg = np.asarray(configs, dtype=np.int64)
        if workloads is not None:
            if cfg.ndim != 2:
                raise ValueError("the workload grid needs a (B, n_types) "
                                 "config batch")
            return SimResult(lat=self._sim_grid(cfg, workloads,
                                                service_tables),
                             waits=None, state=None)
        if service_tables is not None:
            raise ValueError("service_tables is a workload-grid axis; pass "
                             "workloads= as well")
        if cfg.ndim == 1:
            lat, waits = self._lat_waits_single(cfg)
            return SimResult(lat=lat, waits=waits, state=None)
        if cfg.ndim != 2:
            raise ValueError("configs must be (n_types,) or (B, n_types), "
                             f"got shape {cfg.shape}")
        return SimResult(lat=self._sim_batch(cfg), waits=None, state=None)

    def qos(self, configs, *, state=None, states=None, workloads=None,
            service_tables=None, policy=None, deployed=None, now=None,
            warmup=None, telemetry: bool = False) -> QosResult:
        """QoS satisfaction rates (paper Eq. 2 R_sat) on ``simulate``'s
        lanes: the single and batch lanes take the host float64 mean of
        ``lat <= qos_latency``; the grid lane counts on the device against
        the float32 threshold, and only (W, B) counts cross to the host."""
        self._refuse(state=state, states=states, policy=policy,
                     telemetry=telemetry, deployed=deployed, now=now,
                     warmup=warmup)
        cfg = np.asarray(configs, dtype=np.int64)
        qos = self.model.qos_latency
        if workloads is not None:
            if cfg.ndim != 2:
                raise ValueError("the workload grid needs a (B, n_types) "
                                 "config batch")
            return QosResult(rates=self._qos_grid(cfg, workloads,
                                                  service_tables),
                             state=None)
        if service_tables is not None:
            raise ValueError("service_tables is a workload-grid axis; pass "
                             "workloads= as well")
        if cfg.ndim == 1:
            lat = self._lat_single(cfg)
            return QosResult(rates=float(np.mean(lat <= qos)), state=None)
        if cfg.ndim != 2:
            raise ValueError("configs must be (n_types,) or (B, n_types), "
                             f"got shape {cfg.shape}")
        return QosResult(rates=np.mean(self._sim_batch(cfg) <= qos, axis=-1),
                         state=None)

    def segment_from(self, *args, **kwargs):
        raise _not_ported("PoolSimulator.segment_from", "A-7")

    def tail_latency(self, *args, **kwargs):
        raise _not_ported("PoolSimulator.tail_latency", "A-9")

    # -------------------------------------------------------- single lane
    def _lat_single(self, config) -> np.ndarray:
        """Per-query end-to-end latency (wait + service) for one pool."""
        if sum(int(c) for c in config) == 0:
            return np.full(self.workload.n_queries, np.inf)
        r = self._scan(self._arrivals[None], self._service[None],
                       config[None], want_lat=True)
        return self._host(r.lat[0, 0])

    def _lat_waits_single(self, config) -> tuple[np.ndarray, np.ndarray]:
        """Per-query (latency, queue wait ``start - arrival``) for one pool,
        the latencies equal to ``_lat_single``'s."""
        n = self.workload.n_queries
        if sum(int(c) for c in config) == 0:
            return np.full(n, np.inf), np.full(n, np.inf)
        r = self._scan(self._arrivals[None], self._service[None],
                       config[None], want_lat=True, want_start=True)
        start = self._host(r.start[0, 0])
        return (self._host(r.lat[0, 0]),
                np.maximum(start - self._host(self._arrivals), 0.0))

    # --------------------------------------------------------- batch lane
    def _sim_batch(self, configs) -> np.ndarray:
        """(B, n_queries) float64 latencies in one dispatch, all-zero rows
        +inf.  Row ``i`` equals the single lane on ``configs[i]``."""
        n = self.workload.n_queries
        if configs.size == 0 or n == 0:
            if configs.size:
                self._slots_batch(configs)  # keep shape/padding validation
            return np.zeros((len(configs), n), dtype=np.float64)
        r = self._scan(self._arrivals[None], self._service[None], configs,
                       want_lat=True)
        out = self._host(r.lat[0])
        out[configs.sum(axis=1) == 0, :] = np.inf
        return out

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

    def _grid_operands(self, load_factors, service_tables):
        arrivals = self._stacked_arrivals(load_factors)
        return arrivals, self._stacked_service(service_tables, len(arrivals))

    def _sim_grid(self, configs, load_factors, service_tables) -> np.ndarray:
        """(W, B, n_queries) float64 latencies, cell ``[w, b]`` equal to a
        simulator bound to ``workload.scaled(load_factors[w])`` on
        ``configs[b]`` (all-zero rows +inf), in one dispatch."""
        arrivals, service = self._grid_operands(load_factors, service_tables)
        n = self.workload.n_queries
        if configs.size == 0 or n == 0:
            if configs.size:
                self._slots_batch(configs)
            return np.zeros((len(arrivals), len(configs), n), np.float64)
        r = self._scan(self._to_dev(arrivals), service, configs,
                       want_lat=True)
        out = self._host(r.lat)
        out[:, configs.sum(axis=1) == 0, :] = np.inf
        return out

    def _qos_grid(self, configs, load_factors, service_tables) -> np.ndarray:
        """(W, B) float64 rates from the device's QoS counts, cell ``[w, b]``
        equal to the single lane's rate on ``workload.scaled(f_w)``."""
        arrivals, service = self._grid_operands(load_factors, service_tables)
        n = self.workload.n_queries
        shape = (len(arrivals), len(configs))
        if configs.size == 0 or n == 0:
            if configs.size:
                self._slots_batch(configs)
                if n == 0:   # 0/0: an empty stream has no violations
                    return np.full(shape, np.nan, dtype=np.float64)
            return np.zeros(shape, dtype=np.float64)
        counts = self._scan(self._to_dev(arrivals), service, configs).counts
        return counts.cpu().numpy().astype(np.float64) / n


class StreamingSimulator:
    """The reference's chunked streaming simulator (ROADMAP A-10)."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("StreamingSimulator", "A-10")
