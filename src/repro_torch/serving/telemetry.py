"""Telemetry plane of the pool simulator: per-type counters + log-bucket
histograms.

Counterpart of ``repro/serving/telemetry.py``, copied: plain numpy, so the
port keeps its own copy rather than importing the reference.  The
:class:`Telemetry` container is what ``simulate(..., telemetry=True)`` /
``qos(..., telemetry=True)`` return; on the batch and grid lanes its fields
come from the in-carry counters of the ``fcfs_scan`` kernel, on the single
and segment lanes from :func:`from_arrays` and :func:`queue_depth` over the
recorded dispatch trace.  The two agree bit for bit.

Fields and units (all integer accumulators, so merging two telemetries of
adjacent segments is exact — integer addition is associative, which is what
makes chunked-segment accumulation bit-identical to one-shot):

* ``served``  (..., n_types) int64 — queries dispatched to each instance
  type.  Sums to ``n_queries`` over the type axis on every lane.
* ``miss``    (..., n_types) int64 — served queries whose end-to-end latency
  exceeded the QoS target (the rounded-down float32 threshold the device
  compares against, see ``simulator._qos_threshold_f32``), attributed to
  the serving type: ``served.sum() - miss.sum()`` is exactly the device's
  QoS-pass count.
* ``busy_ms`` (..., n_types) int64 — integrated busy time per type in
  integer milliseconds (``round(service_seconds * 1000)`` per query,
  float32 round-half-even — identical on host and device).
* ``lat_hist`` / ``wait_hist`` (..., N_BUCKETS) int64 — fixed log-bucket
  histograms of end-to-end latency and queue wait (both float32 seconds,
  the device's own arithmetic).
* ``depth_sum`` / ``depth_peak`` (...,) int64 — integrated and peak queue
  depth, where depth at an arrival instant is the number of *busy active
  slots* just before the query dispatches (``n_active - idle_count`` in the
  scan carry).  ``depth_sum / served.sum()`` is the mean depth seen by an
  arriving query.

Histogram bucketing: 32 buckets over power-of-two edges
``BUCKET_EDGES = 1e-4 * 2**k`` seconds (k = 0..30, float32-exact).  Bucket 0
is [0, 0.1ms), bucket k is [edge[k-1], edge[k]), bucket 31 is the overflow
[~107421s, inf) — beyond the simulator's safe horizon, so only +inf
sentinels land there.  Binning is comparison-based (no device log), and
percentiles are nearest-rank estimates returned as the upper edge of the
bucket where the CDF crosses the rank — within one bucket (a factor of two)
of the exact sample percentile by construction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_BUCKETS = 32
# 31 float32-exact power-of-two edges; the 32nd bucket is the overflow.
BUCKET_EDGES = (np.float32(1e-4)
                * np.exp2(np.arange(N_BUCKETS - 1, dtype=np.float32)))
# Upper edge reported for each bucket by the percentile estimators; the
# overflow bucket clamps to twice the last edge so every estimate is finite
# (the bench schema sweep rejects non-finite numbers).
_UPPER_EDGES = np.concatenate(
    [BUCKET_EDGES, [BUCKET_EDGES[-1] * np.float32(2.0)]]).astype(np.float64)


def bucket_index(x) -> np.ndarray:
    """Bucket of each float32 value: the count of edges <= x (int array).

    Identical comparison arithmetic to the device kernels, so host and
    device histograms agree bit for bit.  Non-finite values (+inf latencies
    of an empty pool) land in the overflow bucket.
    """
    x32 = np.asarray(x, dtype=np.float32)
    return (x32[..., None] >= BUCKET_EDGES).sum(axis=-1).astype(np.int64)


def _percentile_from_hist(hist: np.ndarray, pct: float) -> float:
    """Nearest-rank percentile estimate: upper edge of the bucket where the
    cumulative count first reaches ``ceil(pct/100 * n)``.  0.0 on an empty
    histogram."""
    hist = np.asarray(hist, dtype=np.int64)
    if hist.ndim != 1:
        raise ValueError("percentiles need an unbatched telemetry; index "
                         "the lane first (tel[b])")
    n = int(hist.sum())
    if n == 0:
        return 0.0
    rank = min(max(int(np.ceil(pct / 100.0 * n)), 1), n)
    k = int(np.searchsorted(np.cumsum(hist), rank))
    return float(_UPPER_EDGES[k])


@dataclass
class Telemetry:
    """Per-type serving counters + histograms of one simulation lane.

    Leading dimensions mirror the lane that produced it: () single,
    (B,) batch, (P, B) stacked policy, (W, [P,] B) grid.  ``tel[i]``
    indexes a leading dimension; ``a.merge(b)`` (or ``a + b``) accumulates
    two telemetries of consecutive segments exactly.
    """

    served: np.ndarray          # (..., n_types) int64
    miss: np.ndarray            # (..., n_types) int64
    busy_ms: np.ndarray         # (..., n_types) int64
    lat_hist: np.ndarray        # (..., N_BUCKETS) int64
    wait_hist: np.ndarray       # (..., N_BUCKETS) int64
    depth_sum: np.ndarray       # (...,) int64
    depth_peak: np.ndarray      # (...,) int64

    @classmethod
    def zeros(cls, n_types: int, shape: tuple = ()) -> "Telemetry":
        z = dict(
            served=np.zeros(shape + (n_types,), dtype=np.int64),
            miss=np.zeros(shape + (n_types,), dtype=np.int64),
            busy_ms=np.zeros(shape + (n_types,), dtype=np.int64),
            lat_hist=np.zeros(shape + (N_BUCKETS,), dtype=np.int64),
            wait_hist=np.zeros(shape + (N_BUCKETS,), dtype=np.int64),
            depth_sum=np.zeros(shape, dtype=np.int64),
            depth_peak=np.zeros(shape, dtype=np.int64),
        )
        return cls(**z)

    # ------------------------------------------------------------ structure
    @property
    def n_types(self) -> int:
        return self.served.shape[-1]

    @property
    def n(self) -> int | np.ndarray:
        """Total served queries (scalar when unbatched)."""
        total = self.served.sum(axis=-1)
        return int(total) if total.ndim == 0 else total

    def __getitem__(self, idx) -> "Telemetry":
        return Telemetry(
            served=self.served[idx], miss=self.miss[idx],
            busy_ms=self.busy_ms[idx], lat_hist=self.lat_hist[idx],
            wait_hist=self.wait_hist[idx], depth_sum=self.depth_sum[idx],
            depth_peak=self.depth_peak[idx])

    def merge(self, other: "Telemetry") -> "Telemetry":
        """Exact accumulation of two telemetries (consecutive segments of
        one stream, or any two disjoint query sets): integer adds, max for
        the peak.  Associative and bit-exact, so chunked segments merge to
        the one-shot telemetry identically."""
        if self.served.shape != other.served.shape:
            raise ValueError("cannot merge telemetries of different shapes "
                             f"{self.served.shape} vs {other.served.shape}")
        return Telemetry(
            served=self.served + other.served,
            miss=self.miss + other.miss,
            busy_ms=self.busy_ms + other.busy_ms,
            lat_hist=self.lat_hist + other.lat_hist,
            wait_hist=self.wait_hist + other.wait_hist,
            depth_sum=self.depth_sum + other.depth_sum,
            depth_peak=np.maximum(self.depth_peak, other.depth_peak))

    __add__ = merge

    # ------------------------------------------------------------- derived
    def busy_seconds(self) -> np.ndarray:
        """(..., n_types) float64 integrated busy time per type."""
        return self.busy_ms.astype(np.float64) / 1000.0

    def utilization(self, config, span: float) -> np.ndarray:
        """Mean per-type utilization over a window of ``span`` seconds:
        busy-seconds divided by instance-seconds of capacity.  Types with
        zero instances (or a degenerate span) report 0.0."""
        counts = np.asarray(config, dtype=np.float64)
        if counts.shape[-1] != self.n_types:
            raise ValueError(f"config has {counts.shape[-1]} types, "
                             f"telemetry has {self.n_types}")
        cap = counts * float(span)
        with np.errstate(divide="ignore", invalid="ignore"):
            util = np.where(cap > 0.0, self.busy_seconds() / cap, 0.0)
        return util

    def miss_rate_by_type(self) -> np.ndarray:
        """(..., n_types) float64 fraction of each type's served queries
        that violated QoS (0.0 for types that served nothing)."""
        served = self.served.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(served > 0, self.miss / served, 0.0)

    def latency_percentile(self, pct: float) -> float:
        """Histogram estimate of the ``pct``-th end-to-end latency
        percentile (seconds); within one log bucket of the exact sample
        percentile."""
        return _percentile_from_hist(self.lat_hist, pct)

    def wait_percentile(self, pct: float) -> float:
        """Histogram estimate of the ``pct``-th queue-wait percentile."""
        return _percentile_from_hist(self.wait_hist, pct)

    def mean_depth(self) -> float | np.ndarray:
        """Mean queue depth seen by an arriving query."""
        n = self.served.sum(axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(n > 0, self.depth_sum / np.maximum(n, 1), 0.0)
        return float(out) if out.ndim == 0 else out

    def to_dict(self) -> dict:
        """JSON-safe dump (finite numbers only) of an unbatched telemetry."""
        if self.served.ndim != 1:
            raise ValueError("to_dict needs an unbatched telemetry; index "
                             "the lane first (tel[b])")
        return {
            "served": [int(c) for c in self.served],
            "miss": [int(c) for c in self.miss],
            "busy_ms": [int(c) for c in self.busy_ms],
            "lat_hist": [int(c) for c in self.lat_hist],
            "wait_hist": [int(c) for c in self.wait_hist],
            "depth_sum": int(self.depth_sum),
            "depth_peak": int(self.depth_peak),
            "p50": self.latency_percentile(50.0),
            "p95": self.latency_percentile(95.0),
            "p99": self.latency_percentile(99.0),
        }


def queue_depth(slots, fin, free0, active, arrivals) -> np.ndarray:
    """(nq,) int64 queue depth at each arrival: busy active slots just
    before the query dispatches.

    Host mirror of the device computation.  A slot's next-free time before
    step ``j`` is the running maximum of its assigned finishes (per-slot
    finishes are nondecreasing, so the running max *is* the last value) —
    exactly the scan's carry — and a slot is busy iff that time exceeds the
    arrival, compared in float32 like the kernel's idle test.
    """
    slots = np.asarray(slots)
    fin32 = np.asarray(fin, dtype=np.float32)
    free0 = np.asarray(free0, dtype=np.float32)
    arr32 = np.asarray(arrivals, dtype=np.float32)
    nq, n_s = len(slots), len(free0)
    if nq == 0:
        return np.zeros(0, dtype=np.int64)
    onehot = slots[:, None] == np.arange(n_s)[None, :]       # (nq, S)
    m = np.where(onehot, fin32[:, None], np.float32(-np.inf))
    prev = np.maximum.accumulate(
        np.concatenate([free0[None, :], m], axis=0), axis=0)[:-1]
    busy = active[None, :] & (prev > arr32[:, None])
    return busy.sum(axis=1).astype(np.int64)


def from_arrays(lat, wait, svc, tslot, n_types, qos_threshold,
                depth=None) -> Telemetry:
    """Build a single-lane telemetry from per-query host arrays.

    ``lat``/``wait``/``svc`` are per-query seconds (cast to float32 here —
    the device's own precision, so counters agree with the kernels bit for
    bit), ``tslot`` the serving type index per query, ``qos_threshold`` the
    rounded-down float32 QoS target (``simulator._qos_threshold_f32``).
    ``depth`` (optional, from :func:`queue_depth`) fills the depth stats;
    omitted, they stay zero.
    """
    lat32 = np.asarray(lat, dtype=np.float32)
    wait32 = np.asarray(wait, dtype=np.float32)
    svc32 = np.asarray(svc, dtype=np.float32)
    tslot = np.asarray(tslot, dtype=np.int64)
    tel = Telemetry.zeros(n_types)
    np.add.at(tel.served, tslot, 1)
    np.add.at(tel.miss, tslot,
              (lat32 > np.float32(qos_threshold)).astype(np.int64))
    np.add.at(tel.busy_ms, tslot,
              np.round(svc32 * np.float32(1000.0)).astype(np.int64))
    np.add.at(tel.lat_hist, bucket_index(lat32), 1)
    np.add.at(tel.wait_hist, bucket_index(wait32), 1)
    if depth is not None:
        depth = np.asarray(depth, dtype=np.int64)
        tel.depth_sum += depth.sum()
        if len(depth):
            tel.depth_peak[...] = depth.max()
    return tel
