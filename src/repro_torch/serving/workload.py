"""Query-stream workload generation (paper §5.1).

* Query inter-arrival times follow a **Poisson process** (exponential
  inter-arrival gaps).
* Batch sizes follow a **heavy-tail log-normal** distribution (the paper's
  default), with a **Gaussian** alternative (paper Fig. 11).

Counterpart of ``repro/serving/workload.py``, drawn from the same threefry
stream (``repro_torch.prng``), so one seed gives the reference's queries.
The stream is defined chunk by chunk: chunk ``c`` draws from
``fold_in(key, c)``, and its gaps accumulate in float32 onto the previous
chunk's last unscaled arrival, so a shorter realisation is a prefix of a
longer one.  Keys, uniform draws and bucket indices are the reference's bit
for bit; the exponential and normal transforms are rounded once from
float64 (``prng``), and the gaps are summed in sequence, where XLA
associates its cumulative sum differently.  So arrivals match the
reference to a float32 rounding per gap, and a batch size can differ where
its log-normal draw lies within that rounding of a half-integer
(``tests/test_torch_prng.py`` states both).

The stream is input data: it is drawn on the host, on every machine, and
``realize`` returns host numpy arrays as the reference's does.  The
simulator that consumes it runs on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import prng


@dataclass(frozen=True)
class RequestBucket:
    """One cell of a request-size distribution (Mélange's 2D histogram).

    ``flops_scale`` multiplies the model's ``flops_per_sample`` (output-size
    axis) and ``bytes_scale`` its ``act_bytes_per_sample`` (input-size
    axis); ``rate`` is the bucket's share of the arrival rate in queries/s.
    The unit bucket ``(1.0, 1.0)`` reproduces the un-bucketed model bit for
    bit.
    """

    name: str
    rate: float
    flops_scale: float = 1.0
    bytes_scale: float = 1.0


@dataclass(frozen=True)
class Workload:
    """A concrete query stream."""

    arrivals: np.ndarray      # (n,) absolute arrival times, seconds, sorted
    batches: np.ndarray       # (n,) int batch size per query
    rate_qps: float           # nominal arrival rate
    # Request-size bucket annotation (None = scalar stream): the bucket
    # index of each query plus the bucket descriptors.
    bucket_of: np.ndarray | None = None    # (n,) int bucket index per query
    buckets: tuple[RequestBucket, ...] | None = None

    @property
    def n_queries(self) -> int:
        return len(self.arrivals)

    def scaled(self, load_factor: float) -> "Workload":
        """Same query sequence under a different load level (paper §5.5:
        'the load becomes 1.5 times heavier' compresses inter-arrivals)."""
        return Workload(arrivals=self.arrivals / load_factor,
                        batches=self.batches,
                        rate_qps=self.rate_qps * load_factor,
                        bucket_of=self.bucket_of, buckets=self.buckets)


def _to_batches(raw: torch.Tensor, max_batch) -> torch.Tensor:
    """Round half to even and clip to [1, max_batch], as int32."""
    top = torch.tensor(float(max_batch), dtype=torch.float32)
    return torch.clamp(torch.round(raw), torch.tensor(1.0), top).to(torch.int32)


def lognormal_batches(key, n: int, median: float = 24.0, sigma: float = 0.8,
                      max_batch: int = 256) -> torch.Tensor:
    """Heavy-tail log-normal batch sizes, clipped to [1, max_batch]."""
    z = prng.normal(key, (n,))
    mu = torch.tensor(math.log(median), dtype=torch.float32)
    return _to_batches(torch.exp(mu + torch.tensor(sigma, dtype=torch.float32)
                                 * z), max_batch)


def gaussian_batches(key, n: int, mean: float = 48.0, std: float = 24.0,
                     max_batch: int = 256) -> torch.Tensor:
    """Gaussian batch sizes (paper Fig. 11 robustness study)."""
    raw = (torch.tensor(mean, dtype=torch.float32)
           + torch.tensor(std, dtype=torch.float32) * prng.normal(key, (n,)))
    return _to_batches(raw, max_batch)


def _spec_chunk(k_arr, k_batch, c: int, base, rate, scale, p_a, p_b,
                max_batch, *, chunk: int, dist: str):
    """One query chunk: (scaled arrivals f32, unscaled local arrivals f32,
    batches i32), the reference's ``_spec_chunk``.  ``base`` .. ``max_batch``
    are float32 scalars; the gaps are divided by ``rate`` in float32 and
    summed in sequence in float32 onto ``base``; the load scale divides in
    float64 before the float32 cast."""
    gaps = prng.exponential(prng.fold_in(k_arr, c), (chunk,)) / rate
    local = base + torch.from_numpy(np.cumsum(gaps.numpy(), dtype=np.float32))
    arr = (local.double() / scale.double()).float()
    z = prng.normal(prng.fold_in(k_batch, c), (chunk,))
    raw = torch.exp(p_a + p_b * z) if dist == "lognormal" else p_a + p_b * z
    return arr, local, _to_batches(raw, float(max_batch))


@dataclass(frozen=True)
class WorkloadSpec:
    """Generative description of a query stream.

    Chunk ``c`` (``chunk`` queries) draws from ``fold_in``-derived keys of
    ``split(PRNGKey(seed))``, gaps accumulating onto the previous chunk's
    last unscaled arrival.  ``scale`` compresses arrivals as
    ``Workload.scaled`` does, dividing in float64; ``scaled`` composes
    multiplicatively.
    """

    seed: int
    rate_qps: float
    batch_dist: str = "lognormal"
    chunk: int = 4096
    scale: float = 1.0
    median_batch: float = 24.0
    sigma: float = 0.8
    mean_batch: float = 48.0
    std_batch: float = 24.0
    max_batch: int = 256

    def __post_init__(self):
        if self.chunk < 1:
            raise ValueError("chunk must be >= 1")
        if not self.rate_qps > 0 or not self.scale > 0:
            raise ValueError("rate_qps and scale must be > 0")
        if self.batch_dist not in ("lognormal", "gaussian"):
            raise ValueError(f"unknown batch_dist {self.batch_dist!r}")

    @property
    def effective_rate(self) -> float:
        """Nominal arrival rate after load scaling."""
        return self.rate_qps * self.scale

    def scaled(self, load_factor: float) -> "WorkloadSpec":
        """Same stream under ``load_factor``-times heavier traffic."""
        if not load_factor > 0:
            raise ValueError("load_factor must be > 0")
        return replace(self, scale=self.scale * float(load_factor))

    def _keys(self):
        return prng.split(prng.PRNGKey(self.seed))

    def generate_chunk(self, c: int, base: float):
        """Host tensors of chunk ``c``: (scaled arrivals f32, unscaled local
        arrivals f32, batches i32).  ``base`` is the previous chunk's last
        *unscaled* arrival (0.0 for chunk 0)."""
        k_arr, k_batch = self._keys()
        if self.batch_dist == "lognormal":
            p_a, p_b = float(np.log(self.median_batch)), self.sigma
        else:
            p_a, p_b = self.mean_batch, self.std_batch
        f32 = [torch.tensor(v, dtype=torch.float32)
               for v in (base, self.rate_qps, self.scale, p_a, p_b,
                         self.max_batch)]
        return _spec_chunk(k_arr, k_batch, c, *f32, chunk=self.chunk,
                           dist=self.batch_dist)

    def _chunks(self, n_queries: int, extra=None):
        """The first ``ceil(n / chunk)`` chunks' unscaled arrivals, batches
        and (with ``extra(c)``) one more array per chunk."""
        if n_queries < 0:
            raise ValueError("n_queries must be >= 0")
        arrs, bats, more = [], [], []
        base = 0.0
        for c in range(math.ceil(n_queries / self.chunk)):
            _, local, batches = self.generate_chunk(c, base)
            arrs.append(local.numpy())
            bats.append(batches.numpy())
            if extra is not None:
                more.append(extra(c).numpy())
            base = float(local[-1])
        return arrs, bats, more

    def realize(self, n_queries: int) -> Workload:
        """Host :class:`Workload` of the stream's first ``n_queries``:
        unscaled float32 arrivals upcast to float64, then divided by the
        load scale in float64."""
        arrs, bats, _ = self._chunks(n_queries)
        return Workload(arrivals=_concat(arrs, n_queries, np.float64,
                                         self.scale),
                        batches=_concat(bats, n_queries, np.int64),
                        rate_qps=float(self.effective_rate))


def _concat(parts, n: int, dtype, scale: float = 1.0) -> np.ndarray:
    out = (np.concatenate(parts)[:n].astype(dtype) if parts
           else np.zeros(0, dtype=dtype))
    return out / np.float64(scale) if scale != 1.0 else out


# fold_in tag deriving the bucket stream from the seed key: the arrival and
# batch keys come from split(PRNGKey(seed)), so the bucket draws never
# perturb them.
_BUCKET_STREAM_TAG = 0x42C0DE


def _bucket_chunk(k_bucket, c: int, cum: torch.Tensor, *,
                  chunk: int) -> torch.Tensor:
    """Bucket index of each query in chunk ``c``: one uniform draw per
    query, inverted through the bucket CDF (right-open intervals)."""
    u = prng.uniform(prng.fold_in(k_bucket, c), (chunk,))
    return torch.searchsorted(cum, u, right=True).to(torch.int32)


@dataclass(frozen=True)
class BucketedWorkloadSpec:
    """A :class:`WorkloadSpec` carrying a request-size rate matrix.

    ``rates[i][j]`` is the arrival rate (queries/s) of the bucket with input
    scale ``input_scales[i]`` and output scale ``output_scales[j]``.  The
    base spec's arrivals and batches are untouched; the bucket of each query
    comes from its own ``fold_in``-derived stream, chunk for chunk.  Buckets
    flatten row-major into :class:`RequestBucket` descriptors.
    """

    base: WorkloadSpec
    rates: tuple[tuple[float, ...], ...]
    input_scales: tuple[float, ...] = (1.0,)
    output_scales: tuple[float, ...] = (1.0,)

    def __post_init__(self):
        if len(self.rates) != len(self.input_scales):
            raise ValueError("rates must have one row per input scale")
        if any(len(row) != len(self.output_scales) for row in self.rates):
            raise ValueError("rates must have one column per output scale")
        flat = [float(v) for row in self.rates for v in row]
        if any(v < 0 for v in flat) or not sum(flat) > 0:
            raise ValueError("bucket rates must be >= 0 with a positive sum")
        if abs(sum(flat) - self.base.rate_qps) > 1e-6 * self.base.rate_qps:
            raise ValueError(
                f"bucket rates sum to {sum(flat):g} qps but the base spec "
                f"arrives at {self.base.rate_qps:g} qps")
        if any(not s > 0 for s in self.input_scales + self.output_scales):
            raise ValueError("bucket scales must be > 0")

    @property
    def seed(self) -> int:
        return self.base.seed

    @property
    def rate_qps(self) -> float:
        return self.base.rate_qps

    @property
    def effective_rate(self) -> float:
        return self.base.effective_rate

    @property
    def chunk(self) -> int:
        return self.base.chunk

    @property
    def scale(self) -> float:
        return self.base.scale

    @property
    def max_batch(self) -> int:
        return self.base.max_batch

    @property
    def n_buckets(self) -> int:
        return len(self.input_scales) * len(self.output_scales)

    @property
    def buckets(self) -> tuple[RequestBucket, ...]:
        """Row-major flattened bucket descriptors (the ``bucket_of`` index
        order)."""
        return tuple(
            RequestBucket(name=f"in{i}.out{j}", rate=float(self.rates[i][j]),
                          flops_scale=float(self.output_scales[j]),
                          bytes_scale=float(self.input_scales[i]))
            for i in range(len(self.input_scales))
            for j in range(len(self.output_scales)))

    def scaled(self, load_factor: float) -> "BucketedWorkloadSpec":
        """Heavier traffic, same bucket mix (the drawn assignment does not
        change)."""
        return replace(self, base=self.base.scaled(load_factor))

    def _bucket_key(self):
        return prng.fold_in(prng.PRNGKey(self.base.seed), _BUCKET_STREAM_TAG)

    def _cum_probs(self) -> torch.Tensor:
        flat = np.asarray([v for row in self.rates for v in row],
                          dtype=np.float64)
        cum = np.cumsum(flat / flat.sum()).astype(np.float32)
        # The uniform draw lies in [0, 1): pin the last edge so float32
        # rounding never pushes it below a draw.
        cum[-1] = 1.0
        return torch.from_numpy(cum)

    def generate_chunk(self, c: int, base: float):
        """Host tensors of chunk ``c``: the base spec's three, then the
        bucket indices i32."""
        arr, local, batches = self.base.generate_chunk(c, base)
        return arr, local, batches, self._bucket(c)

    def _bucket(self, c: int) -> torch.Tensor:
        return _bucket_chunk(self._bucket_key(), c, self._cum_probs(),
                             chunk=self.base.chunk)

    def realize(self, n_queries: int) -> Workload:
        """Host :class:`Workload` with per-query bucket indices; arrivals
        and batches equal ``base.realize(n_queries)``."""
        arrs, bats, bkts = self.base._chunks(n_queries, extra=self._bucket)
        return Workload(arrivals=_concat(arrs, n_queries, np.float64,
                                         self.base.scale),
                        batches=_concat(bats, n_queries, np.int64),
                        rate_qps=float(self.base.effective_rate),
                        bucket_of=_concat(bkts, n_queries, np.int64),
                        buckets=self.buckets)


def generate_workload(seed: int, n_queries: int, rate_qps: float,
                      batch_dist: str = "lognormal",
                      median_batch: float = 24.0, sigma: float = 0.8,
                      mean_batch: float = 48.0, std_batch: float = 24.0,
                      max_batch: int = 256) -> Workload:
    """One seed, one stream: ``WorkloadSpec(...).realize(n_queries)``."""
    spec = WorkloadSpec(seed=seed, rate_qps=rate_qps, batch_dist=batch_dist,
                        median_batch=median_batch, sigma=sigma,
                        mean_batch=mean_batch, std_batch=std_batch,
                        max_batch=max_batch)
    return spec.realize(n_queries)
