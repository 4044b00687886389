"""Query-stream workload generation (paper §5.1).

* Query inter-arrival times follow a **Poisson process** (exponential
  inter-arrival gaps).
* Batch sizes follow a **heavy-tail log-normal** distribution (the paper's
  default), with a **Gaussian** alternative (paper Fig. 11).

Counterpart of ``repro/serving/workload.py``.  The stream is drawn from a
CPU ``torch.Generator`` seeded with the spec's seed, so one seed gives one
stream on every host.  The numbers differ from the reference's threefry
draws of the same seed; the distributions and the float32 arithmetic are
the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch


@dataclass(frozen=True)
class Workload:
    """A concrete query stream."""

    arrivals: np.ndarray      # (n,) absolute arrival times, seconds, sorted
    batches: np.ndarray       # (n,) int batch size per query
    rate_qps: float           # nominal arrival rate

    @property
    def n_queries(self) -> int:
        return len(self.arrivals)

    def scaled(self, load_factor: float) -> "Workload":
        """Same query sequence under a different load level (paper §5.5:
        'the load becomes 1.5 times heavier' compresses inter-arrivals)."""
        return Workload(arrivals=self.arrivals / load_factor,
                        batches=self.batches,
                        rate_qps=self.rate_qps * load_factor)


@dataclass(frozen=True)
class WorkloadSpec:
    """Generative description of a query stream.

    The stream is drawn chunk by chunk (``chunk`` queries each, gaps and
    then batch sizes), inter-arrival gaps accumulating in float32 onto the
    previous chunk's last unscaled arrival, so a shorter realisation is a
    prefix of a longer one.  ``scale`` compresses arrivals as
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

    def realize(self, n_queries: int) -> Workload:
        """Host :class:`Workload` of the stream's first ``n_queries``."""
        if n_queries < 0:
            raise ValueError("n_queries must be >= 0")
        gen = torch.Generator().manual_seed(self.seed)
        if self.batch_dist == "lognormal":
            p_a = torch.tensor(math.log(self.median_batch), dtype=torch.float32)
            p_b = torch.tensor(self.sigma, dtype=torch.float32)
        else:
            p_a = torch.tensor(self.mean_batch, dtype=torch.float32)
            p_b = torch.tensor(self.std_batch, dtype=torch.float32)
        rate = torch.tensor(self.rate_qps, dtype=torch.float32)
        arrs, bats = [], []
        base = torch.zeros((), dtype=torch.float32)
        for _ in range(math.ceil(n_queries / self.chunk)):
            gaps = torch.empty(self.chunk).exponential_(generator=gen) / rate
            local = base + torch.cumsum(gaps, dim=0)
            z = torch.randn(self.chunk, generator=gen)
            raw = (torch.exp(p_a + p_b * z) if self.batch_dist == "lognormal"
                   else p_a + p_b * z)
            bats.append(torch.clamp(torch.round(raw), 1.0,
                                    float(self.max_batch)).to(torch.int64))
            arrs.append(local)
            base = local[-1]
        if arrs:
            arr64 = torch.cat(arrs)[:n_queries].numpy().astype(np.float64)
            bat64 = torch.cat(bats)[:n_queries].numpy()
        else:
            arr64 = np.zeros(0, dtype=np.float64)
            bat64 = np.zeros(0, dtype=np.int64)
        if self.scale != 1.0:
            arr64 = arr64 / np.float64(self.scale)
        return Workload(arrivals=arr64, batches=bat64,
                        rate_qps=float(self.effective_rate))
