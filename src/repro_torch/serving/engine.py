"""Execution plane: live serving cells + FCFS dispatcher.

A ``ServingCell`` is the port's "instance": one model for one cell type,
with a price per hour and a speed factor.  The ``ClusterEngine`` owns a
pool of cells (counts per cell type, RIBBON's configuration vector),
dispatches queries first-come-first-served in pool-type order, executes
each query's batch for real on the device, and reports the measured QoS
satisfaction rate, which ``RibbonOptimizer`` takes through ``tell``.

Arrivals advance a virtual clock; service times are measured on the device
and divided by the cell's speed.  Counterpart of
``repro/serving/engine.py``; the dispatch and QoS arithmetic are the same
float64 host code, so with equal service times the two engines give equal
records.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import resolve_device, synchronize
from ..models.paper_models import PAPER_MODELS, make_random_batch
from .workload import Workload


@dataclass
class CellType:
    """A serving-cell flavor: model preset + price."""

    name: str
    price: float              # $/hour for the cell
    chips: int = 1
    preset: str = "full"
    # per-cell slowdown factor: emulates heterogeneous cell speeds on one
    # physical device (measured service seconds are divided by it)
    speed: float = 1.0


class ServingCell:
    def __init__(self, cell_type: CellType, model_name: str, params,
                 apply_fn, device: torch.device):
        self.cell_type = cell_type
        self.model_name = model_name
        self._apply = apply_fn
        self._params = params
        self.device = device
        self.busy_until = 0.0       # virtual-time availability
        self.n_served = 0
        self.failed = False

    def execute(self, batch) -> float:
        """Run the batch for real; returns measured service seconds scaled by
        the cell's speed factor.  The clock starts after the device has
        drained earlier work and stops after it has finished this batch."""
        if self.failed:
            raise RuntimeError(f"cell {self.cell_type.name} is failed")
        synchronize(self.device)
        t0 = time.perf_counter()
        self._apply(self._params, batch)
        synchronize(self.device)
        wall = time.perf_counter() - t0
        self.n_served += 1
        return wall / self.cell_type.speed


@dataclass
class QueryRecord:
    arrival: float
    batch_size: int
    latency: float
    cell: str
    wait: float = 0.0         # queue time before service started
    hedged: bool = False
    # Index (in the live-cell order) of the cell whose availability this
    # query advanced — the hedge winner when a hedge overtook the primary.
    slot: int = -1


def _bucket(batch_size: int) -> int:
    """Batch sizes are bucketed to powers of two: it bounds the number of
    distinct shapes each cell runs (standard serving practice)."""
    return 1 << int(np.ceil(np.log2(max(int(batch_size), 1))))


class ClusterEngine:
    """Pool of live cells + FCFS dispatch, with failure injection and
    hedged-request straggler mitigation."""

    def __init__(self, model_name: str, cell_types: list[CellType],
                 seed: int = 0, hedge_threshold: float | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.model_name = model_name
        # Copies: a repricing (``LivePlane.apply_price``) changes this
        # engine's cell types, never the caller's (``DEFAULT_CELLS``).
        self.cell_types = [replace(ct) for ct in cell_types]
        self.model = PAPER_MODELS[model_name]
        self.hedge_threshold = hedge_threshold
        self._params = {}
        for ct in cell_types:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self._params[ct.name] = self.model.init(gen, ct.preset,
                                                    self.device)
        self.cells: list[ServingCell] = []
        self.records: list[QueryRecord] = []

    def _batch(self, preset: str, bucket: int) -> dict:
        return make_random_batch(self.model_name, preset, bucket,
                                 device=self.device)

    def warmup(self, max_batch: int = 32) -> None:
        """Run every (cell type × power-of-two bucket) once, so first-call
        costs (kernel build and load, library handles) never pollute
        measured service latencies."""
        b = 1
        while b <= max_batch:
            for ct in self.cell_types:
                self.model.apply(self._params[ct.name],
                                 self._batch(ct.preset, b))
            b *= 2
        synchronize(self.device)

    # ------------------------------------------------------------- pool ops
    def configure(self, config) -> None:
        """config = counts per cell type (RIBBON's x vector)."""
        self.cells = []
        for ct, count in zip(self.cell_types, config):
            for _ in range(int(count)):
                self.cells.append(ServingCell(ct, self.model_name,
                                              self._params[ct.name],
                                              self.model.apply, self.device))

    def fail_cell(self, index: int) -> CellType:
        """Inject a cell failure (node loss).  Returns the lost type."""
        cell = self.cells[index]
        cell.failed = True
        return cell.cell_type

    def preempt(self, type_index: int, count: int = 1) -> int:
        """Spot preemption: the market reclaims up to ``count`` live cells of
        one type; the capacity is gone until ``configure`` re-provisions.
        Returns the number of cells actually preempted."""
        name = self.cell_types[type_index].name
        hit = 0
        for cell in self.cells:
            if hit >= count:
                break
            if not cell.failed and cell.cell_type.name == name:
                cell.failed = True
                hit += 1
        return hit

    def active_config(self) -> tuple[int, ...]:
        counts = {ct.name: 0 for ct in self.cell_types}
        for c in self.cells:
            if not c.failed:
                counts[c.cell_type.name] += 1
        return tuple(counts[ct.name] for ct in self.cell_types)

    # ------------------------------------------------------------- serving
    def serve(self, workload: Workload, qos_latency: float,
              time_scale: float = 1.0, initial_busy=None) -> float:
        """Serve the stream; returns the QoS satisfaction rate.

        Arrivals advance a virtual clock; service times are *measured* on the
        device (scaled by cell speed).  ``time_scale`` stretches arrival
        gaps.  ``initial_busy`` warm-starts the pool: one busy-until time per
        live cell in the (scaled) arrival frame.  Omitted, every cell starts
        idle.
        """
        self.records = []
        live = [c for c in self.cells if not c.failed]
        if not live:
            return 0.0
        if initial_busy is None:
            for c in live:
                c.busy_until = 0.0
        else:
            if len(initial_busy) != len(live):
                raise ValueError(
                    f"initial_busy has {len(initial_busy)} entries for "
                    f"{len(live)} live cells")
            for c, b in zip(live, initial_busy):
                c.busy_until = float(b)
        pos = {id(c): k for k, c in enumerate(live)}
        ok = 0
        for arrival, bsz in zip(workload.arrivals * time_scale,
                                workload.batches):
            idle = [c for c in live if c.busy_until <= arrival]
            cell = idle[0] if idle else min(live, key=lambda c: c.busy_until)
            start = max(arrival, cell.busy_until)
            batch = self._batch(cell.cell_type.preset, _bucket(bsz))
            svc = cell.execute(batch)
            finish = start + svc
            wait = start - arrival
            hedged = False
            if (self.hedge_threshold is not None
                    and start - arrival > self.hedge_threshold):
                # straggler mitigation: duplicate to the next-free cell and
                # take the earlier finish
                alt = min((c for c in live if c is not cell),
                          key=lambda c: c.busy_until, default=None)
                if alt is not None:
                    alt_start = max(arrival, alt.busy_until)
                    alt_svc = alt.execute(batch)
                    alt_finish = alt_start + alt_svc
                    if alt_finish < finish:
                        finish = alt_finish
                        alt.busy_until = alt_finish
                        wait = alt_start - arrival
                        hedged = True
            winner = cell
            if not hedged:
                cell.busy_until = finish
            else:
                winner = alt
            latency = finish - arrival
            self.records.append(QueryRecord(float(arrival), int(bsz),
                                            float(latency),
                                            cell.cell_type.name,
                                            wait=float(wait), hedged=hedged,
                                            slot=pos[id(winner)]))
            if latency <= qos_latency:
                ok += 1
        return ok / len(workload.arrivals)

    def served_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(latencies, waits) of the last ``serve`` call, in arrival order."""
        lat = np.asarray([r.latency for r in self.records], dtype=np.float64)
        waits = np.asarray([r.wait for r in self.records], dtype=np.float64)
        return lat, waits

    def pool_price(self, config=None) -> float:
        if config is not None:
            return float(sum(ct.price * int(c)
                             for ct, c in zip(self.cell_types, config)))
        return float(sum(c.cell_type.price for c in self.cells
                         if not c.failed))


DEFAULT_CELLS = [
    CellType("cell1", price=1.2, chips=1, speed=1.0),
    CellType("cell4", price=4.8, chips=4, speed=3.4),
    CellType("cell8", price=9.6, chips=8, speed=6.0),
]
"""Three cell types at the served model's full width.  The prices and speed
factors are the reference's illustrative values (``DEFAULT_TPU_CELLS``), not
measurements of any chip.  On one card every cell maps to the one device and
``speed`` emulates the heterogeneity, as the reference does on a CPU."""
