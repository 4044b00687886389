"""Port parity: the H100 serving-cell catalog and the names of the
reference's core that the port adds for it — ``H100_CELLS``, the cell
search (``serving.cells``, the reference's ``bench_tpu_cells``
procedure), ``naive_cost_objective``, ``is_feasible`` and the
``GaussianProcess.x/.y/.mask`` properties.

The cell search runs in both packages on the reference's own
``TPU_CELLS`` constants (rebuilt in the port's ``InstanceType``): the
same homogeneous baseline, exhaustive optimum and RIBBON pick.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gp as ref_gp  # noqa: E402
from repro.core import objective as ref_objective  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.serving import instance as tinst  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving`` and ``repro.core``, imported with
    the ``enable_x64`` alias its import needs on jax 0.9, as in
    ``tests/test_torch_simulator.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro import core, serving
        from repro.serving import instance
    return {"serving": serving, "core": core, "inst": instance}


def test_h100_cells_form():
    cells = tinst.H100_CELLS
    assert cells is tserving.H100_CELLS
    assert list(cells) == ["h100x1", "h100x4", "h100x8"]
    f, b = 989e12 * 0.4, 3.35e12 * 0.5
    want = {"h100x1": (1, f, b, 1.5e-3),
            "h100x4": (4, f * 4 * 0.85, b * 4 * 0.9, 2.0e-3),
            "h100x8": (8, f * 8 * 0.75, b * 8 * 0.85, 2.4e-3)}
    for name, (chips, flops, bw, overhead) in want.items():
        cell = cells[name]
        assert cell.name == name and cell.chips == chips
        assert cell.flops == flops and cell.mem_bw == bw
        assert cell.overhead == overhead
        assert cell.price == tinst.H100_CARD_HOUR * chips
        assert cell.tier == "on_demand"
    # the new names stay out of the dense models' efficiency table, so the
    # model profiles stay the reference's
    assert not set(cells) & set(tinst._DENSE_EFF)


def test_h100_cells_keep_the_reference_cell_form(ref):
    """Each H100 cell is the reference's TPU cell of the same size with the
    card's rates in place of the chip's: the same sub-linear factors,
    overheads and per-chip price."""
    tpu = ref["inst"].TPU_CELLS
    chip_f, chip_b = tpu["cell1"].flops, tpu["cell1"].mem_bw
    card_f, card_b = tinst.H100_CELLS["h100x1"].flops, \
        tinst.H100_CELLS["h100x1"].mem_bw
    for n in (1, 4, 8):
        t, h = tpu[f"cell{n}"], tinst.H100_CELLS[f"h100x{n}"]
        assert (t.chips, t.overhead, t.price) == (h.chips, h.overhead,
                                                  h.price)
        np.testing.assert_allclose(h.flops / card_f, t.flops / chip_f,
                                   rtol=1e-12)
        np.testing.assert_allclose(h.mem_bw / card_b, t.mem_bw / chip_b,
                                   rtol=1e-12)


def _ref_search(ref, types, qos_target=0.99):
    """The reference benchmark's procedure (``benchmarks/bench_tpu_cells.py``
    ``run``) on the reference's own classes."""
    rs, rc = ref["serving"], ref["core"]
    wl = rs.workload.WorkloadSpec(seed=0, rate_qps=95.0, median_batch=8,
                                  max_batch=64).realize(1200)
    profile = rs.ModelProfile("llm-decode", flops_per_sample=6.0e9,
                              act_bytes_per_sample=2.5e8,
                              weight_bytes=1.4e10, qos_latency=0.20,
                              max_batch=64, median_batch=8)
    ev = rs.PoolEvaluator(profile, types, wl)
    space = rc.SearchSpace(bounds=(6, 8, 10),
                           prices=tuple(t.price for t in types))
    homog_cost, homog_n = np.inf, None
    for n in range(1, 7):
        if ev((n, 0, 0)) >= qos_target:
            homog_cost, homog_n = n * types[0].price, n
            break
    best_cfg, best_cost, _ = ev.exhaustive(space, qos_target)
    opt = rc.RibbonOptimizer(space, qos_target=qos_target,
                             start=(homog_n or 6, 0, 0))
    for _ in range(60):
        cfg = opt.ask()
        if cfg is None or opt.done:
            break
        opt.tell(cfg, float(ev(cfg)))
    found = opt.trace.best_feasible()
    return (homog_n, homog_cost, tuple(best_cfg), best_cost,
            tuple(found.config), found.cost, opt.trace.n_samples)


def test_cell_search_matches_the_reference_on_tpu_cells(ref):
    tpu = ref["inst"].TPU_CELLS
    names = ("cell8", "cell4", "cell1")
    types = [tinst.InstanceType(**dataclasses.asdict(tpu[n])) for n in names]
    got = tserving.search_cells(types, device=CPU)
    want = _ref_search(ref, [tpu[n] for n in names])
    assert (got.homog_count, got.homog_cost, got.best_config, got.best_cost,
            got.ribbon_config, got.ribbon_cost, got.ribbon_samples) == want
    assert got.best_cost < got.homog_cost
    assert got.ribbon_cost == got.best_cost
    assert tserving.LLM_PROFILE == tinst.ModelProfile(
        "llm-decode", 6.0e9, 2.5e8, 1.4e10, 0.20, 64, 8)


def test_cell_search_over_h100_cells():
    types = [tinst.H100_CELLS[n] for n in ("h100x8", "h100x4", "h100x1")]
    got = tserving.search_cells(types, device=CPU)
    assert got.best_config is not None and got.ribbon_config is not None
    assert got.best_cost <= got.homog_cost
    assert got.ribbon_cost >= got.best_cost
    assert 0 < got.ribbon_samples <= 61


@pytest.mark.parametrize("qos_rate, cost", [(0.95, 3.0), (0.99, 3.0),
                                            (0.999, 9.5), (1.0, 0.0)])
def test_naive_cost_objective_and_is_feasible(qos_rate, cost):
    args = (qos_rate, cost, 0.99, 10.0)
    assert tcore.naive_cost_objective(*args) == \
        ref_objective.naive_cost_objective(*args)
    assert tcore.is_feasible(qos_rate, 0.99) == \
        ref_objective.is_feasible(qos_rate, 0.99)
    assert tcore.is_feasible(np.float32(qos_rate), 0.99) == \
        ref_objective.is_feasible(np.float32(qos_rate), 0.99)


def test_gp_properties_match_reference():
    rng = np.random.default_rng(4)
    bounds = (5, 3, 7)
    gp = tcore.GaussianProcess(3, bounds, max_obs=16, device=CPU)
    rgp = ref_gp.GaussianProcess(3, bounds, max_obs=16)
    for _ in range(5):
        x, y = rng.integers(0, 5, 3), float(rng.random())
        gp.add(x, y)
        rgp.add(x, y)
    for name in ("x", "y", "mask"):
        got, want = getattr(gp, name), getattr(rgp, name)
        assert isinstance(got, torch.Tensor) and got.device.type == CPU
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gp.mask.sum()) == 5
