"""Port parity: capacity tiers (ROADMAP A-12), ``repro_torch.serving.tiers``
against ``repro.serving.tiers``.

Every name of the module on the same inputs in both packages: the tier
table (``CapacityTier``, ``TIERS``, ``TIER_NAMES``), the seeded storm
timeline (``TierHazard.storms``) and spot price walk
(``SpotPriceProcess.events``) over seeds, tiers and rates, the catalog
(``TierCatalog``: tier indices, cold starts, risk premiums, the unknown-tier
check), ``tiered_variant`` and ``tiered_pool`` for every model with a
hybrid pool.  Then the tiers at work on the port's simulator: the cold
starts a catalog gives, charged through the warm lanes' ``warmup=``, equal
the reference's rates bit for bit, and its risk premiums give the same
optimizer costs.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import RibbonOptimizer, SearchSpace  # noqa: E402
from repro_torch.serving import instance as tinst  # noqa: E402
from repro_torch.serving import simulator as tsim  # noqa: E402
from repro_torch.serving import tiers as ttiers  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402
from repro_torch.serving.handoff import from_fields  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving`` tiers, simulator and pool modules,
    imported with the ``enable_x64`` alias their import needs on jax 0.9,
    as in ``tests/test_torch_simulator.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import instance, simulator, tiers, workload
    import repro.core as core
    return {"tiers": tiers, "sim": simulator, "inst": instance,
            "wl": workload, "core": core}


def _fields(x):
    return dataclasses.asdict(x)


def test_tier_table(ref):
    r = ref["tiers"]
    assert ttiers.TIER_NAMES == r.TIER_NAMES
    assert {k: _fields(v) for k, v in ttiers.TIERS.items()} == {
        k: _fields(v) for k, v in r.TIERS.items()}
    assert ttiers._COLD_AMORTIZATION == r._COLD_AMORTIZATION
    assert ttiers.TIERED_POOLS == r.TIERED_POOLS


@pytest.mark.parametrize("tier", ["spot", "on_demand", "serverless"])
@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("n_phases,rate", [(4, None), (6, 2.5), (3, 0.05),
                                           (1, None)])
def test_tier_hazard_storms(ref, tier, seed, n_phases, rate):
    got = ttiers.TierHazard(tier, seed, n_phases, rate=rate)
    want = ref["tiers"].TierHazard(tier, seed, n_phases, rate=rate)
    assert (got.rate, got.kill_fraction) == (want.rate, want.kill_fraction)
    assert got.storms() == want.storms()


@pytest.mark.parametrize("seed", [0, 3, 42])
@pytest.mark.parametrize("kw", [{}, dict(drift=0.2, spike_prob=0.8),
                                dict(band=(0.9, 1.1))])
def test_spot_price_process_events(ref, seed, kw):
    for n in (0, 1, 5, 12):
        assert (ttiers.SpotPriceProcess(seed, **kw).events(n)
                == ref["tiers"].SpotPriceProcess(seed, **kw).events(n))


@pytest.mark.parametrize("model", ["mtwnd", "dien"])
def test_tiered_pool_and_catalog(ref, model):
    """The hybrid pool's types and bounds, and its catalog's tier indices,
    cold starts (against each paper model's QoS target) and premiums."""
    t_types, t_bounds = ttiers.tiered_pool(model)
    r_types, r_bounds = ref["tiers"].tiered_pool(model)
    assert t_bounds == r_bounds
    assert [_fields(t) for t in t_types] == [_fields(t) for t in r_types]
    tcat, rcat = ttiers.TierCatalog(t_types), ref["tiers"].TierCatalog(r_types)
    assert tcat.tiers == rcat.tiers
    for tier in ttiers.TIER_NAMES:
        assert tcat.tier_indices(tier) == rcat.tier_indices(tier)
    for name in tinst.MODEL_PROFILES:
        np.testing.assert_array_equal(
            tcat.cold_starts(tinst.MODEL_PROFILES[name]),
            rcat.cold_starts(ref["inst"].MODEL_PROFILES[name]))
    assert tcat.cost_penalties() == rcat.cost_penalties()


@pytest.mark.parametrize("base", ["g4dn", "c5", "r5n", "t3"])
@pytest.mark.parametrize("tier", ["on_demand", "spot", "serverless"])
def test_tiered_variant(ref, base, tier):
    got = ttiers.tiered_variant(tinst.AWS_INSTANCES[base], tier)
    want = ref["tiers"].tiered_variant(ref["inst"].AWS_INSTANCES[base], tier)
    assert _fields(got) == _fields(want)
    # The variant keeps its base hardware's efficiency entry.
    prof = tinst.MODEL_PROFILES["mtwnd"]
    assert prof.eff(got.name) == prof.eff(base)


def test_tier_catalog_rejects_unknown_tier(ref):
    bad = dataclasses.replace(tinst.AWS_INSTANCES["g4dn"], tier="reserved")
    with pytest.raises(ValueError, match="unknown capacity tiers"):
        ttiers.TierCatalog([bad])
    assert ttiers.TierCatalog([tinst.AWS_INSTANCES["c5"]]).tiers == (
        "on_demand",)


def test_cold_starts_through_the_warm_lanes(ref):
    """mtwnd's hybrid pool from a live backlog: candidates scored with the
    catalog's cold starts (``warmup=``) on the batch and grid lanes, the
    reference's rates bit for bit, at the catalog's boots and at 4x them."""
    r_types, _ = ref["tiers"].tiered_pool("mtwnd")
    t_types, _ = ttiers.tiered_pool("mtwnd")
    wl = ref["wl"].generate_workload(0, 600, 800.0, median_batch=24.0,
                                     max_batch=256)
    rsim = ref["sim"].PoolSimulator(ref["inst"].MODEL_PROFILES["mtwnd"],
                                    r_types, wl)
    tsim_ = tsim.PoolSimulator(
        tinst.MODEL_PROFILES["mtwnd"], t_types,
        twl.Workload(arrivals=wl.arrivals, batches=wl.batches,
                     rate_qps=wl.rate_qps), device=CPU)
    deployed, upto = (2, 2, 0, 0), 300
    seg = rsim.segment_from(rsim.initial_state(), deployed)
    rstate = seg.state_at(upto).rebased(float(wl.arrivals[upto - 1]))
    tstate = from_fields("PoolState", vars(rstate))
    warm = ttiers.TierCatalog(t_types).cold_starts(
        tinst.MODEL_PROFILES["mtwnd"])
    cfgs = np.array([(2, 2, 0, 0), (4, 2, 0, 0), (2, 6, 0, 0), (2, 2, 2, 2),
                     (0, 0, 3, 3)])
    for boot in (warm, warm * 4):
        for kw in (dict(), dict(workloads=[1.0, 1.4])):
            got = tsim_.qos(cfgs, state=tstate, deployed=deployed,
                            warmup=boot, **kw).rates
            want = rsim.qos(cfgs, state=rstate, deployed=deployed,
                            warmup=boot, **kw).rates
            np.testing.assert_array_equal(got, want)


def test_risk_premiums_shift_optimizer_costs(ref):
    """The catalog's premiums as the optimizer's ``cost_penalties``: the
    same risk-adjusted lattice costs and Eq. 2 normaliser as the
    reference's optimizer."""
    t_types, bounds = ttiers.tiered_pool("mtwnd")
    pen = ttiers.TierCatalog(t_types).cost_penalties()
    prices = tuple(t.price for t in t_types)
    got = RibbonOptimizer(SearchSpace(bounds=bounds, prices=prices),
                          cost_penalties=pen, device=CPU)
    want = ref["core"].RibbonOptimizer(
        ref["core"].SearchSpace(bounds=bounds, prices=prices),
        cost_penalties=pen)
    np.testing.assert_array_equal(got.lattice_costs, want.lattice_costs)
    assert got._max_cost == want._max_cost
