"""Port parity: the scenario engine's two tiered episodes (ROADMAP A-13),
``spot-storm`` and ``tier-outage`` on mtwnd's hybrid capacity-tier plane
(``tiered_simulator_plane``: ``serving/tiers.py`` cold starts and risk
premiums, ``serving/fault.py`` recoveries), against ``repro.scenario`` as
``tests/test_torch_scenario.py`` holds the other episodes: the same
``EpisodeReport`` from the same streams, or for ``tier-outage``, which
parts at an EI near-tie (ROADMAP C-R20), its windows up to the first
differing action and a bit-for-bit replay of the reference run's plane and
evaluator calls on the port's plane.  A file of its own: the two are the
slowest episodes (the GP over the tiered lattice of 5103 pools), and a
parallel run takes them on another worker.
"""

import jax
import pytest

torch = pytest.importorskip("torch")

from test_torch_scenario import check_episode, one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.scenario`` and ``repro.serving`` modules,
    imported with the ``enable_x64`` alias ``repro.serving`` needs on jax
    0.9, as in ``tests/test_torch_scenario.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.scenario import engine, planes, registry
        from repro.serving import instance, pool, tiers, workload
    from repro.core.search_space import SearchSpace
    return {"engine": engine, "planes": planes, "registry": registry,
            "inst": instance, "pool": pool, "tiers": tiers, "wl": workload,
            "SearchSpace": SearchSpace}


@pytest.mark.parametrize("name", ["spot-storm", "tier-outage"])
def test_tiered_episode_reports_equal_the_reference(ref, name):
    check_episode(ref, name)
