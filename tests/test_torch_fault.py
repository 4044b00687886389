"""Port parity: fault handling (ROADMAP A-12), ``repro_torch.serving.fault``
against ``repro.serving.fault``.

Every function of the module on the same inputs in both packages:
``fail_instances`` (and its argument checks), ``continue_search``,
``recover_from_capacity_change`` (several types at once, restocks with a
negative loss, pessimistic replay), ``recover_from_failure``, ``reprice``
(the full history replayed, no new measurement), and the host loop
``simulate_fcfs_hedged`` with stragglers and hedging, exactly.  The
searches run on one deterministic oracle; their events, traces and final
optimizers' picks must agree (``ScaleEvent`` field by field).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import RibbonOptimizer, SearchSpace  # noqa: E402
from repro_torch.serving import fault as tfault  # noqa: E402
from repro_torch.serving import instance as tinst  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs, as in
    ``tests/test_torch_scenario.py``: small ops spread over every core
    make a parallel run's workers fight for the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving.fault`` and ``repro.core``, imported
    with the ``enable_x64`` alias ``repro.serving`` needs on jax 0.9, as in
    ``tests/test_torch_engine.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import fault, instance, workload
    import repro.core as core
    return {"fault": fault, "core": core, "inst": instance, "wl": workload}


def monotone_oracle(caps, demand):
    caps = np.asarray(caps, float)

    def f(cfg):
        return min(1.0, float(np.dot(caps, np.asarray(cfg, float))) / demand)
    return f


def _searched(core, bounds, oracle, rounds, **kw):
    """An optimizer after ``rounds`` sequential ask/tell rounds; ``core``
    is the reference's ``repro.core`` or ``_Port`` (on the CPU)."""
    space = core.SearchSpace(bounds=bounds, prices=(1.0, 0.3))
    if core is _Port:
        kw["device"] = CPU
    opt = core.RibbonOptimizer(space, qos_target=0.99, **kw)
    for _ in range(rounds):
        cfg = opt.ask()
        if cfg is None or opt.done:
            break
        opt.tell(cfg, oracle(cfg))
    return opt


class _Port:
    SearchSpace = SearchSpace
    RibbonOptimizer = RibbonOptimizer


def _trace(opt):
    return [(tuple(e.config), e.qos_rate, e.estimated)
            for e in opt.trace.evaluations]


def _event(ev):
    return {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
            for k, v in vars(ev).items()}


@pytest.mark.parametrize("cfg,index,count", [
    ((3, 2, 1), 0, 1), ((0, 2, 1), 0, 1), ((3, 2), 0, 5), ((3, 2), 1, 0)])
def test_fail_instances(ref, cfg, index, count):
    assert (tfault.fail_instances(cfg, index, count)
            == ref["fault"].fail_instances(cfg, index, count))


@pytest.mark.parametrize("index,count,match", [
    (2, 1, "type_index"), (-1, 1, "type_index"), (0, -1, "count")])
def test_fail_instances_validates_arguments(ref, index, count, match):
    for mod in (tfault, ref["fault"]):
        with pytest.raises(ValueError, match=match):
            mod.fail_instances((3, 2), index, count)


CASES = {
    # name: (bounds, rounds, losses, kwargs)
    "multi_type": ((5, 8), 30, {0: 2, 1: 3}, dict(kind="recover_storm")),
    "restock": ((3, 8), 25, {0: -2}, dict(kind="restock")),
    "pessimistic": ((5, 8), 20, {1: 2}, dict(replay=False)),
}
# Cases whose continued (sequential) search meets an EI near-tie: in
# "multi_type" the two open candidates' EI are 2.8e-9 and 1.1e-9 in the
# reference and 0.9e-9 and 1.1e-9 in the port (float32 noise, ROADMAP
# C-R20), so the port asks (3, 1) before (2, 4) and spends one sample more
# (5 against 4) to the same pool and price.
NEAR_TIE = {"multi_type"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_recover_from_capacity_change(ref, case):
    """The same reduced (or grown) space, the same replayed history, the
    same recovered pool and price in both packages; and, where no EI
    near-tie intervenes, the same continued search and the same event."""
    bounds, rounds, losses, kw = CASES[case]
    oracle = monotone_oracle((10.0, 3.0), demand=31.0)
    r_opt = _searched(ref["core"], bounds, oracle, rounds)
    t_opt = _searched(_Port, bounds, oracle, rounds)
    assert _trace(t_opt) == _trace(r_opt)
    r_new, r_ev = ref["fault"].recover_from_capacity_change(
        r_opt, oracle, losses, budget=30, **kw)
    t_new, t_ev = tfault.recover_from_capacity_change(
        t_opt, oracle, losses, budget=30, **kw)
    assert t_new.space.bounds == r_new.space.bounds
    assert t_new.device == t_opt.device
    replayed = len(r_new.trace.evaluations) - r_ev.samples_used
    assert _trace(t_new)[:replayed] == _trace(r_new)[:replayed]
    got, want = _event(t_ev), _event(r_ev)
    if case in NEAR_TIE:
        assert (got.pop("samples_used"), want.pop("samples_used")) == (5, 4)
    else:
        assert _trace(t_new) == _trace(r_new)
    assert got == want
    with pytest.raises(ValueError, match="type_index"):
        tfault.recover_from_capacity_change(t_opt, oracle, {5: 1})


def test_recover_from_failure(ref):
    oracle = monotone_oracle((10.0, 3.0), demand=31.0)
    r_opt = _searched(ref["core"], (5, 8), oracle, 30)
    t_opt = _searched(_Port, (5, 8), oracle, 30)
    r_new, r_ev = ref["fault"].recover_from_failure(
        r_opt, oracle, failed_type=0, lost=2, budget=30)
    t_new, t_ev = tfault.recover_from_failure(
        t_opt, oracle, failed_type=0, lost=2, budget=30)
    assert t_new.space.bounds == r_new.space.bounds == (3, 8)
    assert _trace(t_new) == _trace(r_new)
    assert _event(t_ev) == _event(r_ev)


def test_continue_search(ref):
    oracle = monotone_oracle((10.0, 3.0), demand=31.0)
    r_opt = _searched(ref["core"], (5, 8), oracle, 3)
    t_opt = _searched(_Port, (5, 8), oracle, 3)
    assert (tfault.continue_search(t_opt, oracle, 7)
            == ref["fault"].continue_search(r_opt, oracle, 7))
    assert _trace(t_opt) == _trace(r_opt)


def test_reprice_replays_history_without_new_evaluations(ref):
    """A fully explored space repriced: no new measurement in either
    package, and the same event at the new prices."""
    def oracle(cfg):
        calls.append(tuple(cfg))
        return min(1.0, (3.0 * cfg[0] + 1.0 * cfg[1]) / 5.0)

    events = []
    for core, mod in ((ref["core"], ref["fault"]), (_Port, tfault)):
        calls = []
        space = core.SearchSpace(bounds=(2, 2), prices=(1.0, 0.3))
        kw = {"device": CPU} if core is _Port else {}
        opt = core.RibbonOptimizer(space, qos_target=0.99, **kw)
        for cfg in space.enumerate():
            opt.tell(tuple(int(c) for c in cfg), oracle(tuple(cfg)))
        before = len(calls)
        new_opt, ev = mod.reprice(opt, (0.2, 5.0), oracle, budget=20)
        assert len(calls) == before
        assert new_opt.space.prices == (0.2, 5.0)
        events.append((_event(ev), _trace(new_opt)))
    assert events[1] == events[0]


TOY = dict(name="fast", price=1.0, flops=1e9, mem_bw=1e9, overhead=1e-3)
PROF = dict(name="toy", flops_per_sample=1e6, act_bytes_per_sample=1e4,
            weight_bytes=1e5, qos_latency=0.05)


@pytest.mark.parametrize("straggler,hedge", [
    (None, None), ((8.0, (0,)), None), ((8.0, (0,)), 0.01),
    ((4.0, (0, 2)), 0.002), (None, 0.005)])
def test_simulate_fcfs_hedged_exactly(ref, straggler, hedge):
    """The host loop on one stream, pool and straggler: the reference's
    latencies exactly."""
    wl = ref["wl"].generate_workload(0, 600, 150.0, median_batch=8,
                                     max_batch=32)
    twl_ = twl.Workload(arrivals=np.asarray(wl.arrivals),
                        batches=np.asarray(wl.batches),
                        rate_qps=wl.rate_qps)
    out = []
    for inst, fault, w in ((ref["inst"], ref["fault"], wl),
                           (tinst, tfault, twl_)):
        strag = (None if straggler is None
                 else fault.StragglerModel(slow_factor=straggler[0],
                                           afflicted=straggler[1]))
        out.append(fault.simulate_fcfs_hedged(
            w, [inst.InstanceType(**TOY)], (3,), inst.ModelProfile(**PROF),
            straggler=strag, hedge_threshold=hedge))
    np.testing.assert_array_equal(out[1], out[0])
