"""Port parity: streaming (ROADMAP A-10) in ``repro_torch`` against
``repro.serving.simulator``.

* The plain stream flavour of the FCFS scan (``ref.fcfs_stream_ref``, and
  ``ops.fcfs_stream`` on the CPU) against the reference's ``_stream_chunk``
  a chunk at a time, bit for bit (final carry and QoS count): full chunks,
  a masked final chunk against a shorter scan, a nonzero shift, a bucketed
  table, slot widths 8 and 40.
* ``StreamingSimulator`` against the reference's for the cases of
  ``tests/test_streaming.py`` (monolithic-equal, a single partial chunk,
  edge cases and ``probe``, scaled chaining, the rebase, the envelope
  error, bucketed specs), fed the reference's own chunks through a thin
  spec wrapper: the same rates and rebases bit for bit.
* From the seed alone, the port's own stream: ``StreamingSimulator`` equals
  the port's ``PoolSimulator.qos`` on ``spec.realize(n)``, and mtwnd's
  (2, 3, 3) over 10,000 queries at 800 qps gives 0.9821, the reference's
  rate on its own stream and on the port's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fcfs_scan import BIG  # noqa: E402
from repro_torch.kernels.ref import fcfs_stream_ref  # noqa: E402
from repro_torch.serving import instance as tinst  # noqa: E402
from repro_torch.serving import pool as tpool  # noqa: E402
from repro_torch.serving import simulator as tsim  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

CPU = "cpu"
MAX_INST = 8
TOY = dict(
    fast=dict(name="fast", price=1.0, flops=1e9, mem_bw=1e9, overhead=1e-3),
    slow=dict(name="slow", price=0.3, flops=2e8, mem_bw=5e8, overhead=2e-3))
PROF = dict(name="toy", flops_per_sample=1e6, act_bytes_per_sample=1e4,
            weight_bytes=1e5, qos_latency=0.05)


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
    """The reference's ``repro.serving`` simulator, workload and instance
    modules, imported with the ``enable_x64`` alias their import needs on
    jax 0.9, as in ``tests/test_torch_simulator.py``."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import instance, pool, simulator, workload
    return {"sim": simulator, "wl": workload, "inst": instance,
            "pool": pool}


def _toy(mod):
    """(profile, [fast, slow]) of the reference's streaming tests, built
    from ``mod`` (either package's ``serving.instance``)."""
    return (mod.ModelProfile(**PROF),
            [mod.InstanceType(**TOY["fast"]), mod.InstanceType(**TOY["slow"])])


def _ref_spec(ref, seed=0, rate=120.0, chunk=256, **kw):
    kw.setdefault("median_batch", 8.0)
    kw.setdefault("mean_batch", 10.0)
    kw.setdefault("std_batch", 4.0)
    kw.setdefault("max_batch", 32)
    return ref["wl"].WorkloadSpec(seed=seed, rate_qps=rate, chunk=chunk, **kw)


def _port_spec(seed=0, rate=120.0, chunk=256, **kw):
    kw.setdefault("median_batch", 8.0)
    kw.setdefault("mean_batch", 10.0)
    kw.setdefault("std_batch", 4.0)
    kw.setdefault("max_batch", 32)
    return twl.WorkloadSpec(seed=seed, rate_qps=rate, chunk=chunk, **kw)


class _Chunks:
    """A spec for the port that hands over the reference spec's own chunks
    (its generate_chunk, as host tensors): the streamed bits then depend
    on the simulators alone."""

    def __init__(self, spec):
        self.spec = spec

    def __getattr__(self, name):
        if name == "buckets":
            buckets = getattr(self.spec, "buckets", None)
            return None if buckets is None else tuple(
                twl.RequestBucket(**vars(b)) for b in buckets)
        return getattr(self.spec, name)

    def generate_chunk(self, c, base):
        return tuple(torch.from_numpy(np.array(x))
                     for x in self.spec.generate_chunk(c, base))


def _streams(ref, spec):
    """(reference StreamingSimulator on ``spec``, the port's on its
    chunks), the toy pool, max_instances 8."""
    rprof, rtypes = _toy(ref["inst"])
    tprof, ttypes = _toy(tinst)
    return (ref["sim"].StreamingSimulator(rprof, rtypes, spec,
                                          max_instances=MAX_INST),
            tsim.StreamingSimulator(tprof, ttypes, _Chunks(spec),
                                    max_instances=MAX_INST, device=CPU))


# ------------------------------------------- the kernel's plain version
def _chunk_inputs(ref, width, seed, n_lut=33, nq=200):
    """One chunk's operands: a toy LUT, a random layout of ``width``
    slots, a warm carry and arrivals on a local clock."""
    rng = np.random.default_rng(seed)
    lut = rng.uniform(1e-3, 2e-2, (n_lut, 3)).astype(np.float32)
    cfg = (2, 1, 2) if width == 8 else (10, 12, 8)
    tos, active = ref["sim"]._expand_slots(np.array([cfg]), 3, 40)
    tos, active = tos[0, :width], active[0, :width]
    free = np.where(active, rng.uniform(0.0, 0.05, width),
                    1e30).astype(np.float32)
    arr = np.cumsum(rng.exponential(1 / 900.0, nq)).astype(np.float32)
    bat = rng.integers(1, n_lut, nq).astype(np.int32)
    return lut, tos.astype(np.int32), free, arr, bat


def _ref_chunk(ref, free, count, shift, arr, bat, valid, lut, tos, qos_t):
    width = len(tos)
    out = jax.jit(ref["sim"]._stream_chunk)(
        jnp.asarray(free), jnp.int32(count), jnp.float32(shift),
        jnp.asarray(arr), jnp.asarray(bat), jnp.asarray(valid),
        jnp.asarray(lut), jnp.asarray(tos),
        jnp.arange(width, dtype=jnp.float32),
        jnp.arange(width, dtype=jnp.int32), jnp.float32(qos_t))
    return np.asarray(out[0]), int(out[1])


def _port_chunk(free, count, shift, arr, bat, lut, tos, qos_t):
    t = torch.from_numpy
    c, f = fcfs_stream_ref(t(arr)[None], t(bat)[None], t(lut), t(tos)[None],
                           torch.arange(len(tos), dtype=torch.float32),
                           t(free)[None, None], torch.tensor([[count]],
                                                             dtype=torch.int32),
                           shift, qos_t, BIG)
    return f[0, 0].numpy(), int(c[0, 0])


@pytest.mark.parametrize("width", [8, 40])
@pytest.mark.parametrize("case", ["full", "partial", "shift", "bucketed"])
def test_stream_flavour_plain_matches_stream_chunk(ref, width, case):
    """``fcfs_stream_ref`` against the reference's ``_stream_chunk``, bit
    for bit: the final carry and the carried count.  The reference masks
    a partial chunk's tail; the port scans ``left`` queries."""
    n_lut = 99 if case == "bucketed" else 33
    lut, tos, free, arr, bat = _chunk_inputs(ref, width, width, n_lut)
    if case == "bucketed":
        # rows bucket * (max_batch + 1) + batch over three blocks of 33
        bat = (np.arange(len(bat)) % 3 * 33 + bat % 33).astype(np.int32)
    shift = float(np.float32(0.0173)) if case == "shift" else 0.0
    if case == "shift":   # the carry still in the previous origin's frame
        free = np.where(free < 1e29, free + np.float32(0.0173),
                        free).astype(np.float32)
    qos_t = 0.03
    valid = np.ones(len(arr), dtype=bool)
    left = len(arr)
    if case == "partial":
        left = 137
        valid[left:] = False
    want_free, want_count = _ref_chunk(ref, free, 5, shift, arr, bat, valid,
                                       lut, tos, qos_t)
    got_free, got_count = _port_chunk(free, 5, shift, arr[:left], bat[:left],
                                      lut, tos, qos_t)
    np.testing.assert_array_equal(got_free, want_free)
    assert got_count == want_count
    assert 5 < got_count <= 5 + left


def test_fcfs_stream_op_updates_its_carries_in_place(ref):
    """``ops.fcfs_stream`` on the CPU: the plain version's result written
    into the carries it was given; two chunks chained equal one scan of
    both; the inputs are checked."""
    lut, tos, free, arr, bat = _chunk_inputs(ref, 8, 3, nq=300)
    t = torch.from_numpy
    prio = torch.arange(8, dtype=torch.float32)
    f = t(free.copy())[None, None]
    c = torch.zeros((1, 1), dtype=torch.int32)
    f_id, c_id = f.data_ptr(), c.data_ptr()
    for lo, hi in ((0, 120), (120, 300)):
        ops.fcfs_stream(t(arr[lo:hi].copy())[None], t(bat[lo:hi].copy())[None],
                        t(lut), t(tos)[None], prio, f, c, 0.0, 0.012)
    assert f.data_ptr() == f_id and c.data_ptr() == c_id
    want_free, want_count = _port_chunk(free, 0, 0.0, arr, bat, lut, tos,
                                        0.012)
    np.testing.assert_array_equal(f[0, 0].numpy(), want_free)
    assert int(c) == want_count
    with pytest.raises(TypeError, match="batches"):
        ops.fcfs_stream(t(arr)[None], t(bat).long()[None], t(lut),
                        t(tos)[None], prio, f, c, 0.0, 0.012)
    with pytest.raises(ValueError, match="count"):
        ops.fcfs_stream(t(arr)[None], t(bat)[None], t(lut), t(tos)[None],
                        prio, f, c[0], 0.0, 0.012)


# ------------------------------------- StreamingSimulator, on ref chunks
@pytest.mark.parametrize("dist", ["lognormal", "gaussian"])
@pytest.mark.parametrize("seed", [0, 7])
def test_stream_qos_matches_reference_and_monolithic(ref, dist, seed):
    """On the reference's chunks: the port's streamed rate equals the
    reference's, and both equal the monolithic lane on the realized
    trace, with a partial final chunk (1500 = 5 x 256 + 220)."""
    spec = _ref_spec(ref, seed=seed, batch_dist=dist)
    n = 1500
    rss, tss = _streams(ref, spec)
    rprof, rtypes = _toy(ref["inst"])
    mono = ref["sim"].PoolSimulator(rprof, rtypes, spec.realize(n),
                                    max_instances=MAX_INST)
    for cfg in [(1, 1), (2, 2), (0, 3), (3, 0)]:
        got, want = tss.qos(cfg, n), rss.qos(cfg, n)
        assert got == ref_result(want)
        assert got.rate == float(mono.qos(cfg).rates)
    assert tss.n_dispatches == 4 * math.ceil(n / 256)


def ref_result(r):
    return tsim.StreamResult(rate=r.rate, n_queries=r.n_queries,
                             rebases=r.rebases)


def test_stream_single_partial_chunk(ref):
    spec = _ref_spec(ref)
    rss, tss = _streams(ref, spec)
    assert tss.qos((2, 1), 100) == ref_result(rss.qos((2, 1), 100))
    assert tss.n_dispatches == 1


def test_stream_edge_cases_and_probe(ref):
    spec = _ref_spec(ref, chunk=64)
    _, tss = _streams(ref, spec)
    r0 = tss.qos((1, 1), 0)
    assert math.isnan(r0.rate) and r0.n_queries == 0 and r0.rebases == 0
    rz = tss.qos((0, 0), 50)
    assert rz.rate == 0.0 and rz.n_queries == 50
    assert tss.n_dispatches == 0
    with pytest.raises(ValueError, match="n_queries"):
        tss.qos((1, 1), -1)
    with pytest.raises(ValueError, match="config"):
        tss.qos((1, 1, 1), 10)
    seen = []
    tss.qos((1, 1), 200, probe=seen.append)
    assert seen == list(range(math.ceil(200 / 64)))


def test_stream_scaled_chaining(ref):
    spec = _ref_spec(ref, chunk=128).scaled(1.5).scaled(2.0)
    rss, tss = _streams(ref, spec)
    assert tss.qos((2, 2), 600) == ref_result(rss.qos((2, 2), 600))


def test_stream_rebases_past_the_monolithic_horizon(ref):
    """A sparse stream past the float32 envelope: the same rate and the
    same rebases as the reference's (at least one)."""
    spec = _ref_spec(ref, seed=3, rate=0.01, chunk=256)
    rss, tss = _streams(ref, spec)
    got = tss.qos((2, 0), 2048)
    assert got == ref_result(rss.qos((2, 0), 2048))
    assert got.rebases >= 1 and 0.9 < got.rate <= 1.0


def test_one_chunk_outrunning_the_envelope_raises(ref):
    spec = _ref_spec(ref, seed=3, rate=0.01, chunk=2048)
    _, tss = _streams(ref, spec)
    with pytest.raises(ValueError, match="outruns"):
        tss.qos((2, 0), 2048)


def test_stream_bucketed_specs(ref):
    """A bucketed spec streams through the bucket-blocked table, the
    reference's rates bit for bit, and equals the monolithic lane."""
    base = _ref_spec(ref, chunk=128)
    spec = ref["wl"].BucketedWorkloadSpec(
        base=base, rates=((60.0, 30.0), (20.0, 10.0)),
        input_scales=(0.7, 1.6), output_scales=(0.8, 1.5))
    rss, tss = _streams(ref, spec)
    rprof, rtypes = _toy(ref["inst"])
    mono = ref["sim"].PoolSimulator(rprof, rtypes, spec.realize(500),
                                    max_instances=MAX_INST)
    for cfg in [(1, 1), (2, 3)]:
        got = tss.qos(cfg, 500)
        assert got == ref_result(rss.qos(cfg, 500))
        assert got.rate == float(mono.qos(cfg).rates)


# ------------------------------------------- from the seed, port stream
def test_stream_from_the_seed_equals_the_ports_monolithic_lane():
    tprof, ttypes = _toy(tinst)
    for spec in (_port_spec(seed=5), _port_spec(seed=5).scaled(1.3)):
        ss = tsim.StreamingSimulator(tprof, ttypes, spec,
                                     max_instances=MAX_INST, device=CPU)
        mono = tsim.PoolSimulator(tprof, ttypes, spec.realize(700),
                                  max_instances=MAX_INST, device=CPU)
        for cfg in [(1, 1), (2, 0)]:
            assert ss.qos(cfg, 700).rate == float(mono.qos(cfg).rates)


def test_stream_mtwnd_anchor_from_the_seed():
    """mtwnd's Table 3 pool (2, 3, 3), 10,000 queries at 800 qps in chunks
    of 4096: 0.9821 with no rebase, in three launches of the stream
    flavour; the generation and launch times are accounted apart."""
    ss = tsim.StreamingSimulator(
        tinst.MODEL_PROFILES["mtwnd"],
        [tinst.AWS_INSTANCES[n] for n in tinst.PAPER_POOLS["mtwnd"]["diverse"]],
        tpool.paper_spec("mtwnd", seed=0), device=CPU)
    res = ss.qos((2, 3, 3), 10_000)
    assert res == tsim.StreamResult(rate=0.9821, n_queries=10_000, rebases=0)
    assert ss.n_dispatches == 3 and ss.gen_s > 0 and ss.scan_s > 0
