"""Port parity: threefry in torch (``repro_torch.prng``) against
``jax.random``, and the query streams built on it
(``repro_torch.serving.workload``) against ``repro.serving.workload``.

Tolerances, each measured on this host (jax 0.9.0, threefry
partitionable):
* keys, ``split``, ``fold_in``, bits and ``uniform``: bit for bit
  (integer arithmetic and the mantissa trick);
* ``exponential``: within 1 ulp (measured 1 ulp, in 7 % of the draws:
  the port rounds ``-log1p(-u)`` once from float64, XLA evaluates it in
  float32);
* ``normal``: |diff| <= 1e-5 x max(|z|, 2^-6) (measured 5.8e-6 over 2M
  draws: XLA's float32 ``erf_inv`` against float64);
* ``realize``: bucket indices bit for bit; batch sizes equal in all but
  at most 2 of 5000 queries per stream (measured 0 in all ten paper
  streams); arrivals within 4e-6 relative (measured 1.35e-6 at 5000
  queries: the gaps differ by the exponential's ulp and are summed in
  sequence, where XLA's cumulative sum associates otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.serving import pool as tpool  # noqa: E402
from repro_torch.serving import workload as twl  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 1, -7]
SHAPES = [(7,), (4096,), (3, 5)]
MODELS = ["mtwnd", "dien", "candle", "resnet50", "vgg19"]
N = 5000                       # two chunks of the default 4096
ARRIVAL_RTOL = 4e-6
BATCH_MISMATCH = 2
NORMAL_TOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.serving.workload`` and ``.pool`` modules
    (imported with the ``enable_x64`` alias their import needs on jax 0.9,
    as in ``tests/test_torch_engine.py``)."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import pool, workload
    return workload, pool


def _u32(x):
    return np.asarray(x).astype(np.int64)


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def test_partitionable_threefry_is_the_ported_variant():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_bit_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    for num in (2, 5):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _u32(jax.random.split(jk, num)))
    for data in (0, 3, 1000, 2 ** 32 - 1, 0x42C0DE):
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(),
                                      _u32(jax.random.fold_in(jk, data)))


def test_seed_out_of_int32_raises():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 31)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_exact(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        prng.random_bits(tk, shape).numpy(),
        _u32(jax.random.bits(jk, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (-2.5, 4.0)):
        got = prng.uniform(tk, shape, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_exponential_within_one_ulp(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    got = prng.exponential(tk, (20000,)).numpy()
    want = np.asarray(jax.random.exponential(jk, (20000,), jnp.float32))
    assert got.dtype == np.float32 and _ulps(got, want).max() <= 1
    assert (got == want).mean() > 0.9


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_stated_tolerance(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    got = prng.normal(tk, (20000,)).numpy().astype(np.float64)
    want = np.asarray(jax.random.normal(jk, (20000,),
                                        jnp.float32)).astype(np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 2 ** -6)
    assert err.max() <= NORMAL_TOL


def _specs(ref, model, dist):
    jspec = ref[1].paper_spec(model, seed=3, batch_dist=dist)
    return jspec, tpool.paper_spec(model, seed=3, batch_dist=dist)


def _close_streams(jw, tw):
    assert tw.arrivals.dtype == np.float64 and tw.batches.dtype == np.int64
    assert tw.rate_qps == jw.rate_qps and tw.n_queries == jw.n_queries
    np.testing.assert_allclose(tw.arrivals, jw.arrivals, rtol=ARRIVAL_RTOL,
                               atol=0)
    assert int((tw.batches != jw.batches).sum()) <= BATCH_MISMATCH


@pytest.mark.parametrize("dist", ["lognormal", "gaussian"])
@pytest.mark.parametrize("model", MODELS)
def test_paper_streams_match_reference(ref, model, dist):
    jspec, tspec = _specs(ref, model, dist)
    assert vars(tspec) == vars(jspec)
    _close_streams(jspec.realize(N), tspec.realize(N))


@pytest.mark.parametrize("mix", ["bucketed-small", "bucketed-large"])
def test_bucketed_streams_match_reference(ref, mix):
    jspec = ref[1].paper_bucketed_spec("mtwnd", mix, seed=2)
    tspec = tpool.paper_bucketed_spec("mtwnd", mix, seed=2)
    jw, tw = jspec.realize(N), tspec.realize(N)
    _close_streams(jw, tw)
    np.testing.assert_array_equal(tw.bucket_of, jw.bucket_of)
    assert tw.bucket_of.dtype == np.int64
    assert [vars(b) for b in tw.buckets] == [vars(b) for b in jw.buckets]
    base = tspec.base.realize(N)
    np.testing.assert_array_equal(tw.arrivals, base.arrivals)
    np.testing.assert_array_equal(tw.batches, base.batches)
    got = tspec.generate_chunk(1, 2.5)
    want = jspec.generate_chunk(1, 2.5)
    assert len(got) == 4 and got[3].dtype == torch.int32
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_scaled_stream_matches_reference(ref):
    jspec, tspec = _specs(ref, "dien", "lognormal")
    jw, tw = jspec.scaled(1.5).realize(N), tspec.scaled(1.5).realize(N)
    _close_streams(jw, tw)
    np.testing.assert_array_equal(tw.arrivals,
                                  tspec.realize(N).arrivals / 1.5)


def test_generate_chunk_matches_reference(ref):
    jspec = ref[0].WorkloadSpec(seed=4, rate_qps=300.0, chunk=512,
                                scale=2.0)
    tspec = twl.WorkloadSpec(seed=4, rate_qps=300.0, chunk=512, scale=2.0)
    for c, base in ((0, 0.0), (3, 1.25)):
        jarr, jloc, jbat = (np.asarray(x) for x in
                            jspec.generate_chunk(c, base))
        tarr, tloc, tbat = (x.numpy() for x in tspec.generate_chunk(c, base))
        assert tarr.dtype == tloc.dtype == np.float32
        assert tbat.dtype == np.int32
        np.testing.assert_allclose(tloc, jloc, rtol=ARRIVAL_RTOL)
        np.testing.assert_allclose(tarr, jarr, rtol=ARRIVAL_RTOL)
        assert int((tbat != jbat).sum()) <= BATCH_MISMATCH


def test_shorter_realisation_is_a_prefix():
    spec = tpool.paper_spec("candle", seed=9)
    long, short = spec.realize(N), spec.realize(1500)
    np.testing.assert_array_equal(short.arrivals, long.arrivals[:1500])
    np.testing.assert_array_equal(short.batches, long.batches[:1500])
    assert spec.realize(0).n_queries == 0


@pytest.mark.parametrize("fn", ["lognormal_batches", "gaussian_batches"])
def test_batch_helpers_match_reference(ref, fn):
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    want = np.asarray(getattr(ref[0], fn)(jk, N, max_batch=128))
    got = getattr(twl, fn)(tk, N, max_batch=128).numpy()
    assert got.dtype == np.int32 and int((got != want).sum()) \
        <= BATCH_MISMATCH


def test_generate_workload_is_the_spec_stream(ref):
    tw = twl.generate_workload(5, 1000, 400.0, batch_dist="gaussian")
    spec = twl.WorkloadSpec(seed=5, rate_qps=400.0, batch_dist="gaussian")
    np.testing.assert_array_equal(tw.arrivals, spec.realize(1000).arrivals)
    _close_streams(ref[0].generate_workload(5, 1000, 400.0,
                                            batch_dist="gaussian"), tw)


@pytest.mark.parametrize("kwargs", [
    dict(rates=((1.0, 2.0),)),
    dict(rates=((-1.0, 3.0), (1.0, 2.0))),
    dict(rates=((1.0, 1.0), (1.0, 2.0))),
    dict(input_scales=(0.0, 1.0)),
    dict(rates=((1.0,), (2.0,))),
])
def test_bucketed_spec_validation_matches(ref, kwargs):
    base = dict(rates=((1.0, 1.0), (0.5, 1.5)), input_scales=(1.0, 2.0),
                output_scales=(1.0, 2.0))
    for mod in (ref[0], twl):
        spec = mod.WorkloadSpec(seed=0, rate_qps=4.0)
        with pytest.raises(ValueError):
            mod.BucketedWorkloadSpec(base=spec, **{**base, **kwargs})
