"""Port parity: the SSD scan's plain PyTorch version (what
``repro_torch.kernels.ops.ssd_scan`` runs on the CPU) against the JAX
reference's Pallas kernel in interpret mode (``repro.kernels.ops.ssd_scan``),
its sequential oracle (``repro.kernels.ref.ssd_scan_ref``) and its model's
chunked scan (``repro.models.ssm.ssd_chunked``); the port's own
``ssd_chunked`` and ``segsum`` against the reference's; and the wrapper's
refusals.

Inputs come from a numpy seed: x, b, c ~ N(0, 0.5^2), dt = softplus(N(0, 1)),
A_log = log(linspace(0.5, 4, H)); the shapes are those of
``tests/test_kernels.py`` plus a ragged L, L 1, G > 1 and strided views.
Tolerances, relative to max |want| (y grows with N, so an absolute gate
would be loose at small N and tight at large N):
* fp32, 1e-5 against the sequential oracles (the same recurrence, float32
  roundings in another order) and 2e-4 against the chunked forms (the
  in-chunk decays are differences of running sums: the reference's own
  chunked-vs-sequential test allows 2e-4);
* bf16, 2e-2: the Pallas kernel and the chunked form round the score
  matrix (and the chunked form the scores and states) to bf16, the plain
  version only x·dt and y; each of those roundings is 2^-9 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import check_inputs, ssd_scan_cuda  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SEQ_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CHUNKED_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# (b, slen, h, p, g, n, chunk): tests/test_kernels.py's shapes
KERNEL_SHAPES = [(2, 64, 4, 16, 1, 16, 16),
                 (1, 128, 2, 64, 1, 128, 32),
                 (2, 96, 4, 32, 2, 32, 32)]
EXTRA_SHAPES = {"ragged L": (2, 50, 4, 16, 1, 16, 16),
                "L 1": (2, 1, 4, 16, 1, 16, 16),
                "G 2, H 8": (1, 40, 8, 16, 2, 8, 8)}


def _inputs(seed, b, slen, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, slen, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, slen, h)))).astype(np.float32)
    a_log = np.log(np.linspace(0.5, 4.0, h)).astype(np.float32)
    bb = (rng.standard_normal((b, slen, g, n)) * 0.5).astype(np.float32)
    cc = (rng.standard_normal((b, slen, g, n)) * 0.5).astype(np.float32)
    return x, dt, a_log, bb, cc


def _torch(arrays, dtype):
    x, dt, a_log, b, c = (torch.from_numpy(a) for a in arrays)
    tdt = DTYPES[dtype][1]
    return x.to(tdt), dt, a_log, b.to(tdt), c.to(tdt)


def _jax(arrays, dtype):
    x, dt, a_log, b, c = (jnp.asarray(a) for a in arrays)
    jdt = DTYPES[dtype][0]
    return x.astype(jdt), dt, a_log, b.astype(jdt), c.astype(jdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    top = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * top, f"max |diff| {err} > {rel} x {top}"


def _ref_oracle(x, dt, a_log, b, c):
    """The reference's sequential ``ref.ssd_scan_ref`` fed the way its
    wrapper feeds the kernel (one chunk of the whole length)."""
    bsz, slen, h, p = x.shape
    rep = h // b.shape[2]
    xdt = x * dt[..., None].astype(x.dtype)
    da = dt * -jnp.exp(a_log)

    def arr(z):
        return jnp.moveaxis(z, 2, 1).reshape(bsz, h, 1, slen, *z.shape[3:])

    y, s = jref.ssd_scan_ref(arr(xdt), jnp.moveaxis(da, 2, 1).reshape(
        bsz, h, 1, slen), arr(jnp.repeat(b, rep, axis=2)),
        arr(jnp.repeat(c, rep, axis=2)))
    return jnp.moveaxis(y.reshape(bsz, h, slen, p), 1, 2), jnp.swapaxes(s, -1, -2)


_ALL = [pytest.param(s, id="x".join(map(str, s))) for s in KERNEL_SHAPES] + \
    [pytest.param(s, id=k.replace(" ", "")) for k, s in EXTRA_SHAPES.items()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _ALL)
def test_plain_version_matches_pallas_kernel(shape, dtype):
    b, slen, h, p, g, n, chunk = shape
    arrays = _inputs(1, b, slen, h, p, g, n)
    y, s = ops.ssd_scan(*_torch(arrays, dtype))
    y_want, s_want = jops.ssd_scan(*_jax(arrays, dtype), chunk=chunk,
                                   interpret=True)
    assert y.dtype == DTYPES[dtype][1] and s.dtype == torch.float32
    _close(y, y_want, CHUNKED_TOL[dtype])
    _close(s, s_want, CHUNKED_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _ALL)
def test_plain_version_matches_sequential_oracle(shape, dtype):
    b, slen, h, p, g, n, _ = shape
    arrays = _inputs(2, b, slen, h, p, g, n)
    y, s = ops.ssd_scan(*_torch(arrays, dtype))
    y_want, s_want = _ref_oracle(*_jax(arrays, dtype))
    _close(y, y_want, SEQ_TOL[dtype])
    _close(s, s_want, SEQ_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [pytest.param(s, id="x".join(map(str, s)))
                                   for s in KERNEL_SHAPES])
def test_chunked_matches_reference_and_plain_version(shape, dtype):
    """The model's plain path (``ssm.ssd_chunked``) against the reference's
    ``ssd_chunked`` and against the kernel's plain version."""
    b, slen, h, p, g, n, chunk = shape
    arrays = _inputs(3, b, slen, h, p, g, n)
    y, s = ssm.ssd_chunked(*_torch(arrays, dtype), chunk)
    y_want, s_want = jssm.ssd_chunked(*_jax(arrays, dtype), chunk)
    _close(y, y_want, CHUNKED_TOL[dtype])
    _close(s, s_want, CHUNKED_TOL[dtype])
    y_plain, s_plain = ops.ssd_scan(*_torch(arrays, dtype))
    _close(y, y_plain, CHUNKED_TOL[dtype])
    _close(s, s_plain, CHUNKED_TOL[dtype])


def test_sequential_reference_matches():
    arrays = _inputs(4, 2, 24, 4, 8, 2, 8)
    y, s = ssm.ssd_reference_sequential(*_torch(arrays, "float32"))
    y_want, s_want = jssm.ssd_reference_sequential(*_jax(arrays, "float32"))
    _close(y, y_want, SEQ_TOL["float32"])
    _close(s, s_want, SEQ_TOL["float32"])


def test_segsum_matches_reference():
    x = np.random.default_rng(5).standard_normal((3, 2, 7)).astype(np.float32)
    got = ssm.segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jssm.segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=1e-6, atol=1e-6)


def test_chunk_invariance():
    """One function, any chunk: the kernel's own chunk differs from the
    model's ``ssm_chunk`` by rounding only (the reference's
    ``test_ssm.py::test_chunk_invariance``)."""
    xs = _torch(_inputs(6, 2, 24, 4, 8, 2, 8), "float32")
    y1, s1 = ssm.ssd_chunked(*xs, 8)
    y2, s2 = ssm.ssd_chunked(*xs, 24)
    _close(y1, y2, CHUNKED_TOL["float32"])
    _close(s1, s2, CHUNKED_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_views_of_one_packed_tensor(dtype):
    """x, b and c as views into one conv output (B, L, H·P + 2·G·N), as the
    model passes them: the same result as contiguous copies."""
    bsz, slen, h, p, g, n = 2, 33, 4, 16, 1, 8
    rng = np.random.default_rng(7)
    packed = torch.from_numpy(
        (rng.standard_normal((bsz, slen, h * p + 2 * g * n)) * 0.5)
        .astype(np.float32)).to(DTYPES[dtype][1])
    x = packed[..., :h * p].reshape(bsz, slen, h, p)
    b = packed[..., h * p:h * p + g * n].reshape(bsz, slen, g, n)
    c = packed[..., h * p + g * n:].reshape(bsz, slen, g, n)
    assert not x.is_contiguous() and not b.is_contiguous()
    _, dt, a_log, _, _ = _torch(_inputs(7, bsz, slen, h, p, g, n), dtype)
    y, s = ops.ssd_scan(x, dt, a_log, b, c)
    y_c, s_c = ops.ssd_scan(x.contiguous(), dt, a_log, b.contiguous(),
                            c.contiguous())
    assert torch.equal(y, y_c) and torch.equal(s, s_c)
    arrays = tuple(t.float().numpy() for t in (x, dt, a_log, b, c))
    y_want, s_want = _ref_oracle(*_jax(arrays, dtype))
    _close(y, y_want, SEQ_TOL[dtype])
    _close(s, s_want, SEQ_TOL[dtype])


def _good():
    return _torch(_inputs(8, 1, 4, 4, 8, 2, 8), "float32")


def _bad(name):
    x, dt, a_log, b, c = _good()
    if name == "mixed types":
        return x.bfloat16(), dt, a_log, b, c
    if name == "half":
        return x.half(), dt, a_log, b.half(), c.half()
    if name == "dt not float32":
        return x, dt.bfloat16(), a_log, b, c
    if name == "a_log not float32":
        return x, dt, a_log.double(), b, c
    if name == "heads not a multiple of groups":
        return x, dt, a_log, b[:, :, :1].expand(1, 4, 3, 8), c[:, :, :1].expand(1, 4, 3, 8)
    if name == "b and c differ":
        return x, dt, a_log, b, c[..., :4]
    if name == "dt shape":
        return x, dt[:, :, :2], a_log, b, c
    if name == "L 0":
        return x[:, :0], dt[:, :0], a_log, b[:, :0], c[:, :0]
    if name == "N too large":
        big = torch.zeros(1, 4, 2, 300)
        return x, dt, a_log, big, big
    if name == "x last dim strided":
        return x[..., ::2], dt, a_log, b, c
    if name == "b last dim strided":
        return x, dt, a_log, b[..., ::2], c[..., ::2]
    if name == "3-d x":
        return x[0], dt, a_log, b, c
    if name == "other device":
        return x, dt.to("meta"), a_log, b, c
    raise KeyError(name)


@pytest.mark.parametrize("name,exc", [
    ("mixed types", TypeError), ("half", TypeError),
    ("dt not float32", TypeError), ("a_log not float32", TypeError),
    ("heads not a multiple of groups", ValueError),
    ("b and c differ", ValueError), ("dt shape", ValueError),
    ("L 0", ValueError), ("N too large", ValueError),
    ("x last dim strided", ValueError), ("b last dim strided", ValueError),
    ("3-d x", ValueError), ("other device", ValueError)])
def test_check_inputs_refuses(name, exc):
    with pytest.raises(exc, match="ssd_scan"):
        check_inputs(*_bad(name))
    with pytest.raises(exc, match="ssd_scan"):
        ops.ssd_scan(*_bad(name))


def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(*_good())
    ops.ssd_scan(*_good())
    assert ssd_scan_cuda.launches == before


def test_reference_interpret_kernel_is_what_the_oracle_is():
    """Guard on the reference itself: its interpret-mode kernel agrees with
    its model's chunked scan at the shapes used above, so the port's
    comparisons test the port."""
    arrays = _inputs(9, 2, 64, 4, 16, 1, 16)
    y_k, _ = jops.ssd_scan(*_jax(arrays, "float32"), chunk=16, interpret=True)
    y_c, _ = jssm.ssd_chunked(*_jax(arrays, "float32"), 16)
    _close(y_k, y_c, CHUNKED_TOL["float32"])
    assert jax.devices()[0].platform == "cpu"
