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


# ------------------------------------------- the bf16 tensor-core kernel


def _chip_gates():
    """The SSD gates of ``chip_smoke.py`` (the card's check of the kernel),
    read from the script itself so the two cannot drift apart."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SSD_F32_TOL, mod.SSD_BF16_TOL, mod.SSD_MEAN_SLACK


def _split(v):
    """fp32 v as bf16 hi + lo (hi = v rounded, lo = the rest rounded), the
    kernel's split of an fp32 operand into two tensor-core passes."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _tc_emulation(x, dt, a_log, b, c, chunk=64, drop_update=None):
    """The arithmetic of ``csrc/ssd_scan.cu``'s bf16 tensor-core kernel, chunk
    by chunk, in torch on the CPU: xdt = x · dt rounded to x's type (dt
    rounded first); cum = the fp64 running sum of the fp32 dt · A; S = C·Bᵀ
    from x's type, summed in fp32; M = S ∘ exp(fp32(cum_i - cum_j)) rounded
    to x's type; y = exp(cum) · (C · (state_hi + state_lo)) + M · xdt in
    fp32, rounded once; state = exp(cum_last) · state + Bᵀ · (xdt · decay)
    with xdt · decay split into hi + lo.  ``drop_update`` leaves one
    chunk's state update out (a fault the gate must catch)."""
    bsz, slen, h, p = x.shape
    a = -torch.exp(a_log.float())
    xdt = (x.float() * dt.to(x.dtype).float()[..., None]).to(x.dtype).float()
    da = dt.float() * a                                      # (B, L, H)
    bh = ssm.per_head(b, h, 2).float()                       # (B, L, H, N)
    ch = ssm.per_head(c, h, 2).float()
    state = torch.zeros((bsz, h, p, b.shape[3]), dtype=torch.float32)
    ys = []
    for k, t0 in enumerate(range(0, slen, chunk)):
        sl = slice(t0, min(t0 + chunk, slen))
        q = sl.stop - sl.start
        cum = torch.cumsum(da[:, sl].double(), dim=1)        # (B, q, H)
        last = cum[:, -1]                                    # (B, H)
        seg = (cum[:, :, None] - cum[:, None, :]).float()    # (B, i, j, H)
        tri = torch.ones(q, q, dtype=torch.bool).tril()[None, :, :, None]
        lmat = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
        s = torch.einsum("bihn,bjhn->bijh", ch[:, sl], bh[:, sl])
        m = (s * lmat).to(x.dtype).float()
        y_diag = torch.einsum("bijh,bjhp->bihp", m, xdt[:, sl])
        hi, lo = _split(state)
        y_off = (torch.einsum("bihn,bhpn->bihp", ch[:, sl], hi)
                 + torch.einsum("bihn,bhpn->bihp", ch[:, sl], lo))
        ys.append((y_off * torch.exp(cum.float())[..., None] + y_diag)
                  .to(x.dtype))
        if k == drop_update:
            continue
        dec = torch.exp((last[:, None] - cum).float())       # (B, q, H)
        w_hi, w_lo = _split(xdt[:, sl] * dec[..., None])
        state = (state * torch.exp(last.float())[..., None, None]
                 + torch.einsum("bihp,bihn->bhpn", w_hi, bh[:, sl])
                 + torch.einsum("bihp,bihn->bhpn", w_lo, bh[:, sl]))
    return torch.cat(ys, dim=1), state


def _gate_inputs(seed, b, slen, h, p, g, n, dtype):
    """Inputs as ``chip_smoke.py::_ssd_inputs`` draws them: x, b, c ~
    N(0, 0.5^2), dt = softplus(N(0, 1)), a_log = log(linspace(1, 16, H))."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy((rng.standard_normal((b, slen, h * p + 2 * g * n))
                            * 0.5).astype(np.float32)).to(DTYPES[dtype][1])
    x = xbc[..., :h * p].reshape(b, slen, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, slen, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, slen, g, n)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, slen, h)).astype(np.float32)))
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    return x, dt, a_log, bm, cm


def _chip_gate(got, want, exact):
    """``chip_smoke.py::_ssd_gate`` on the CPU: y within SSD_BF16_TOL and the
    state within SSD_F32_TOL of the plain version, relative to max |want|;
    y's max |diff| to the fp32 plain version within one bf16 step at the top
    of the plain bf16 version's own, its mean within SSD_MEAN_SLACK x
    mean |exact| of it.  Returns the failures."""
    f32_tol, bf16_tol, slack = _chip_gates()
    fails = []
    for part, g, w, tol in (("y", got[0], want[0], bf16_tol),
                            ("state", got[1], want[1], f32_tol)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g.float()).all()
        rel = ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
        if not rel <= tol:
            fails.append(f"{part} {rel} > {tol}")
    mine = (got[0].float() - exact).abs()
    plain = (want[0].float() - exact).abs()
    top = exact.abs().max().item()
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    for stat, sl in ((torch.max, step),
                     (torch.mean, slack * exact.abs().mean().item())):
        if not stat(mine).item() <= stat(plain).item() + sl:
            fails.append(f"{stat.__name__} |diff| to fp32 {stat(mine).item()}"
                         f" > {stat(plain).item()} + {sl}")
    return fails


TC_SHAPES = [pytest.param((2, 300, 4, 32, 1, 32), id="G1"),
             pytest.param((2, 300, 4, 32, 2, 32), id="G2")]


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_tensor_core_arithmetic_passes_the_chip_gate(shape):
    """The bf16 kernel's roundings (bf16 C·Bᵀ and M·xdt, M rounded, the
    fp32 operands split hi + lo) pass the bf16 gate the card applies."""
    x, dt, a_log, b, c = _gate_inputs(10, *shape, "bfloat16")
    got = _tc_emulation(x, dt, a_log, b, c)
    want = ops.ssd_scan(x, dt, a_log, b, c)
    exact = ops.ssd_scan(x.float(), dt, a_log, b.float(), c.float())[0]
    assert _chip_gate(got, want, exact) == []


def test_chip_gate_catches_a_dropped_state_update():
    """The same gate fails the emulation with one chunk's state update left
    out: it tells a right split from a wrong kernel."""
    x, dt, a_log, b, c = _gate_inputs(10, 2, 300, 4, 32, 1, 32, "bfloat16")
    got = _tc_emulation(x, dt, a_log, b, c, drop_update=1)
    want = ops.ssd_scan(x, dt, a_log, b, c)
    exact = ops.ssd_scan(x.float(), dt, a_log, b.float(), c.float())[0]
    assert _chip_gate(got, want, exact)


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_tensor_core_arithmetic_matches_pallas_kernel_fp32(shape):
    """The same chunked arithmetic (fp64 running sum, decays from fp64
    differences, hi + lo splits) on fp32 inputs against the reference's
    Pallas kernel in interpret mode (chunk 60)."""
    b, slen, h, p, g, n = shape
    arrays = _inputs(11, b, slen, h, p, g, n)
    y, s = _tc_emulation(*_torch(arrays, "float32"))
    y_want, s_want = jops.ssd_scan(*_jax(arrays, "float32"), chunk=60,
                                   interpret=True)
    _close(y, y_want, CHUNKED_TOL["float32"])
    _close(s, s_want, CHUNKED_TOL["float32"])


def _aligned(shape, dtype=torch.bfloat16):
    """A tensor of ``shape`` whose base address is 16-byte aligned."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=dtype)
    off = (-buf.data_ptr() % 16) // buf.element_size()
    return buf[off:off + n].view(shape)


class _Recorder:
    """Stands in for ``_build.function``: records the entry point asked
    for and returns a C function that reports success."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, symbol, argtypes, restype=None):
        def fn(*args):
            assert len(args) == len(argtypes)
            self.calls.append((name, symbol))
            return 0
        return fn


def _launch_args(dtype, p=16, n=16, x=None, b=None):
    bsz, slen, h, g = 1, 8, 4, 2
    x = _aligned((bsz, slen, h, p), dtype) if x is None else x
    b = _aligned((bsz, slen, g, n), dtype) if b is None else b
    return (x, torch.ones(bsz, slen, h), torch.zeros(h), b, b.clone(),
            torch.empty(x.shape, dtype=dtype),
            torch.empty(bsz, h, x.shape[3], b.shape[3]))


@pytest.mark.parametrize("dtype,symbol", [
    (torch.bfloat16, "ssd_scan_bf16"),
    (torch.float32, "ssd_scan_f32"),
])
def test_ssd_routes_by_dtype(monkeypatch, dtype, symbol):
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd_mod
    rec = _Recorder()
    monkeypatch.setattr(_build, "function", rec)
    monkeypatch.setattr(ssd_scan_cuda, "launches", 0)
    monkeypatch.setattr(ssd_scan_cuda, "launches_by_dtype",
                        {"bfloat16": 0, "float32": 0})
    ssd_mod._launch(*_launch_args(dtype), stream=0)
    assert rec.calls == [("ssd_scan", symbol)]
    assert ssd_scan_cuda.launches == 1
    assert ssd_scan_cuda.launches_by_dtype == {
        "bfloat16": int(dtype == torch.bfloat16),
        "float32": int(dtype == torch.float32)}


def _tc_case(name):
    if name == "P 12":
        return _launch_args(torch.bfloat16, p=12)
    if name == "N 20":
        return _launch_args(torch.bfloat16, n=20)
    if name == "x base":
        buf = _aligned((8 * 4 * 16 + 8,))
        return _launch_args(torch.bfloat16, x=buf[1:1 + 512].view(1, 8, 4, 16))
    if name == "b row stride":
        wide = _aligned((1, 8, 2, 20))
        return _launch_args(torch.bfloat16, n=16, b=wide[..., :16])
    if name == "ok packed":
        xbc = _aligned((1, 8, 4 * 16 + 2 * 2 * 16))
        x = xbc[..., :64].reshape(1, 8, 4, 16)
        return _launch_args(torch.bfloat16, x=x,
                            b=xbc[..., 64:96].reshape(1, 8, 2, 16))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["P 12", "N 20", "x base", "b row stride",
                                  "ok packed"])
def test_bf16_route_refuses_before_any_launch(monkeypatch, name):
    """A bf16 input the tensor-core kernel cannot take raises before the
    library is even asked for, and counts no launch; strided views of one
    packed conv output, as the model passes them, are taken."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd_mod
    rec = _Recorder()
    monkeypatch.setattr(_build, "function", rec)
    monkeypatch.setattr(ssd_scan_cuda, "launches", 0)
    args = _tc_case(name)
    if name.startswith("ok"):
        ssd_mod._launch(*args, stream=0)
        assert ssd_scan_cuda.launches == 1
        return
    with pytest.raises(ValueError, match="bf16 ssd_scan kernel"):
        ssd_mod._launch(*args, stream=0)
    assert rec.calls == [] and ssd_scan_cuda.launches == 0
    x, dt, a_log, b, c = args[:5]
    y, _ = ops.ssd_scan(x, dt, a_log, b, c)     # the CPU route takes it
    assert y.shape == x.shape and torch.isfinite(y.float()).all()


# ------------------------------------------ C-F2: padded, re-aligned inputs
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["P 50, N 20", "view offset by one"])
def test_padded_realigned_operands_keep_the_result(case, dtype):
    """What the bf16 wrapper hands the tensor-core kernel in place of an
    input it cannot read (ROADMAP C-F2): x zero-padded along P and b, c
    along N to the next multiple of 8, or a misaligned view copied to a
    fresh allocation (``tensor_core_view``).  The plain version on those
    operands, y and the final state sliced back, equals the plain version
    on the original inputs within float32 rounding (1e-6 x max |want|; the
    padded products are exact zeros, and y is cast to x's type once, so
    bf16 is held to the same gate)."""
    from repro_torch.kernels.flash_attention import padded, tensor_core_view
    from repro_torch.kernels.ssd_scan import check_tensor_core_inputs
    p, n = (50, 20) if case.startswith("P") else (16, 16)
    x, dt, a_log, b, c = _torch(_inputs(23, 2, 70, 4, p, 2, n), dtype)
    if case == "view offset by one":
        x = torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].view(x.shape)
        assert x.data_ptr() % 16 != 0
    xp = tensor_core_view(x, padded(p))
    bp, cp = (tensor_core_view(t, padded(n)) for t in (b, c))
    check_tensor_core_inputs(xp, bp, cp)
    for t, tp in ((x, xp), (b, bp), (c, cp)):
        assert torch.equal(tp[..., :t.shape[-1]], t)
        assert not tp[..., t.shape[-1]:].any()
    y, state = ops.ssd_scan(x, dt, a_log, b, c)
    yp, statep = ops.ssd_scan(xp, dt, a_log, bp, cp)
    assert not statep[:, :, p:].any() and not statep[..., n:].any()
    for got, want in ((yp[..., :p], y), (statep[:, :, :p, :n], state)):
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        assert rel <= 1e-6
