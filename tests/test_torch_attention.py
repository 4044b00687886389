"""Port parity: flash and decode attention's plain PyTorch versions (what
``repro_torch.kernels.ops`` runs on the CPU) against the JAX reference's
Pallas kernels in interpret mode (``repro.kernels.ops``) and its jnp
oracles (``repro.kernels.ref``), plus the wrappers' refusals.

Inputs come from a numpy seed, ~N(0, 0.5^2), and go to both packages; the
shape sets are those of ``tests/test_kernels.py``.  Tolerances:
* against the Pallas kernels, those of ``tests/test_kernels.py``: 2e-3 in
  fp32, 2e-2 in bf16 (the kernels round unnormalised probabilities to bf16
  and divide at the end; the plain version normalises first);
* against the jnp oracles in fp32, 1e-5: the same algorithm, float32
  roundings in another order; in bf16, 2e-2 (the oracle rounds the
  scores to bf16 before the softmax, the port's plain version does not).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as decode_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MAX_SPLITS, MIN_TILES, TILE, decode_attention_cuda, split_plan)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check_tensor_core_inputs, flash_attention_cuda)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
KERNEL_TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
              "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ORACLE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
              "bfloat16": dict(rtol=2e-2, atol=2e-2)}
FLASH_SHAPES = [
    (1, 128, 4, 4, 64),      # MHA
    (2, 256, 8, 2, 64),      # GQA 4:1
    (1, 256, 4, 1, 128),     # MQA
    (2, 128, 4, 4, 80),      # head dim not a lane multiple
    (1, 384, 6, 6, 64),      # seq not a block multiple
]
DECODE_SHAPES = [
    (2, 8, 2, 64, 1024),
    (1, 4, 4, 128, 512),
    (4, 4, 1, 80, 768),      # MQA, head dim not a lane multiple
]


def _normal(rng, shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _collapse(x):
    """(B, S, H, D) → (B·H, S, D), the reference oracles' layout."""
    b, s, h, d = x.shape
    return jnp.moveaxis(x, 2, 1).reshape(b * h, s, d)


def _flash_inputs(b, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, s, h, d)), _normal(rng, (b, s, kh, d)),
            _normal(rng, (b, s, kh, d)))


def _decode_inputs(b, h, kh, d, t, seed):
    rng = np.random.default_rng(seed)
    pos = np.where(np.arange(t) < t - 100, np.arange(t), -1).astype(np.int32)
    return (_normal(rng, (b, 1, h, d)), _normal(rng, (b, t, kh, d)),
            _normal(rng, (b, t, kh, d)), pos)


# ---------------------------------------------------------------- flash


@pytest.mark.parametrize("b,s,h,kh,d", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_pallas_interpret(b, s, h, kh, d, dtype):
    (jq, jk, jv), (q, k, v) = _both(_flash_inputs(b, s, h, kh, d, 0), dtype)
    want = jops.flash_attention(jq, jk, jv, block_q=128, block_k=128,
                                interpret=True)
    got = ops.flash_attention(q, k, v)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, s, h, d)
    np.testing.assert_allclose(_f32(got), _f32(want), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("b,s,h,kh,d", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_reference_oracle(b, s, h, kh, d, dtype):
    (jq, jk, jv), (q, k, v) = _both(_flash_inputs(b, s, h, kh, d, 1), dtype)
    want = jref.flash_attention_ref(_collapse(jq), _collapse(jk),
                                    _collapse(jv))
    want = jnp.moveaxis(want.reshape(b, h, s, d), 1, 2)
    np.testing.assert_allclose(_f32(ops.flash_attention(q, k, v)),
                               _f32(want), **ORACLE_TOL[dtype])


@pytest.mark.parametrize("window", [32, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_sliding_window(window, causal):
    b, s, h, d = 1, 256, 2, 64
    (jq, jk, jv), (q, k, v) = _both(_flash_inputs(b, s, h, h, d, 2),
                                    "float32")
    if causal:
        want = jops.flash_attention(jq, jk, jv, window=window, block_q=64,
                                    block_k=64, interpret=True)
    else:   # the Pallas wrapper only windows causal calls
        want = jref.flash_attention_ref(_collapse(jq), _collapse(jk),
                                        _collapse(jv), causal=False,
                                        window=window)
        want = jnp.moveaxis(want.reshape(b, h, s, d), 1, 2)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **KERNEL_TOL["float32"])


def test_flash_scale_and_strided_views():
    """An explicit scale, and q/k/v as strided views of one packed
    projection, give what contiguous copies give."""
    b, s, h, kh, d = 2, 96, 4, 2, 32
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(_normal(rng, (b, s, h + 2 * kh, d)))
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    got = ops.flash_attention(q, k, v, scale=0.3)
    want = jref.flash_attention_ref(*(_collapse(jnp.asarray(x.contiguous()
                                                             .numpy()))
                                      for x in (q, k, v)), scale=0.3)
    want = jnp.moveaxis(want.reshape(b, h, s, d), 1, 2)
    np.testing.assert_allclose(_f32(got), _f32(want), **ORACLE_TOL["float32"])


# --------------------------------------------------------------- decode


@pytest.mark.parametrize("b,h,kh,d,t", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_pallas_interpret(b, h, kh, d, t, dtype):
    q, k, v, pos = _decode_inputs(b, h, kh, d, t, 4)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(pos), block_k=256,
                                 interpret=True)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(pos))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, 1, h, d)
    np.testing.assert_allclose(_f32(got), _f32(want), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("b,h,kh,d,t", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_reference_oracle(b, h, kh, d, t, dtype):
    q, k, v, pos = _decode_inputs(b, h, kh, d, t, 5)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    g = h // kh
    want = jref.decode_attention_ref(jq.reshape(b * kh, g, d), _collapse(jk),
                                     _collapse(jv), jnp.asarray(pos))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(pos))
    np.testing.assert_allclose(_f32(got), _f32(want.reshape(b, 1, h, d)),
                               **ORACLE_TOL[dtype])


@pytest.mark.parametrize("empty", ["front", "holes", "all"])
def test_decode_ring_with_empty_slots(empty):
    """Empty slots anywhere in the ring weigh nothing; a ring with no valid
    slot averages v, as the reference's oracle does."""
    b, h, kh, d, t = 2, 8, 2, 64, 512
    q, k, v, _ = _decode_inputs(b, h, kh, d, t, 6)
    slots = np.arange(t)
    pos = {"front": np.where(slots < 200, -1, slots),
           "holes": np.where(slots % 3 == 0, -1, slots),
           "all": np.full(t, -1)}[empty].astype(np.int32)
    want = jref.decode_attention_ref(
        jnp.asarray(q).reshape(b * kh, h // kh, d), _collapse(jnp.asarray(k)),
        _collapse(jnp.asarray(v)), jnp.asarray(pos))
    got = ops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v, pos)))
    np.testing.assert_allclose(_f32(got), _f32(want.reshape(b, 1, h, d)),
                               **ORACLE_TOL["float32"])


@pytest.mark.parametrize("n_rows,t,n_sms,want", [
    (8, 2048, 132, (256, 8)),       # the qwen2.5-3b decode step: B 4, KH 2
    (8, 1999, 132, (256, 8)),
    (128, 2096, 132, (2112, 1)),    # the zamba2-2.7b decode step: B 4, KH 32
    (512, 2048, 132, (2048, 1)),    # enough rows: one block each
    (1, 100, 132, (128, 1)),        # 2 tiles: too few to split
    (2, 64 * 1000 + 1, 132, (64 * 16, 63)),
    (1, 64 * 1000, 132, (64 * 8, 125)),    # at most 128 splits
])
def test_split_plan_covers_the_cache(n_rows, t, n_sms, want):
    span, n_splits = split_plan(n_rows, t, n_sms)
    assert (span, n_splits) == want
    assert span % 64 == 0 and (n_splits - 1) * span < t <= n_splits * span


@pytest.mark.parametrize("n_rows,t", [
    (8, 2048), (8, 1999), (128, 2096),      # qwen2.5-3b, zamba2-2.7b steps
    (8, 1), (8, 63), (8, 64), (8, 65),
    (1, 4096), (4, 64 * 33 + 1), (2, 64 * 1000 + 1),
])
def test_split_plan_streams_every_slot_once(n_rows, t):
    """The splits tile [0, T) exactly once, every split streams at least
    MIN_TILES tiles (or all of T's tiles when T has fewer), and the grid is
    at most one wave of 132 SMs (one block a row when the rows fill it)."""
    span, n_splits = split_plan(n_rows, t, 132)
    runs = [(i * span, min(t, (i + 1) * span)) for i in range(n_splits)]
    covered = np.zeros(t, dtype=np.int64)
    for lo, hi in runs:
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    n_tiles = -(-t // TILE)
    for lo, hi in runs:
        assert -(-(hi - lo) // TILE) >= min(MIN_TILES, n_tiles)
    assert n_splits <= MAX_SPLITS
    assert n_splits == 1 or n_rows * n_splits <= 132


def _aligned(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


def _offset(shape, dtype=torch.bfloat16):
    """A tensor of ``shape`` whose base lies one element past an aligned
    address."""
    return torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("case", ["d 12", "base", "stride", "head stride",
                                  "pos base", "ok", "ok packed d 80"])
def test_tensor_core_route_refuses_unaligned_inputs(case):
    """The bf16 CUDA route's own refusals, checked before a launch: a head
    dim that is not a multiple of 8, a base address (of q, k, v or pos) or
    a stride that is not 16-byte aligned.  The CPU route keeps taking
    them."""
    b, s, h, kh, d = 1, 16, 4, 2, 16
    q, k, v = _aligned((b, s, h, d)), _aligned((b, s, kh, d)), \
        _aligned((b, s, kh, d))
    if case == "d 12":
        d = 12
        q, k, v = _aligned((b, s, h, d)), _aligned((b, s, kh, d)), \
            _aligned((b, s, kh, d))
    elif case == "base":
        k = _offset((b, s, kh, d))
    elif case == "stride":         # rows of 20 values: a 40-byte stride
        k = _aligned((b, s, kh, d + 4))[..., :d]
        v = _aligned((b, s, kh, d + 4))[..., :d]
    elif case == "head stride":    # heads 20 values apart
        q = _aligned((b, s, h, d + 4))[..., :d]
    elif case == "ok packed d 80":
        qkv = _aligned((b, s, h + 2 * kh, 80))
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    pos = torch.arange(k.shape[1], dtype=torch.int32)
    if case == "pos base":
        pos = torch.arange(-1, k.shape[1], dtype=torch.int32)[1:]
    if case.startswith("ok"):
        check_tensor_core_inputs(q, k, v, pos)
    else:
        with pytest.raises(ValueError, match="bf16 attention kernel"):
            check_tensor_core_inputs(q, k, v, pos)
    got = ops.flash_attention(q, k, v)           # the CPU route takes it
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    got = ops.decode_attention(q[:, :1], k, v, pos)
    assert got.shape == q[:, :1].shape


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


@pytest.mark.parametrize("dtype,symbol", [
    (torch.bfloat16, "flash_attention_bf16"),
    (torch.float32, "flash_attention_f32"),
])
def test_flash_routes_by_dtype(monkeypatch, dtype, symbol):
    rec = _Recorder()
    monkeypatch.setattr(_build, "function", rec)
    monkeypatch.setattr(flash_attention_cuda, "launches", 0)
    monkeypatch.setattr(flash_attention_cuda, "launches_by_dtype",
                        {"bfloat16": 0, "float32": 0})
    q, k, v = (_aligned(sh, dtype) for sh in ((2, 8, 4, 16), (2, 8, 2, 16),
                                               (2, 8, 2, 16)))
    flash_mod._launch(q, k, v, torch.empty_like(q), causal=True, window=0,
                      scale=0.25, stream=0)
    assert rec.calls == [("flash_attention", symbol)]
    assert flash_attention_cuda.launches == 1
    assert flash_attention_cuda.launches_by_dtype == {
        "bfloat16": int(dtype == torch.bfloat16),
        "float32": int(dtype == torch.float32)}


@pytest.mark.parametrize("dtype,symbol", [
    (torch.bfloat16, "decode_attention_bf16"),
    (torch.float32, "decode_attention_f32"),
])
def test_decode_routes_by_dtype(monkeypatch, dtype, symbol):
    rec = _Recorder()
    monkeypatch.setattr(_build, "function", rec)
    monkeypatch.setattr(decode_attention_cuda, "launches", 0)
    monkeypatch.setattr(decode_attention_cuda, "launches_by_dtype",
                        {"bfloat16": 0, "float32": 0})
    b, t, kh, g, d = 2, 300, 2, 8, 16
    q = _aligned((b, 1, kh * g, d), dtype)
    k, v = _aligned((b, t, kh, d), dtype), _aligned((b, t, kh, d), dtype)
    span, n_splits = split_plan(b * kh, t, 132)
    counters = torch.zeros(8, dtype=torch.int32)
    decode_mod._launch(q, k, v, torch.arange(t, dtype=torch.int32),
                       torch.empty_like(q),
                       torch.empty(b * kh * n_splits * g * (d + 2)),
                       counters, span=span, n_splits=n_splits, scale=0.25,
                       stream=0)
    assert rec.calls == [("decode_attention", symbol)]
    assert decode_attention_cuda.launches == 1
    assert decode_attention_cuda.launches_by_dtype == {
        "bfloat16": int(dtype == torch.bfloat16),
        "float32": int(dtype == torch.float32)}


def test_bf16_route_refuses_before_any_launch(monkeypatch):
    """A bf16 input the tensor-core kernel cannot take raises before the
    library is even asked for, and counts no launch."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "function", rec)
    monkeypatch.setattr(flash_attention_cuda, "launches", 0)
    monkeypatch.setattr(decode_attention_cuda, "launches", 0)
    q, k, v = _aligned((1, 8, 4, 12)), _aligned((1, 8, 2, 12)), \
        _aligned((1, 8, 2, 12))
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_mod._launch(q, k, v, torch.empty_like(q), causal=True,
                          window=0, scale=0.25, stream=0)
    with pytest.raises(ValueError, match="multiple of 8"):
        decode_mod._launch(q[:, :1], k, v, torch.arange(8, dtype=torch.int32),
                           torch.empty_like(q[:, :1]), torch.empty(64),
                           torch.zeros(8, dtype=torch.int32), span=64,
                           n_splits=1, scale=0.25, stream=0)
    assert rec.calls == []
    assert flash_attention_cuda.launches == 0
    assert decode_attention_cuda.launches == 0


# ------------------------------------------------------------- refusals


def _flash_args(**over):
    b, s, h, kh, d = 1, 16, 4, 2, 8
    args = dict(q=torch.zeros(b, s, h, d), k=torch.zeros(b, s, kh, d),
                v=torch.zeros(b, s, kh, d))
    args.update(over)
    return args


def _decode_args(**over):
    b, h, kh, d, t = 1, 4, 2, 8, 16
    args = dict(q=torch.zeros(b, 1, h, d), k=torch.zeros(b, t, kh, d),
                v=torch.zeros(b, t, kh, d),
                pos=torch.arange(t, dtype=torch.int32))
    args.update(over)
    return args


@pytest.mark.parametrize("over,kw,err", [
    (dict(q=torch.zeros(1, 16, 4, 8, dtype=torch.float16),
          k=torch.zeros(1, 16, 2, 8, dtype=torch.float16),
          v=torch.zeros(1, 16, 2, 8, dtype=torch.float16)), {}, TypeError),
    (dict(k=torch.zeros(1, 16, 2, 8, dtype=torch.bfloat16)), {}, TypeError),
    (dict(q=torch.zeros(16, 4, 8)), {}, ValueError),
    (dict(k=torch.zeros(1, 16, 3, 8), v=torch.zeros(1, 16, 3, 8)), {},
     ValueError),
    (dict(q=torch.zeros(1, 16, 4, 160), k=torch.zeros(1, 16, 2, 160),
          v=torch.zeros(1, 16, 2, 160)), {}, ValueError),
    (dict(q=torch.zeros(1, 16, 8, 4).transpose(2, 3)), {}, ValueError),
    (dict(k=torch.zeros(1, 16, 2, 8, device="meta")), {}, ValueError),
    (dict(k=torch.zeros(1, 4, 2, 8), v=torch.zeros(1, 4, 2, 8)),
     dict(window=4), ValueError),
    ({}, dict(window=-1), ValueError),
])
def test_flash_rejects(over, kw, err):
    with pytest.raises(err):
        ops.flash_attention(**_flash_args(**over), **kw)


@pytest.mark.parametrize("over,err", [
    (dict(pos=torch.arange(16)), TypeError),
    (dict(pos=torch.arange(8, dtype=torch.int32)), ValueError),
    (dict(q=torch.zeros(1, 2, 4, 8)), ValueError),
    (dict(v=torch.zeros(1, 16, 2, 8, dtype=torch.bfloat16)), TypeError),
    (dict(q=torch.zeros(1, 1, 66, 8)), ValueError),   # 33 heads per KV head
    (dict(k=torch.zeros(1, 16, 8, 2).transpose(2, 3)), ValueError),
    (dict(pos=torch.arange(16, dtype=torch.int32, device="meta")),
     ValueError),
])
def test_decode_rejects(over, err):
    with pytest.raises(err):
        ops.decode_attention(**_decode_args(**over))


def test_non_cuda_devices_are_refused():
    meta = {n: x.to("meta") for n, x in _flash_args().items()}
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        ops.flash_attention(**meta)
    meta = {n: x.to("meta") for n, x in _decode_args().items()}
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        ops.decode_attention(**meta)


def test_cuda_entries_raise_on_cpu_tensors():
    """The CUDA entries refuse CPU tensors instead of computing them."""
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention_cuda(**_flash_args(), causal=True, window=0,
                             scale=1.0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        decode_attention_cuda(**_decode_args(), scale=1.0)
    assert flash_attention_cuda.launches == 0
    assert decode_attention_cuda.launches == 0


# ------------------------------------------ C-F2: padded, re-aligned inputs
def _rel_diff(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["D 36", "D 100", "view offset by one"])
def test_padded_realigned_operands_keep_the_result(case, dtype):
    """What the bf16 wrappers hand the tensor-core kernels in place of an
    input they cannot read (ROADMAP C-F2): q, k and v zero-padded along D
    to the next multiple of 8, or a misaligned view copied to a fresh
    allocation (``tensor_core_view``).  The plain versions on those
    operands, the output sliced back to D and the scale that of the
    original D, equal the plain versions on the original inputs within
    float32 rounding (fp32: 1e-6 x max |out|; bf16, whose probabilities
    are rounded to bf16 after float32 scores, one bf16 step: 2^-8)."""
    rng = np.random.default_rng(17)
    tdt = DTYPES[dtype][1]
    d = {"D 36": 36, "D 100": 100, "view offset by one": 64}[case]
    b, s, t, h, kh = 2, 96, 160, 8, 2
    q, k, v = (torch.from_numpy(_normal(rng, shape)).to(tdt)
               for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    pos = torch.arange(t, dtype=torch.int32)
    pos[-7:] = -1
    if case == "view offset by one":
        k = torch.cat([k.reshape(-1)[:1], k.reshape(-1)]).reshape(-1)[1:] \
            .view(k.shape)
        pos = torch.cat([pos[:1], pos])[1:]
        assert k.data_ptr() % 16 != 0 and pos.data_ptr() % 16 != 0
    width = flash_mod.padded(d)
    qp, kp, vp = (flash_mod.tensor_core_view(x, width) for x in (q, k, v))
    posp = flash_mod.tensor_core_view(pos)
    for x, xp in ((q, qp), (k, kp), (v, vp), (pos, posp)):
        assert xp.data_ptr() % 16 == 0 and xp.shape[-1] % 8 == 0 \
            if xp.dtype != torch.int32 else xp.data_ptr() % 16 == 0
        assert torch.equal(xp[..., :x.shape[-1]], x)
        assert not xp[..., x.shape[-1]:].any()
    check_tensor_core_inputs(qp, kp, vp, posp)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    scale = d ** -0.5
    want = ops.flash_attention(q, k, v, window=48, scale=scale)
    got = ops.flash_attention(qp, kp, vp, window=48, scale=scale)[..., :d]
    assert _rel_diff(got, want) <= tol
    want = ops.decode_attention(q[:, :1], k, v, pos, scale=scale)
    got = ops.decode_attention(qp[:, :1], kp, vp, posp, scale=scale)[..., :d]
    assert _rel_diff(got, want) <= tol
    assert all(flash_mod.tensor_core_view(x) is x for x in (qp, kp, vp))
