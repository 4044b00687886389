"""Port parity: the embedding bag's plain PyTorch version against the JAX
reference (``repro.kernels.ref.embedding_bag_ref``) and the Pallas kernel
in interpret mode, for one table and for T stacked tables pooled in one
call (against the reference's kernel run once per table), plus the
wrapper's refusals.

Inputs come from a numpy seed and go to both packages.  Tolerances:
* unweighted float32 is bit-exact against the Pallas kernel: both add the
  rows in order from zero in float32;
* against ``embedding_bag_ref`` (XLA's reduction order) and for weighted
  sums, rtol = atol = 1e-6: a few float32 roundings of sums of <= 16 rows;
* bf16 within 2e-2: the reference adds in bf16, the port in float32 and
  rounds once.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag_cuda  # noqa: E402
from repro_torch.kernels.ref import embedding_bag_ref  # noqa: E402

SHAPES = [(4, 8, 64, 32), (8, 4, 128, 64), (2, 16, 32, 80)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(n_bags, bag, v, d, seed, weighted=False):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((v, d)) * 0.5).astype(np.float32)
    idx = rng.integers(0, v, (n_bags, bag)).astype(np.int32)
    w = rng.uniform(size=(n_bags, bag)).astype(np.float32) if weighted else None
    return idx, table, w


def _both(idx, table, w, dtype):
    jdt, tdt = DTYPES[dtype]
    jargs = (jnp.asarray(idx), jnp.asarray(table).astype(jdt),
             None if w is None else jnp.asarray(w))
    targs = (torch.from_numpy(idx), torch.from_numpy(table).to(tdt),
             None if w is None else torch.from_numpy(w))
    return jargs, targs


def _f32(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("n_bags,bag,v,d", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_interpret(n_bags, bag, v, d, dtype):
    idx, table, _ = _inputs(n_bags, bag, v, d, seed=7)
    jargs, targs = _both(idx, table, None, dtype)
    want = jops.embedding_bag(*jargs, interpret=True)
    got = ops.embedding_bag(*targs)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (n_bags, d)
    if dtype == "float32":
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


@pytest.mark.parametrize("n_bags,bag,v,d", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_reference_oracle(n_bags, bag, v, d, dtype):
    idx, table, _ = _inputs(n_bags, bag, v, d, seed=11)
    jargs, targs = _both(idx, table, None, dtype)
    want = jref.embedding_bag_ref(*jargs)
    got = ops.embedding_bag(*targs)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_weighted_matches_reference(dtype):
    idx, table, w = _inputs(4, 8, 64, 32, seed=8, weighted=True)
    jargs, targs = _both(idx, table, w, dtype)
    got = _f32(ops.embedding_bag(*targs))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(
        got, _f32(jops.embedding_bag(*jargs, interpret=True)), **tol)
    np.testing.assert_allclose(got, _f32(jref.embedding_bag_ref(*jargs)),
                               **tol)


def test_repeated_indices_count_again():
    """Multi-hot bags repeat rows; the sum counts multiplicity, exactly."""
    table = np.eye(8, 16, dtype=np.float32)
    idx = np.array([[3, 3, 3, 1], [0, 0, 0, 0]], dtype=np.int32)
    got = ops.embedding_bag(torch.from_numpy(idx), torch.from_numpy(table))
    want = jops.embedding_bag(jnp.asarray(idx), jnp.asarray(table),
                              interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[0], 3 * table[3] + table[1])
    np.testing.assert_array_equal(got.numpy()[1], 4 * table[0])


def _refusal_cases():
    idx = torch.zeros(4, 8, dtype=torch.int32)
    table = torch.zeros(64, 32)
    w = torch.ones(4, 8)
    return {
        "int64 indices": ((idx.long(), table, None), TypeError),
        "float16 table": ((idx, table.half(), None), TypeError),
        "float64 weights": ((idx, table, w.double()), TypeError),
        "weights shape": ((idx, table, w[:, :4].contiguous()), ValueError),
        "1-d indices": ((idx.reshape(-1), table, None), ValueError),
        "non-contiguous indices": ((torch.zeros(8, 4, dtype=torch.int32).T,
                                    table, None), ValueError),
        "non-contiguous table": ((idx, torch.zeros(32, 64).T, None),
                                 ValueError),
        "device mismatch": ((idx.to("meta"), table, None), ValueError),
        "4-d tables": ((idx[:, None, None], torch.zeros(1, 2, 64, 32), None),
                       ValueError),
        "stacked tables, 2-d indices": ((idx, torch.zeros(3, 64, 32), None),
                                        ValueError),
        "one table, 3-d indices": ((idx[:, None], table, None), ValueError),
        "mismatched T": ((torch.zeros(4, 2, 8, dtype=torch.int32),
                          torch.zeros(3, 64, 32), None), ValueError),
        "no tables": ((torch.zeros(4, 0, 8, dtype=torch.int32),
                       torch.zeros(0, 64, 32), None), ValueError),
        "stacked weights shape": ((torch.zeros(4, 3, 8, dtype=torch.int32),
                                   torch.zeros(3, 64, 32), w[:, None]),
                                  ValueError),
        "non-contiguous stack": ((torch.zeros(4, 3, 8, dtype=torch.int32),
                                  torch.zeros(64, 3, 32).transpose(0, 1),
                                  None), ValueError),
        "non-contiguous stacked indices": (
            (torch.zeros(4, 8, 3, dtype=torch.int32).transpose(1, 2),
             torch.zeros(3, 64, 32), None), ValueError),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_wrapper_refuses(case):
    args, exc = _refusal_cases()[case]
    with pytest.raises(exc):
        ops.embedding_bag(*args)


def test_cuda_launcher_refuses_cpu_tensors():
    idx = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        embedding_bag_cuda(idx, torch.zeros(8, 4))


def test_cuda_launcher_refuses_cpu_stacked_tables():
    idx = torch.zeros(2, 3, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        embedding_bag_cuda(idx, torch.zeros(3, 8, 4))


def test_cpu_path_never_counts_a_launch():
    before = embedding_bag_cuda.launches
    idx, table, w = _inputs(4, 8, 64, 32, seed=3, weighted=True)
    ops.embedding_bag(torch.from_numpy(idx), torch.from_numpy(table))
    ops.embedding_bag(torch.from_numpy(idx), torch.from_numpy(table),
                      torch.from_numpy(w))
    idx3, tables, w3 = _stacked(4, 3, 8, 64, 32, seed=3, weighted=True)
    ops.embedding_bag(torch.from_numpy(idx3), torch.from_numpy(tables),
                      torch.from_numpy(w3))
    assert embedding_bag_cuda.launches == before == 0


def _stacked(n_bags, n_tables, bag, v, d, seed, weighted=False):
    """T tables (T, V, D) and indices (n_bags, T, bag) in MT-WND's layout."""
    rng = np.random.default_rng(seed)
    tables = (rng.standard_normal((n_tables, v, d)) * 0.5).astype(np.float32)
    idx = rng.integers(0, v, (n_bags, n_tables, bag)).astype(np.int32)
    w = (rng.uniform(size=(n_bags, n_tables, bag)).astype(np.float32)
         if weighted else None)
    return idx, tables, w


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n_tables", [1, 3, 8])
def test_stacked_matches_pallas_per_table(n_tables, weighted, dtype):
    """T stacked tables in one call against the reference's Pallas kernel
    (interpret mode) run once per table, its outputs side by side: bit for
    bit unweighted in float32, within F32_TOL weighted (as
    ``test_weighted_matches_reference``), bf16 within BF16_TOL."""
    idx, tables, w = _stacked(6, n_tables, 5, 48, 24, seed=20 + n_tables,
                              weighted=weighted)
    jdt, tdt = DTYPES[dtype]
    want = np.concatenate([_f32(jops.embedding_bag(
        jnp.asarray(idx[:, t]), jnp.asarray(tables[t]).astype(jdt),
        None if w is None else jnp.asarray(w[:, t]), interpret=True))
        for t in range(n_tables)], axis=1)
    got = ops.embedding_bag(torch.from_numpy(idx),
                            torch.from_numpy(tables).to(tdt),
                            None if w is None else torch.from_numpy(w))
    assert got.dtype == tdt and got.shape == (6, n_tables * 24)
    if dtype == "float32" and not weighted:
        np.testing.assert_array_equal(_f32(got), want)
    else:
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        np.testing.assert_allclose(_f32(got), want, **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stacked_equals_single_tables_bit_for_bit(dtype):
    """The stacked plain version is the single-table one side by side:
    table t's slab of the output is exactly its own call."""
    idx, tables, w = _stacked(5, 4, 6, 40, 16, seed=9, weighted=True)
    tdt = DTYPES[dtype][1]
    tt = torch.from_numpy(tables).to(tdt)
    for weights in (None, torch.from_numpy(w)):
        got = embedding_bag_ref(torch.from_numpy(idx), tt, weights)
        for t in range(4):
            one = embedding_bag_ref(
                torch.from_numpy(idx[:, t]).contiguous(), tt[t],
                None if weights is None else weights[:, t].contiguous())
            assert torch.equal(got[:, 16 * t:16 * (t + 1)], one)


def test_plain_adds_in_order_from_zero():
    """The plain version's order is the kernel's: an explicit float32 loop
    over the bag, bit for bit (this is what the CUDA kernel matches)."""
    idx, table, w = _inputs(8, 5, 40, 24, seed=5, weighted=True)
    t = torch.from_numpy(table)
    for weights in (None, torch.from_numpy(w)):
        got = embedding_bag_ref(torch.from_numpy(idx), t, weights)
        acc = np.zeros((8, 24), dtype=np.float32)
        for j in range(5):
            row = table[idx[:, j]]
            acc = acc + (row if weights is None else row * w[:, j, None])
        np.testing.assert_array_equal(got.numpy(), acc)


def _out_of_range(n_bags, n_tables, bag, v, seed):
    """Indices drawn from [-2V, 2V) with the int32 extremes, -1 and V among
    them: below zero, at and above V, and in range."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-2 * v, 2 * v, (n_bags, n_tables, bag)).astype(np.int32)
    idx[0, :, :4] = [-2 ** 31, 2 ** 31 - 1, -1, v]
    return idx


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("weighted", [False, True])
def test_out_of_range_indices_match_reference(weighted, dtype):
    """An index outside [0, V) as the reference takes it (a negative one
    wraps once, then all are clamped to [0, V - 1]): the plain version
    against ``repro.kernels.ref.embedding_bag_ref`` and the Pallas kernel
    in interpret mode, for one table (bit for bit against the Pallas
    kernel unweighted in float32) and for stacked tables, per table."""
    n_tables, v, d = 3, 12, 8
    idx = _out_of_range(6, n_tables, 5, v, seed=31)
    rng = np.random.default_rng(32)
    tables = (rng.standard_normal((n_tables, v, d)) * 0.5).astype(np.float32)
    w = (rng.uniform(size=idx.shape).astype(np.float32) if weighted
         else None)
    jdt, tdt = DTYPES[dtype]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    per_table = []
    for t in range(n_tables):
        ji = jnp.asarray(idx[:, t])
        jt = jnp.asarray(tables[t]).astype(jdt)
        jw = None if w is None else jnp.asarray(w[:, t])
        pallas = _f32(jops.embedding_bag(ji, jt, jw, interpret=True))
        got = _f32(ops.embedding_bag(
            torch.from_numpy(idx[:, t].copy()),
            torch.from_numpy(tables[t]).to(tdt),
            None if w is None else torch.from_numpy(w[:, t].copy())))
        if dtype == "float32" and not weighted:
            np.testing.assert_array_equal(got, pallas)
        np.testing.assert_allclose(got, pallas, **tol)
        np.testing.assert_allclose(
            got, _f32(jref.embedding_bag_ref(ji, jt, jw)), **tol)
        per_table.append(got)
    stacked = ops.embedding_bag(torch.from_numpy(idx),
                                torch.from_numpy(tables).to(tdt),
                                None if w is None else torch.from_numpy(w))
    np.testing.assert_array_equal(_f32(stacked),
                                  np.concatenate(per_table, axis=1))


def test_out_of_range_probe_values():
    """The probe of the fault's report: table ``arange(12).reshape(4, 3)``
    and indices [[5, -1], [4, 0]] give [[18, 20, 22], [9, 11, 13]], as
    the reference's oracle and Pallas kernel do."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.asarray([[5, -1], [4, 0]], dtype=np.int32)
    got = ops.embedding_bag(torch.from_numpy(idx), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), [[18, 20, 22], [9, 11, 13]])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.embedding_bag_ref(jnp.asarray(idx),
                                                       jnp.asarray(table))))


def test_build_targets_hopper_from_repo_sources():
    from repro_torch.kernels import _build
    assert _build.sources() == ["decode_attention", "embedding_bag",
                                "fcfs_scan", "flash_attention", "ssd_scan"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.sources():
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
        assert path == _build.library_path(name)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
