"""Port parity: MT-WND in PyTorch against ``repro.models.paper_models``.

The reference's parameters (``mtwnd_init(PRNGKey(2), "smoke")``) are
carried into the port with ``mtwnd_from_numpy``; batches come from a numpy
seed.  Tolerance rtol = atol = 1e-5: the float32 matrix products sum in
another order in the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import paper_models as jpm  # noqa: E402
from repro_torch.models import paper_models as tpm  # noqa: E402

BUCKETS = [1, 2, 4, 8, 16, 32]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    return jpm.mtwnd_init(jax.random.PRNGKey(2), "smoke")


@pytest.fixture(scope="module")
def model(params):
    return tpm.mtwnd_from_numpy(jax.tree.map(np.asarray, params), "smoke",
                                device="cpu")


def _batch(b, seed=0, preset="smoke"):
    cfg = tpm.MTWND_PRESETS[preset]
    rng = np.random.default_rng(seed + b)
    dense = rng.standard_normal((b, cfg["dense"])).astype(np.float32)
    cat = rng.integers(0, 100, (b, cfg["n_tables"], cfg["bag"])).astype(
        np.int32)
    return ({"dense": jnp.asarray(dense), "cat": jnp.asarray(cat)},
            {"dense": torch.from_numpy(dense), "cat": torch.from_numpy(cat)})


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("b", BUCKETS)
def test_forward_matches_reference(params, model, b, use_kernel):
    jb, tb = _batch(b)
    want = np.asarray(jpm.mtwnd_apply(params, jb, use_kernel=use_kernel))
    got = tpm.mtwnd_apply(model, tb)
    assert got.shape == (b, tpm.MTWND_PRESETS["smoke"]["tasks"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_path_equals_kernel_path_on_cpu(model):
    _, tb = _batch(16, seed=3)
    np.testing.assert_array_equal(
        tpm.mtwnd_apply(model, tb).numpy(),
        tpm.mtwnd_apply(model, tb, use_kernel=False).numpy())


def test_converter_stacks_the_reference_tables(params, model):
    """``mtwnd_from_numpy`` stacks the reference's list of tables into one
    (n_tables, V, D) tensor; ``model.tables[i]`` is table i."""
    cfg = tpm.MTWND_PRESETS["smoke"]
    assert model.tables.shape == (cfg["n_tables"], cfg["vocab"], cfg["emb"])
    assert model.tables.is_contiguous()
    for i, table in enumerate(params["tables"]):
        np.testing.assert_array_equal(model.tables[i].numpy(),
                                      np.asarray(table))


def test_forward_pools_every_table_in_one_call(model, monkeypatch):
    """One ``ops.embedding_bag`` call a forward (one launch on a card), on
    the stacked tables and the batch's own (B, n_tables, bag) indices."""
    calls = []
    real = tpm.ops.embedding_bag

    def spy(indices, tables, weights=None):
        calls.append((tuple(indices.shape), tables.data_ptr()))
        return real(indices, tables, weights)

    monkeypatch.setattr(tpm.ops, "embedding_bag", spy)
    _, tb = _batch(8, seed=4)
    tpm.mtwnd_apply(model, tb)
    cfg = tpm.MTWND_PRESETS["smoke"]
    assert calls == [((8, cfg["n_tables"], cfg["bag"]),
                      model.tables.data_ptr())]


def test_presets_equal_reference():
    assert tpm.MTWND_PRESETS == jpm.MTWND_PRESETS


def test_input_spec_matches_reference():
    for preset in tpm.MTWND_PRESETS:
        want = jpm.mtwnd_input_spec(preset, 8)
        got = tpm.mtwnd_input_spec(preset, 8)
        assert {k: tuple(s.shape) for k, s in want.items()} == {
            k: shape for k, (shape, _) in got.items()}


def test_converter_rejects_wrong_shapes(params):
    tree = jax.tree.map(np.asarray, params)
    tree["bottom"][0]["w"] = tree["bottom"][0]["w"][:, :-1]
    with pytest.raises(ValueError):
        tpm.mtwnd_from_numpy(tree, "smoke", device="cpu")
    with pytest.raises(ValueError):
        tpm.mtwnd_from_numpy(jax.tree.map(np.asarray, params), "full",
                             device="cpu")


def test_init_uses_the_reference_scales():
    gen = torch.Generator().manual_seed(0)
    model = tpm.mtwnd_init(gen, "smoke", device="cpu")
    tables = torch.stack(list(model.tables))
    assert abs(tables.std().item() - 0.01) < 1e-3
    for lin in model.modules():
        if isinstance(lin, torch.nn.Linear):
            assert torch.all(lin.bias == 0)
            std = lin.weight.std().item() * lin.in_features ** 0.5
            assert 0.7 < std < 1.3
    again = tpm.mtwnd_init(torch.Generator().manual_seed(0), "smoke",
                           device="cpu")
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_random_batch_shapes_and_range():
    batch = tpm.make_random_batch("mtwnd", "smoke", 8, seed=0, device="cpu")
    assert batch["dense"].shape == (8, 8) and batch["dense"].dtype == torch.float32
    assert batch["cat"].shape == (8, 3, 4) and batch["cat"].dtype == torch.int32
    assert int(batch["cat"].min()) >= 0 and int(batch["cat"].max()) < 100
    again = tpm.make_random_batch("mtwnd", "smoke", 8, seed=0, device="cpu")
    assert torch.equal(batch["cat"], again["cat"])
    gen = torch.Generator().manual_seed(1)
    out = tpm.mtwnd_apply(tpm.mtwnd_init(gen, "smoke", device="cpu"), batch)
    assert torch.all((out >= 0) & (out <= 1))
