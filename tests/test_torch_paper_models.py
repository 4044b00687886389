"""Port parity: CANDLE, ResNet50, VGG19 and DIEN in PyTorch against
``repro.models.paper_models``, and the registry of all five paper models.

The reference's parameters (``<model>_init(PRNGKey(...), "smoke")``) are
carried into the port with ``<model>_from_numpy``; batches come from a
numpy seed.  Tolerance rtol = atol = 1e-5, as ``tests/test_torch_mtwnd.py``:
the float32 products and convolutions sum in another order in the two
frameworks (seen: at most 2e-6 on VGG19's outputs of about 2.7).  The smoke
ResNet's stem (32 x 32 image, 7 x 7 conv, stride 2) and its 3 x 3 stride-2
max pool meet XLA's asymmetric ``"SAME"`` pads, so these forwards pin them:
PyTorch's symmetric ``padding=`` gives outputs of the same shape that are
off by O(1).  CANDLE and DIEN run every power-of-two bucket 1..32; the conv
nets 1, 8 and 32 (the reference's eager ops compile once per shape).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import paper_models as jpm  # noqa: E402
from repro_torch.models import paper_models as tpm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MODELS = ["candle", "resnet50", "vgg19", "mtwnd", "dien"]
NEW = ["candle", "resnet50", "vgg19", "dien"]
SEEDS = {"candle": 3, "resnet50": 4, "vgg19": 5, "dien": 6}
FORWARDS = ([("candle", b) for b in (1, 2, 4, 8, 16, 32)]
            + [(m, b) for m in ("resnet50", "vgg19") for b in (1, 8, 32)]
            + [("dien", b) for b in (1, 2, 4, 8, 16, 32)])


@pytest.fixture(scope="module")
def pair():
    """name -> (reference params, the port's module carried from them)."""
    cache = {}

    def get(name):
        if name not in cache:
            params = jpm.PAPER_MODELS[name].init(
                jax.random.PRNGKey(SEEDS[name]), "smoke")
            model = tpm.PAPER_MODELS[name].from_numpy(
                jax.tree.map(np.asarray, params), "smoke", device="cpu")
            cache[name] = params, model
        return cache[name]
    return get


def _batch(name, b, seed=0):
    """The same batch for both packages from a numpy seed: standard normal
    floats, integers in [0, 100)."""
    rng = np.random.default_rng(seed + 97 * b)
    jb, tb = {}, {}
    for key, s in jpm.PAPER_MODELS[name].input_spec("smoke", b).items():
        if np.issubdtype(s.dtype, np.integer):
            x = rng.integers(0, 100, s.shape).astype(s.dtype)
        else:
            x = rng.standard_normal(s.shape).astype(s.dtype)
        jb[key], tb[key] = jnp.asarray(x), torch.from_numpy(x.copy())
    return jb, tb


@pytest.mark.parametrize("name,b", FORWARDS)
def test_forward_matches_reference(pair, name, b):
    params, model = pair(name)
    jb, tb = _batch(name, b)
    want = np.asarray(jpm.PAPER_MODELS[name].apply(params, jb))
    got = tpm.PAPER_MODELS[name].apply(model, tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_registry_keys_match_reference():
    assert list(tpm.PAPER_MODELS) == list(jpm.PAPER_MODELS)
    for name, m in tpm.PAPER_MODELS.items():
        assert m.name == name
        assert callable(m.from_numpy)


@pytest.mark.parametrize("preset", ["smoke", "full"])
@pytest.mark.parametrize("name", MODELS)
def test_input_spec_matches_reference(name, preset):
    want = jpm.PAPER_MODELS[name].input_spec(preset, 4)
    got = tpm.PAPER_MODELS[name].input_spec(preset, 4)
    assert list(got) == list(want)
    for key, (shape, dtype) in got.items():
        assert shape == want[key].shape
        assert str(dtype) == f"torch.{np.dtype(want[key].dtype).name}"


@pytest.mark.parametrize("name", MODELS)
def test_random_batch_matches_reference_shapes_and_ranges(name):
    want = jpm.make_random_batch(name, "smoke", 8, seed=1)
    got = tpm.make_random_batch(name, "smoke", 8, seed=1, device="cpu")
    assert list(got) == list(want)
    for key, x in got.items():
        w = np.asarray(want[key])
        assert tuple(x.shape) == w.shape
        assert str(x.dtype) == f"torch.{w.dtype.name}"
        if not x.dtype.is_floating_point:
            # the reference's range, [0, 100), for every integer input
            assert 0 <= int(x.min()) and int(x.max()) < 100
            assert 0 <= w.min() and w.max() < 100
    again = tpm.make_random_batch(name, "smoke", 8, seed=1, device="cpu")
    for key in got:
        assert torch.equal(got[key], again[key])
    if name == "dien":
        assert got["target"].shape == (8,)


@pytest.mark.parametrize("size,k,stride", [
    (32, 7, 2), (16, 3, 2), (224, 7, 2), (112, 3, 2), (56, 1, 2),
    (7, 3, 2), (15, 3, 1), (5, 4, 3), (8, 1, 1), (1, 3, 2)])
def test_same_pads_follow_xla(size, k, stride):
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert tpm.same_pads(size, k, stride) == tuple(want)


def test_smoke_stem_and_pool_pads_are_asymmetric():
    """The pads the smoke ResNet meets: 2 low and 3 high for the stem, 0
    and 1 for the pool, where ``padding=3`` / ``padding=1`` would be
    symmetric."""
    assert tpm.same_pads(32, 7, 2) == (2, 3)
    assert tpm.same_pads(16, 3, 2) == (0, 1)


def test_conv_converter_permutes_hwio_to_oihw(pair):
    params, model = pair("resnet50")
    w = np.asarray(params["stem"]["w"])                 # (k, k, cin, cout)
    got = model.stem.weight.numpy()                     # (cout, cin, k, k)
    assert got.shape == (w.shape[3], w.shape[2], w.shape[0], w.shape[1])
    np.testing.assert_array_equal(got[5, 1, 2, 6], w[2, 6, 1, 5])
    blk = model.stages[1][0]
    assert blk.c1.stride == blk.proj.stride == 2 and blk.c2.stride == 1


def test_vgg19_flattens_in_nhwc_order(pair):
    """The first fc layer reads the features in NHWC order: moving one
    input of the flattened vector moves the output as the reference's
    row of that index says."""
    params, model = pair("vgg19")
    feat = np.zeros((1, model.fc.layers[0].in_features), np.float32)
    feat[0, 5] = 1.0          # NHWC (h 0, w 0, c 5)
    got = model.fc.layers[0](torch.from_numpy(feat)).detach().numpy()
    want = np.asarray(params["fc"][0]["w"])[5] + np.asarray(
        params["fc"][0]["b"])
    np.testing.assert_allclose(got[0], want, rtol=0, atol=0)


def test_dien_gru_converter_stacks_the_gates(pair):
    params, model = pair("dien")
    g = params["gru1"]
    hid = model.gru1.hidden
    for i, gate in enumerate(("r", "z", "h")):
        np.testing.assert_array_equal(
            model.gru1.wx[:, i * hid:(i + 1) * hid].numpy(),
            np.asarray(g[gate]["wx"]))
        np.testing.assert_array_equal(
            model.gru1.b[i * hid:(i + 1) * hid].numpy(),
            np.asarray(g[gate]["b"]))
    np.testing.assert_array_equal(model.gru1.wh_rz[:, hid:].numpy(),
                                  np.asarray(g["z"]["wh"]))
    np.testing.assert_array_equal(model.gru1.wh_h.numpy(),
                                  np.asarray(g["h"]["wh"]))


@pytest.mark.parametrize("name", NEW)
def test_from_numpy_refuses_another_preset(pair, name):
    params, _ = pair(name)
    with pytest.raises(ValueError):
        tpm.PAPER_MODELS[name].from_numpy(jax.tree.map(np.asarray, params),
                                          "full", device="cpu")


@pytest.mark.parametrize("name", NEW)
def test_init_draws_the_reference_scales(name):
    """``*_init`` draws a^-0.5·N(0,1) weights (a = fan-in), zero biases and
    (DIEN) a 0.01·N(0,1) table, from the generator alone."""
    gen = torch.Generator().manual_seed(0)
    model = tpm.PAPER_MODELS[name].init(gen, "smoke", device="cpu")
    again = tpm.PAPER_MODELS[name].init(torch.Generator().manual_seed(0),
                                        "smoke", device="cpu")
    for (key, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), key
        assert not p.requires_grad
        if key.endswith("bias") or key.endswith(".b"):
            assert not p.any(), key
    for layer in model.modules():
        if isinstance(layer, torch.nn.Linear):
            w, fan = layer.weight, layer.in_features
        elif isinstance(layer, tpm.Conv):
            w, fan = layer.weight, layer.weight[0].numel()
        elif isinstance(layer, tpm.GRU):
            w, fan = layer.wx, layer.wx.shape[0]
        else:
            continue
        if w.numel() >= 256:
            assert abs(w.std().item() * fan ** 0.5 - 1.0) < 0.2
    if name == "dien":
        assert abs(model.table.std().item() / 0.01 - 1.0) < 0.05
    batch = tpm.make_random_batch(name, "smoke", 4, device="cpu")
    out = tpm.PAPER_MODELS[name].apply(model, batch)
    assert torch.isfinite(out).all()
    want = jpm.PAPER_MODELS[name].apply(
        jpm.PAPER_MODELS[name].init(jax.random.PRNGKey(0), "smoke"),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert tuple(out.shape) == np.asarray(want).shape


def test_parameter_counts_at_full_width():
    """The full presets' sizes, from the modules' shapes (nothing drawn):
    VGG19 about 143.7 M parameters, CANDLE 17.8 M."""
    counts = {}
    for name in NEW:
        with torch.device("meta"):
            model = {"candle": tpm.CANDLE, "resnet50": tpm.ResNet50,
                     "vgg19": tpm.VGG19, "dien": tpm.DIEN}[name]("full")
        counts[name] = sum(p.numel() for p in model.parameters())
    assert counts["vgg19"] == 143_667_240
    assert 17.5e6 < counts["candle"] < 18.0e6
    assert counts["dien"] > 500_000 * 64
