"""Port parity: the mesh layer (``repro_torch.launch.mesh``,
``launch.sharding``) against the reference's sharding policy.

Every case of ``tests/test_sharding_policy.py`` ported, each also held to
the reference's answer; then every parameter leaf of all ten architectures
at full size and every cache leaf of the decode shapes (with and without
``seq_parallel_kv``) at the production meshes (16, 16) and (2, 16, 16)
and at (4, 2) and (1, 1): the port's spec equals the reference's, as
tuples.  The reference's leaves come from ``jax.eval_shape`` of its init
functions, its specs from its own ``param_shardings`` and
``cache_shardings`` with ``NamedSharding`` replaced by a pass-through (a
shape-only mesh has no devices); the port's leaves are its meta tensors.
The port's parameters are per layer: each takes the spec of the stacked
reference leaf it belongs to (``transformer.ref_path``).  Its caches are
stacked as the reference's; two leaves differ in form: the step counter
``t`` is a Python int (``models/cache.py``: a step picks its slot with no
read from the device), a 0-d leaf to the policy as the reference's ()
array is, and the encoder-decoder's ``enc_pos`` (the cross-attention
validity table of the decode kernel) has no reference leaf: replicated.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch import sharding as ref_shp  # noqa: E402
from repro.models.transformer import get_model as ref_get_model  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, cell_is_applicable  # noqa: E402
from repro_torch.launch import sharding as shp  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_local_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.transformer import get_model, ref_path  # noqa: E402


class FakeMesh:
    """Shape-only stand-in for resolution tests (no devices needed)."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "4x2": dict(data=4, model=2), "1x1": dict(data=1, model=1)}


def _both(fn_name, *args):
    """The port's answer and the reference's, as tuples."""
    got = getattr(shp, fn_name)(*args)
    want = getattr(ref_shp, fn_name)(*args)
    return got, tuple(want)


# ---------------------------------------------------------------------------
# tests/test_sharding_policy.py, ported


def test_resolve_batch_axis():
    m = FakeMesh(pod=2, data=16, model=16)
    got, want = _both("resolve_spec", ("batch", None), (256, 128), m)
    assert got == want == (("pod", "data"), None)


def test_resolve_divisibility_fallback():
    m = FakeMesh(data=16, model=16)
    # 6 heads % 16 != 0 → replicate that dim
    got, want = _both("resolve_spec", ("batch", None, "model", None),
                      (32, 1, 6, 64), m)
    assert got == want == ("data", None, None, None)
    # 2048 % 16 == 0 → shard
    got, want = _both("resolve_spec", (None, "model"), (128, 2048), m)
    assert got == want == (None, "model")


def test_resolve_missing_axis_dropped():
    m = FakeMesh(data=16, model=16)   # no 'pod'
    got, want = _both("resolve_spec", ("batch",), (256,), m)
    assert got == want == ("data",)


def _ref_path(*keys):
    return tuple(jax.tree_util.DictKey(k) for k in keys)


def test_param_specs_column_row_parallel():
    m = FakeMesh(data=16, model=16)
    cfg, ref_cfg = ARCHS["qwen2-7b"], REF_ARCHS["qwen2-7b"]
    # column-parallel attention projection: output features sharded
    for name, want in (("wq", (None, None, "model")),
                       ("wo", (None, "model", None))):
        got = shp.spec_for_param(("layers", "attn", name), (28, 3584, 3584),
                                 cfg, m)
        ref = ref_shp.spec_for_param(_ref_path("layers", "attn", name),
                                     (28, 3584, 3584), ref_cfg, m)
        assert got == tuple(ref) == want


def test_moe_expert_parallel_when_divisible():
    m = FakeMesh(data=16, model=16)
    keys = ("layers", "moe", "experts", "w1")
    # 64 experts % 16 == 0 → EP
    got = shp.spec_for_param(keys, (16, 64, 2048, 1024),
                             ARCHS["olmoe-1b-7b"], m)
    ref = ref_shp.spec_for_param(_ref_path(*keys), (16, 64, 2048, 1024),
                                 REF_ARCHS["olmoe-1b-7b"], m)
    assert got == tuple(ref) == (None, "model", None, None)
    # 8 experts % 16 != 0 → per-expert TP, plus FSDP 'data' on a replicated
    # dim (mixtral sets fsdp=True)
    got = shp.spec_for_param(keys, (56, 8, 6144, 16384),
                             ARCHS["mixtral-8x22b"], m)
    ref = ref_shp.spec_for_param(_ref_path(*keys), (56, 8, 6144, 16384),
                                 REF_ARCHS["mixtral-8x22b"], m)
    assert got == tuple(ref)
    assert got[-1] == "model"
    assert "data" in tuple(x for x in got if x)


def test_fsdp_augments_replicated_dim():
    m = FakeMesh(data=16, model=16)
    keys = ("layers", "attn", "wq")
    got = shp.spec_for_param(keys, (56, 6144, 6144), ARCHS["mixtral-8x22b"],
                             m)
    ref = ref_shp.spec_for_param(_ref_path(*keys), (56, 6144, 6144),
                                 REF_ARCHS["mixtral-8x22b"], m)
    assert got == tuple(ref)
    assert "data" in tuple(x for x in got if x)
    assert "model" in tuple(x for x in got if x)


def test_cache_shardings_seqpar_variant():
    m = FakeMesh(data=16, model=16)
    k_shape = (36, 128, 32768, 2, 128)
    got, want = _both("resolve_spec", ("batch", None, "model", None),
                      k_shape, m)
    # right-aligned over (L,B,W,K,hd): layer dim replicated, kv=2 unshardable
    assert got == want == (None, "data", None, None, None)
    got, want = _both("resolve_spec", ("batch", "model", None, None),
                      k_shape[1:], m)
    assert got == want == ("data", "model", None, None)


def test_constrain_noop_outside_mesh():
    x = torch.ones((8, 8))
    assert shp.active_mesh() is None
    assert shp.constrain(x, "batch", "model") is x


def test_constrain_applies_inside_mesh():
    x = torch.ones((8, 8))
    mesh = make_local_mesh("cpu")
    with shp.activate(mesh):
        assert shp.active_mesh() is mesh
        y = shp.constrain(x, "batch", "model")   # sizes 1 → all replicated
    assert y is x
    assert shp.active_mesh() is None


def test_constrain_raises_where_it_would_shard():
    """A mesh without a process group (a shape-only description) places
    nothing: a spec that would split a tensor raises, never replicating
    it quietly; one that resolves to replicated passes the tensor."""
    x = torch.ones((8, 8))
    with shp.activate(FakeMesh(data=2, model=4)):
        # a dim the axis does not divide resolves to replicated
        assert shp.constrain(torch.ones((3, 5)), "batch", "model").shape \
            == (3, 5)
        with pytest.raises(NotImplementedError, match="no process group"):
            shp.constrain(x, "batch", None)
    sharding = shp.NamedSharding(FakeMesh(data=2, model=4), (None, "model"))
    with pytest.raises(NotImplementedError, match="no process group"):
        shp.with_sharding_constraint(x, sharding)
    replicated = shp.NamedSharding(FakeMesh(data=2, model=4), (None, None))
    assert shp.with_sharding_constraint(x, replicated) is x


@pytest.mark.parametrize("spec,ndim,want", [
    (("data", "model"), None, ("Shard(dim=0)", "Shard(dim=1)")),
    ((("data", "model"), None), None, ("Shard(dim=0)", "Shard(dim=0)")),
    ((None, "model"), None, ("Replicate()", "Shard(dim=1)")),
    ((None, None), None, ("Replicate()", "Replicate()")),
    # a stacked leaf's spec on one layer's tensor: the layer axis dropped
    ((None, "data", "model"), 2, ("Shard(dim=0)", "Shard(dim=1)")),
    ((None, None, "model"), 1, ("Replicate()", "Shard(dim=0)"))])
def test_placements_of_a_spec(spec, ndim, want):
    """Each mesh axis named in element d of a spec is Shard(d) on its mesh
    dimension, every other mesh dimension Replicate(); a tuple element
    splits one dimension over several mesh dimensions."""
    got = shp.placements(spec, FakeMesh(data=2, model=2), ndim)
    assert tuple(map(repr, got)) == want


def test_data_sharding_matches_reference():
    for axes in MESHES.values():
        m = FakeMesh(**axes)
        for shape in ((256, 4096), (1, 1), (128, 1)):
            want = ref_shp.resolve_spec(("batch", None), shape, m)
            assert shp.data_sharding(shape, m).spec == tuple(want)


def test_meshes():
    mesh = make_local_mesh("cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices == [torch.device("cpu")]
    assert isinstance(mesh, Mesh)
    if torch.cuda.device_count() < 256:
        for multi in (False, True):
            with pytest.raises(RuntimeError, match="process group of"):
                make_production_mesh(multi_pod=multi)


# ---------------------------------------------------------------------------
# every leaf of every architecture at the production meshes


@pytest.fixture
def ref_named_sharding(monkeypatch):
    """The reference's shardings as their specs, on any mesh."""
    monkeypatch.setattr(ref_shp, "NamedSharding", lambda mesh, spec: spec)


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch: str):
    api = ref_get_model(REF_ARCHS[arch])
    return jax.eval_shape(lambda: api.init_params(jax.random.PRNGKey(0),
                                                  jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    api = get_model(ARCHS[arch])
    return api.init_params(torch.Generator(), torch.bfloat16, "meta")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_parameter_leaf_matches_reference(arch, mesh,
                                                ref_named_sharding):
    m = FakeMesh(**MESHES[mesh])
    cfg = ARCHS[arch]
    want = ref_shp.param_shardings(_ref_param_shapes(arch), REF_ARCHS[arch],
                                   m)
    ref_specs = {tuple(k.key for k in path): tuple(spec) for path, spec in
                 jax.tree_util.tree_flatten_with_path(
                     want, is_leaf=lambda x: isinstance(x, P))[0]}
    got = shp.param_shardings(_port_params(arch), cfg, m)
    # every reference leaf is some port parameter's, the MoE routers (buffers
    # while serving) included
    assert {ref_path(cfg, n) for n in got} == set(ref_specs)
    for name, sharding in got.items():
        assert sharding.mesh is m
        assert sharding.spec == ref_specs[ref_path(cfg, name)], name
    if mesh == "1x1":
        assert not any(any(s.spec) for s in got.values())


DECODE_CELLS = [(arch, shape) for arch in ARCHS for shape, (_, _, kind)
                in SHAPES.items()
                if kind == "decode" and cell_is_applicable(ARCHS[arch],
                                                           shape)[0]]


@pytest.mark.parametrize("seqpar", [False, True], ids=["kv", "seqpar"])
@pytest.mark.parametrize("cell", DECODE_CELLS, ids="-".join)
def test_every_cache_leaf_matches_reference(cell, seqpar,
                                            ref_named_sharding):
    arch, shape = cell
    seq, batch, _ = SHAPES[shape]
    cfg = dataclasses.replace(ARCHS[arch], seq_parallel_kv=seqpar)
    ref_cfg = dataclasses.replace(REF_ARCHS[arch], seq_parallel_kv=seqpar)
    ref_api = ref_get_model(ref_cfg)
    ref_cache = jax.eval_shape(lambda: ref_api.init_cache(batch, seq,
                                                          jnp.bfloat16))
    cache = get_model(cfg).init_cache(batch, seq, torch.bfloat16, "meta")
    assert isinstance(cache["t"], int) and ref_cache["t"].shape == ()
    port_only = set(cache) - set(ref_cache)
    assert port_only == ({"enc_pos"} if cfg.family == "encdec" else set())
    assert set(ref_cache) <= set(cache)
    for axes in MESHES.values():
        m = FakeMesh(**axes)
        want = ref_shp.cache_shardings(ref_cache, ref_cfg, m)
        got = shp.cache_shardings(cache, cfg, m)
        for name in ref_cache:
            assert got[name].spec == tuple(want[name]), (name, axes)
        for name in port_only:
            assert not any(got[name].spec)
