"""Port parity: ``repro_torch.launch.specs`` against ``repro.launch.specs``
for every applicable (arch x shape) cell, by shape and dtype.

The reference's specs are ``jax.ShapeDtypeStruct``s from ``jax.eval_shape``
of its init functions; the port's are tensors on the meta device (nothing
allocated).  The port's per-layer parameters and AdamW leaves are
compared through the reference's stacked layout (``lm_tree``); its
parameter specs include the MoE routers (buffers while serving, float32
as in the reference).  Caches are stacked in both packages; the port's
step counter ``t`` is a Python int where the reference's is an int32 ()
array, and its encoder-decoder cache adds ``enc_pos`` (the cross
attention's position table).
"""

import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models.transformer import get_model as ref_get_model  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, cell_is_applicable  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.transformer import get_model, lm_tree  # noqa: E402

CELLS = [(arch, shape) for arch in ARCHS for shape in SHAPES
         if cell_is_applicable(ARCHS[arch], shape)[0]]


def _form(x) -> tuple:
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    if isinstance(x, torch.Tensor):
        assert x.device.type == "meta"
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), str(np.dtype(x.dtype))


def _forms(tree) -> dict:
    """Every leaf's form by its path of keys."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    return {tuple(k.key for k in path): _form(leaf) for path, leaf in leaves}


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    """(port parameter specs, reference parameter specs) of ``arch``."""
    return (specs.param_specs(get_model(ARCHS[arch])),
            ref_specs.param_specs(ref_get_model(REF_ARCHS[arch])))


def test_param_dtype_and_microbatches():
    assert specs.PARAM_DTYPE == torch.bfloat16
    assert specs.CACHE_DTYPE == torch.bfloat16
    for arch in ARCHS:
        for shape in SHAPES:
            assert specs.n_microbatches(ARCHS[arch], shape) == \
                ref_specs.n_microbatches(REF_ARCHS[arch], shape)


@pytest.mark.parametrize("cell", CELLS, ids="-".join)
def test_cell_specs_match_reference(cell):
    arch, shape = cell
    kind = SHAPES[shape][2]
    got, want = specs.input_specs(arch, shape), ref_specs.input_specs(arch,
                                                                      shape)
    assert {k: _form(v) for k, v in got.items()} == \
        {k: _form(v) for k, v in want.items()}

    params, ref_params = _params(arch)
    cfg = ARCHS[arch]
    leaves = params.state_dict(keep_vars=True)
    assert all(t.device.type == "meta" for t in leaves.values())
    assert _forms(lm_tree(cfg, leaves)) == _forms(ref_params)

    if kind == "train":
        opt = specs.opt_specs(params)
        ref_opt = ref_specs.opt_specs(ref_params)
        assert _form(opt.step) == _form(ref_opt.step)
        for field in ("master", "m", "v"):
            assert _forms(lm_tree(cfg, getattr(opt, field))) == \
                _forms(getattr(ref_opt, field)), field

    if kind == "decode":
        cache = specs.cache_specs(get_model(cfg), arch, shape)
        ref_cache = ref_specs.cache_specs(ref_get_model(REF_ARCHS[arch]),
                                          arch, shape)
        assert isinstance(cache.pop("t"), int)
        assert _form(ref_cache.pop("t")) == ((), "int32")
        if cfg.family == "encdec":
            assert _form(cache.pop("enc_pos")) == ((REF_ARCHS[arch]
                                                    .encoder_seq,), "int32")
        assert {k: _form(v) for k, v in cache.items()} == \
            {k: _form(v) for k, v in ref_cache.items()}
    else:
        with pytest.raises(ValueError):
            specs.cache_specs(get_model(cfg), arch, shape)
