"""Port parity: checkpointing (``repro_torch.serving.checkpoint``) — the
reference's checkpoint tests (``tests/test_fault_tolerance.py``: round
trip, retention, async, a shape mismatch, an empty directory, an explicit
step, the ``RibbonOptimizer`` round trip) on the port, float32 restores
across the two packages both ways (a generic state and a training state
in the reference's layout), and bf16 (C-R33: the reference writes bf16 as
raw ``|V2`` bytes and cannot read them back as bf16; the port restores
them by the dtype of ``state_like``).  Restored values are bit for bit.

The reference's ``repro.serving`` needs the ``enable_x64`` alias on jax
0.9, so its checkpoint module is imported inside a fixture (as in
``tests/test_torch_catalog.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch.steps import make_train_step as ref_train_step  # noqa: E402
from repro.models.transformer import get_model as ref_get_model  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import RibbonOptimizer  # noqa: E402
from repro_torch.core.search_space import SearchSpace  # noqa: E402
from repro_torch.launch import train as train_module  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.transformer import (adamw_from_numpy,  # noqa: E402
                                            get_model, lm_from_numpy,
                                            lm_untree, make_trainable)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def ref_ckpt():
    """The reference's ``repro.serving.checkpoint``, imported with the
    ``enable_x64`` alias its package needs on jax 0.9."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.serving import checkpoint as ref
    return ref


def _state():
    return {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)},
            "d": torch.tensor(3)}


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    checkpoint.save(tmp_path, state, step=7)
    like = {"a": torch.zeros(2, 3, dtype=torch.long),
            "b": {"c": torch.zeros(4)}, "d": torch.tensor(0)}
    restored, step = checkpoint.restore(tmp_path, like)
    assert step == 7
    assert list(restored) == list(state)
    for key in ("a", "d"):
        assert torch.equal(restored[key], state[key])
    assert torch.equal(restored["b"]["c"], state["b"]["c"])


def test_checkpoint_keep_last_k(tmp_path):
    state = {"x": torch.zeros(2)}
    for s in range(6):
        checkpoint.save(tmp_path, state, step=s, keep=2)
    steps = sorted(int(p.stem.split("_")[1])
                   for p in tmp_path.glob("step_*.npz"))
    assert steps == [4, 5]
    assert sorted(p.name for p in tmp_path.glob("*.json")) == [
        "step_0000000004.json", "step_0000000005.json"]


def test_checkpoint_async(tmp_path):
    state = {"x": torch.arange(10, dtype=torch.int32)}
    t = checkpoint.save(tmp_path, state, step=1, async_write=True)
    state["x"] += 5          # the leaves were copied before save returned
    t.join()
    assert not t.is_alive()
    restored, step = checkpoint.restore(
        tmp_path, {"x": torch.zeros(10, dtype=torch.int32)})
    assert step == 1
    assert torch.equal(restored["x"], torch.arange(10, dtype=torch.int32))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    checkpoint.save(tmp_path, {"x": torch.zeros(3)}, step=0)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(tmp_path, {"x": torch.zeros(5)})


def test_checkpoint_dtype_mismatch_raises(tmp_path):
    checkpoint.save(tmp_path, {"x": torch.zeros(3)}, step=0)
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.restore(tmp_path, {"x": torch.zeros(3, dtype=torch.int32)})


def test_checkpoint_empty_dir(tmp_path):
    state, step = checkpoint.restore(tmp_path, {"x": torch.zeros(1)})
    assert state is None and step is None
    assert checkpoint.latest_step(tmp_path) is None


def test_checkpoint_restore_explicit_step(tmp_path):
    for s in (1, 3, 9):
        checkpoint.save(tmp_path, {"x": torch.full((2,), s)}, step=s, keep=5)
    assert checkpoint.latest_step(tmp_path) == 9
    state, step = checkpoint.restore(
        tmp_path, {"x": torch.zeros(2, dtype=torch.long)}, step=3)
    assert step == 3
    assert state["x"].tolist() == [3, 3]
    # the manifest rides along atomically with its payload
    assert (tmp_path / "step_0000000003.json").exists()


def test_write_in_progress_is_not_a_checkpoint(tmp_path):
    checkpoint.save(tmp_path, {"x": torch.zeros(1)}, step=2)
    (tmp_path / "step_0000000005.tmp.npz").write_bytes(b"partial")
    assert checkpoint.latest_step(tmp_path) == 2


def test_ribbon_optimizer_checkpoint_roundtrip(tmp_path):
    space = SearchSpace(bounds=(4, 4), prices=(1.0, 0.4))
    opt = RibbonOptimizer(space, device="cpu")

    def oracle(c):
        return min(1.0, (3 * c[0] + c[1]) / 10.0)

    for _ in range(5):
        cfg = opt.ask()
        opt.tell(cfg, oracle(cfg))
    checkpoint.save(tmp_path, opt.state_dict(), step=5)
    # state_dict contains python scalars/lists — restore only array leaves
    restored, _ = checkpoint.restore(tmp_path, opt.state_dict())
    opt2 = RibbonOptimizer(space, device="cpu")
    opt2.load_state_dict(restored)
    assert opt2.best_config == opt.best_config
    assert opt2.ask() == opt.ask()


def test_leaves_go_in_jax_flatten_order(tmp_path):
    """Dict keys sorted, NamedTuple fields and sequences in order, None no
    leaf: leaf_i is the i-th leaf of ``jax.tree.leaves``."""
    state = {"z": torch.tensor(1.0), "a": (torch.tensor(2.0), None,
                                           [torch.tensor(3.0)]),
             "m": adamw.AdamWState(torch.tensor(4), {"y": torch.tensor(5.0),
                                                     "x": torch.tensor(6.0)},
                                   {}, {})}
    checkpoint.save(tmp_path, state, step=1)
    with np.load(tmp_path / "step_0000000001.npz") as payload:
        got = [float(payload[f"leaf_{i}"]) for i in range(6)]
    want = jax.tree.leaves(jax.tree.map(np.asarray, {
        "z": 1.0, "a": (2.0, None, [3.0]),
        "m": ref_adamw.AdamWState(4, {"y": 5.0, "x": 6.0}, {}, {})}))
    assert got == [float(w) for w in want] == [2.0, 3.0, 4.0, 6.0, 5.0, 1.0]


def test_float32_state_crosses_both_ways(tmp_path, ref_ckpt):
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "n": {"b": rng.integers(0, 9, 5).astype(np.int32),
                    "a": np.float32(2.5)}}
    ref_state = jax.tree.map(jnp.asarray, arrays)
    ours = {"w": torch.from_numpy(arrays["w"]),
            "n": {"b": torch.from_numpy(arrays["n"]["b"]),
                  "a": torch.tensor(2.5)}}
    ref_ckpt.save(tmp_path / "ref", ref_state, step=4)
    got, step = checkpoint.restore(tmp_path / "ref",
                                   {"w": torch.zeros(3, 4),
                                    "n": {"b": torch.zeros(5, dtype=torch.int32),
                                          "a": torch.tensor(0.0)}})
    assert step == 4
    assert torch.equal(got["w"], ours["w"])
    assert torch.equal(got["n"]["b"], ours["n"]["b"])
    assert torch.equal(got["n"]["a"], ours["n"]["a"])
    checkpoint.save(tmp_path / "port", ours, step=6)
    back, step = ref_ckpt.restore(tmp_path / "port",
                                  jax.tree.map(jnp.zeros_like, ref_state))
    assert step == 6
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(arrays)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_bf16_roundtrip_in_the_port(tmp_path):
    x = torch.randn(5, 3).to(torch.bfloat16)
    checkpoint.save(tmp_path, {"x": x, "y": torch.ones(2)}, step=1)
    with np.load(tmp_path / "step_0000000001.npz") as payload:
        assert payload["leaf_0"].dtype.str == "|V2"
    got, _ = checkpoint.restore(tmp_path, {"x": torch.zeros(5, 3,
                                                            dtype=torch.bfloat16),
                                           "y": torch.zeros(2)})
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"], x)


def test_bf16_payload_is_the_reference_one(tmp_path, ref_ckpt):
    """C-R33: the reference writes a bf16 leaf as 2-byte ``|V2`` values and
    hands them back as a void array; the port writes the same bytes and
    reads the reference's back as bf16."""
    values = np.random.default_rng(1).standard_normal(7).astype(np.float32)
    ref_ckpt.save(tmp_path / "ref", {"x": jnp.asarray(values).astype(
        jnp.bfloat16)}, step=1)
    ours = torch.from_numpy(values).to(torch.bfloat16)
    checkpoint.save(tmp_path / "port", {"x": ours}, step=1)
    payloads = []
    for d in ("ref", "port"):
        with np.load(tmp_path / d / "step_0000000001.npz") as payload:
            payloads.append(payload["leaf_0"])
    assert payloads[0].dtype == payloads[1].dtype
    assert payloads[0].tobytes() == payloads[1].tobytes()
    back, _ = ref_ckpt.restore(tmp_path / "port", {"x": jnp.zeros(7)})
    assert np.asarray(back["x"]).dtype.kind == "V"
    got, _ = checkpoint.restore(tmp_path / "ref",
                                {"x": torch.zeros(7, dtype=torch.bfloat16)})
    assert torch.equal(got["x"], ours)


def _ref_train_state(arch: str):
    """The reference's parameters and AdamW state after one float32 step."""
    ref = ref_get_model(REF_ARCHS[arch].reduced())
    params = jax.jit(ref.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(2)
    chunk = rng.integers(0, ref.cfg.vocab_size, (2, 9)).astype(np.int32)
    params, opt, _ = jax.jit(ref_train_step(ref, 1))(
        params, ref_adamw.init(params),
        {"tokens": jnp.asarray(chunk[:, :-1]),
         "labels": jnp.asarray(chunk[:, 1:])})
    return params, opt


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-2.7b"])
def test_train_state_crosses_both_ways(tmp_path, ref_ckpt, arch):
    """A float32 training checkpoint ({"params", "opt"} in the reference's
    layout) of either package restores in the other, bit for bit."""
    ref_params, ref_opt = _ref_train_state(arch)
    cfg = ARCHS[arch].reduced()
    ref_ckpt.save(tmp_path / "ref", {"params": ref_params, "opt": ref_opt},
                  step=1)
    params = make_trainable(get_model(cfg).init_params(torch.Generator(),
                                                       device="cpu"))
    opt = adamw.init(dict(params.named_parameters()))
    restored, step = checkpoint.restore(
        tmp_path / "ref", train_module.train_state(cfg, params, opt))
    assert step == 1
    opt = train_module.load_train_state(cfg, params, opt, restored)
    want = lm_untree(cfg, jax.tree.map(np.asarray, ref_params))
    for name, p in params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name])
    want_opt = adamw_from_numpy(cfg, jax.tree.map(np.asarray, ref_opt), "cpu")
    assert int(opt.step) == int(want_opt.step) == 1
    for field in ("master", "m", "v"):
        for name, t in getattr(want_opt, field).items():
            assert torch.equal(getattr(opt, field)[name], t), (field, name)

    # and back: the port's checkpoint of that state into the reference
    checkpoint.save(tmp_path / "port",
                    train_module.train_state(cfg, params, opt), step=2)
    like = jax.tree.map(jnp.zeros_like, {"params": ref_params,
                                         "opt": ref_opt})
    back, step = ref_ckpt.restore(tmp_path / "port", like)
    assert step == 2
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves({"params": ref_params, "opt": ref_opt})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_train_state_resumes_in_the_port(tmp_path):
    """A bf16 training checkpoint (bf16 parameters as ``|V2``, the float32
    master and moments) restores into the port's state (C-R33: the
    reference's own bf16 resume fails)."""
    arch = "olmoe-1b-7b"
    cfg = ARCHS[arch].reduced()
    api = get_model(cfg)
    ref_params = jax.jit(ref_get_model(REF_ARCHS[arch].reduced()).init_params,
                         static_argnums=1)(jax.random.PRNGKey(0), jnp.float32)

    def fresh():
        return make_trainable(lm_from_numpy(
            cfg, jax.tree.map(np.asarray, ref_params), torch.bfloat16, "cpu"))

    params = fresh()
    opt = adamw.init(dict(params.named_parameters()))
    step = make_train_step(api, 1, param_dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9))
    params, opt, _ = step(params, opt, {"tokens": tokens[:, :-1],
                                        "labels": tokens[:, 1:]})
    checkpoint.save(tmp_path, train_module.train_state(cfg, params, opt),
                    step=1)
    again = fresh()
    opt2 = adamw.init(dict(again.named_parameters()))
    restored, _ = checkpoint.restore(
        tmp_path, train_module.train_state(cfg, again, opt2, torch.bfloat16))
    opt2 = train_module.load_train_state(cfg, again, opt2, restored)
    for (name, a), (_, b) in zip(params.named_parameters(),
                                 again.named_parameters()):
        assert a.dtype == b.dtype == torch.bfloat16, name
        assert torch.equal(a, b), name
    for name, t in opt.master.items():
        assert torch.equal(opt2.master[name], t), name
