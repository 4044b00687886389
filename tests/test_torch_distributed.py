"""Port parity: the multi-device half (``launch.mesh.make_process_mesh``,
``launch.sharding``'s placement, the models' sharding hints,
``layers.moe_layer_local``, the steps and ``train`` under a mesh that
splits) on four gloo ranks on the CPU, against the reference on one
device.

One module-scoped spawn (``launch.mesh.run_ranks``: a ``file://``
rendezvous in a temporary directory, 300 s limit, a failing rank fails
it) of 4 ranks on a (2, 2) ("data", "model") mesh runs every check of
``tests/torch_dist_ranks.py`` (which imports no JAX and nothing of the
reference); this process computes the reference's answers first and each
check reports to a test of its own.  Inputs come from numpy seeds.

Tolerances:
* ``moe_layer_local`` against the reference's ``moe_layer(_global=True)``
  at ``tests/test_moe_local.py``'s configuration: outputs within 1e-4, the
  reference test's own bound; gradients finite and within 1e-4 of the
  reference's global layer's;
* the buffer hints (expert-parallel, ``capacity``, ``capacity2d``) and the
  sharded LMs' prefill and decode: within 1e-5 x max |out| or max
  |logits| (the sums run in another order over shards), the same greedy
  tokens;
* ``train(mesh=)``, 3 fp32 steps of reduced mamba2-130m, against
  ``train()`` without a mesh: losses within 1e-5 (relative); parameters
  by ``tests/test_torch_train.py``'s AdamW bounds, max gap <= 0.05 lr and
  mean gap <= 1e-5 lr (a first AdamW step moves each element by +-lr
  whatever its gradient's size, so an element whose gradient lies within
  rounding of 0 can move by 2 lr either way: no bound relative to max |p|
  holds element by element);
* ``make_train_step(grad_shardings=)``: each gradient placed by its spec,
  its AdamW first moment within 1e-5 x max |m| of the unsharded step's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks as ranks  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models.layers import moe_layer as ref_moe_layer  # noqa: E402
from repro.models.transformer import get_model as ref_get_model  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.transformer import get_model, make_trainable  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

WORLD = 4
LR = 3e-4                      # train()'s default
PROMPT, STEPS, BATCH = 8, 4, 4
LM_CASES = {"olmoe-1b-7b": ("olmoe-1b-7b", None),
            "olmoe-1b-7b local": ("olmoe-1b-7b", "local"),
            "qwen2.5-3b": ("qwen2.5-3b", None)}
# (experts, buffer mode) and the buffer's placements on ("data", "model")
HINTS = {"expert-parallel": (4, "none", "[Replicate(), Shard(dim=0)]"),
         "capacity": (3, "capacity", "[Replicate(), Shard(dim=1)]"),
         "capacity2d": (3, "capacity2d", "[Shard(dim=1), Shard(dim=1)]")}


def _moe_arrays(rng, e: int) -> dict:
    d, f = ranks.MOE_BASE["d_model"], ranks.MOE_BASE["d_expert"]

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"router": draw((d, e), d ** -0.5),
            "w1": draw((e, d, f), d ** -0.5), "w3": draw((e, d, f), d ** -0.5),
            "w2": draw((e, f, d), f ** -0.5),
            "x": draw((4, 8, d), 0.5)}


def _ref_moe_cfg(**kw):
    return dataclasses.replace(REF_ARCHS["mixtral-8x22b"].reduced(),
                               **{**ranks.MOE_BASE, **kw})


def _ref_moe(arrays: dict, cfg, shards: int = 1):
    """The reference's global layer on one device: its output and aux loss,
    and the gradients of (out ** 2).mean() + aux.  With ``shards`` > 1 the
    aux loss is the mean of the global layer's aux over that many batch
    shards, as ``moe_layer_local`` takes it (``pmean`` over the data
    axes; ROADMAP C-R37), in the aux and in the gradients."""
    params = {"router": jnp.asarray(arrays["router"]),
              "experts": {n: jnp.asarray(arrays[n])
                          for n in ("w1", "w3", "w2")}}
    x = jnp.asarray(arrays["x"])

    def layer(p):
        o, a = ref_moe_layer(p, x, cfg, _global=True)
        if shards > 1:
            a = sum(ref_moe_layer(p, part, cfg, _global=True)[1]
                    for part in jnp.split(x, shards)) / shards
        return o, a

    def loss(p):
        o, a = layer(p)
        return (o ** 2).mean() + a
    out, aux = layer(params)
    grads = jax.grad(loss)(params)
    return {"out": np.asarray(out), "aux": float(aux),
            "grads": {"router": np.asarray(grads["router"]),
                      **{n: np.asarray(grads["experts"][n])
                         for n in ("w1", "w3", "w2")}}}


def _ref_lm(arch: str, seed: int) -> tuple:
    """(payload case, reference logits, reference greedy tokens)."""
    ref = ref_get_model(REF_ARCHS[arch].reduced())
    params = ref.init_params(jax.random.PRNGKey(0), jnp.float32)
    tokens = np.random.default_rng(seed).integers(
        0, ref.cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    max_len = PROMPT + STEPS
    cache, last = ref.prefill(params, jnp.asarray(tokens), max_len)
    logits = [np.asarray(last)]
    greedy = [np.asarray(jnp.argmax(last[:, -1], -1).astype(jnp.int32))
              [:, None]]
    for _ in range(STEPS):
        step, cache = ref.decode_step(params, cache, jnp.asarray(greedy[-1]))
        logits.append(np.asarray(step))
        greedy.append(np.asarray(jnp.argmax(step[:, -1], -1)
                                 .astype(jnp.int32))[:, None])
    case = {"arch": arch, "params": jax.tree.map(np.asarray, params),
            "tokens": tokens, "max_len": max_len, "fed": greedy[:STEPS]}
    return case, logits, greedy


@pytest.fixture(scope="module")
def spawned():
    """The reference's answers, then one spawn of the four ranks: (the
    answers, every rank's results)."""
    rng = np.random.default_rng(0)
    moe = _moe_arrays(rng, 4)
    want = {"moe": _ref_moe(moe, _ref_moe_cfg(fsdp=True)),
            "moe_shards": _ref_moe(moe, _ref_moe_cfg(fsdp=True), shards=2),
            "hints": {}, "lm": {}}
    hints = {}
    for label, (e, mode, _) in HINTS.items():
        arrays = moe if e == 4 else _moe_arrays(np.random.default_rng(1), e)
        hints[label] = {**arrays, "e": e, "mode": mode}
        want["hints"][label] = _ref_moe(arrays, _ref_moe_cfg(n_experts=e))
    lm = {}
    for seed, (label, (arch, mode)) in enumerate(LM_CASES.items()):
        case, logits, greedy = _ref_lm(arch, seed)
        lm[label] = {**case, "mode": mode}
        want["lm"][label] = (logits, greedy)
    chunk = SyntheticTokens(256, seed=5).batch(4, 17)
    batch = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
    want["batch"] = batch
    payload = {"moe": moe, "hints": hints, "lm": lm, "batch": batch}
    results = run_ranks(ranks.checks, WORLD, payload, device="cpu",
                        timeout=300)
    return want, results


def _got(spawned, name: str) -> dict:
    got = spawned[1][0][name]
    assert "error" not in got, got.get("error")
    return got


def test_every_rank_holds_the_same_results(spawned):
    """A DTensor's ``full_tensor`` is the same on every rank: each rank's
    results equal rank 0's."""
    first = spawned[1][0]
    for other in spawned[1][1:]:
        assert other.keys() == first.keys()
        for name in first:
            flat_a = jax.tree.leaves(first[name])
            flat_b = jax.tree.leaves(other[name])
            assert len(flat_a) == len(flat_b), name
            for a, b in zip(flat_a, flat_b):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=name)


def test_moe_layer_local_matches_the_global_layer(spawned):
    """The output is the global layer's (dropless at capacity 8.0); the aux
    loss is the data shards' mean of the global layer's aux on each, as
    the reference's ``pmean`` makes it (C-R37)."""
    got, want = _got(spawned, "moe_local"), spawned[0]["moe"]
    assert got["local_calls"] == 1
    assert got["out"].shape == want["out"].shape == (4, 8, 32)
    assert np.abs(got["out"] - want["out"]).max() < 1e-4
    assert abs(float(got["aux"]) - spawned[0]["moe_shards"]["aux"]) < 1e-4


def test_moe_layer_local_gradients_match_the_global_layer(spawned):
    """Finite; the experts' equal to the global layer's, the router's to
    those of the global layer with the shards' mean aux (the one term in
    which the two layers' losses differ)."""
    got = _got(spawned, "moe_local")
    for name in ("router", "w1", "w3", "w2"):
        assert np.isfinite(got["grads"][name]).all(), name
        want = spawned[0]["moe_shards" if name == "router" else "moe"]
        np.testing.assert_allclose(got["grads"][name], want["grads"][name],
                                   rtol=0, atol=1e-4, err_msg=name)
    for name in ("w1", "w3", "w2"):
        np.testing.assert_allclose(spawned[0]["moe"]["grads"][name],
                                   spawned[0]["moe_shards"]["grads"][name],
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("label", list(HINTS))
def test_buffer_hints_place_the_buffer(spawned, label):
    got = _got(spawned, "hints")[label]
    want = spawned[0]["hints"][label]
    assert got["buffer"] == [HINTS[label][2]]
    scale = np.abs(want["out"]).max()
    assert np.abs(got["out"] - want["out"]).max() <= 1e-5 * scale
    assert abs(float(got["aux"]) - want["aux"]) <= 1e-5 * abs(want["aux"])


@pytest.mark.parametrize("label", list(LM_CASES))
def test_sharded_prefill_and_decode_match_reference(spawned, label):
    got = _got(spawned, f"lm {label}")
    logits, greedy = spawned[0]["lm"][label]
    assert len(got["logits"]) == len(logits) == STEPS + 1
    for i, (g, w) in enumerate(zip(got["logits"], logits)):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), i
    for i, (g, w) in enumerate(zip(got["greedy"], greedy)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {i}")
    # the cache and the embedding really are split over the mesh
    assert got["cache_placements"]["pos"] == "[Replicate(), Replicate()]"
    split = [p for n, p in got["cache_placements"].items() if n != "pos"]
    assert split and all("Shard" in p for p in split)
    assert got["embed_placements"] == "[Replicate(), Shard(dim=0)]"


def test_train_under_a_process_mesh_matches_train(spawned):
    got = _got(spawned, "train")
    params, _, losses = train("mamba2-130m", steps=3, batch_size=4,
                              seq_len=16, device="cpu", log_every=3)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    gaps = np.concatenate([
        np.abs(got["params"][n] - p.detach().numpy()).ravel()
        for n, p in params.named_parameters()])
    assert gaps.max() <= 0.05 * LR and gaps.mean() <= 1e-5 * LR
    assert any("Shard" in p for p in got["placements"].values())


def test_grad_shardings_place_each_gradient(spawned):
    got = _got(spawned, "grad_shardings")
    assert got["split"] > 0
    assert len(got["placed"]) == len(got["m"])
    assert all(placed == want for placed, want in got["placed"])
    cfg = get_arch("qwen2.5-3b").reduced()
    api = get_model(cfg)
    params = make_trainable(api.init_params(torch.Generator().manual_seed(0),
                                            torch.float32, "cpu"))
    opt = adamw.init(dict(params.named_parameters()))
    batch = {k: torch.from_numpy(v) for k, v in spawned[0]["batch"].items()}
    _, opt, metrics = make_train_step(api, 1)(params, opt, batch)
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    for name, m in opt.m.items():
        want = m.numpy()
        np.testing.assert_allclose(got["m"][name], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_constrain_places_by_spec(spawned):
    got = _got(spawned, "constrain")
    want = {"batch, model": ("[Shard(dim=0), Shard(dim=1)]", (4, 4)),
            "(data, model), None": ("[Shard(dim=0), Shard(dim=0)]", (2, 8)),
            "model on dim 0": ("[Replicate(), Shard(dim=0)]", (4, 8)),
            "indivisible": ("[Replicate(), Replicate()]", (3, 5))}
    for label, (placements, local) in want.items():
        assert got[label]["placements"] == placements, label
        assert got[label]["local"] == local, label
        assert got[label]["equal"], label


def test_op_walk_records_the_moe_collectives(spawned):
    """A walk of one sharded MoE layer (``moe_layer_local`` under fsdp)
    records the all-gathers of w1, w3 and w2 and the all-reduces of the
    expert outputs and the aux loss, and a collective term above 0."""
    got = _got(spawned, "walk")
    assert got["counts"]["all-gather"] >= 3
    assert got["counts"]["all-reduce"] >= 2
    assert got["wire_bytes"] > 0 and got["collective_s"] > 0


def test_kernels_refuse_a_dtensor(spawned):
    """The kernels take each rank's local shard (``sharding.local_call``):
    every entry point raises on a DTensor, none runs its plain version."""
    got = _got(spawned, "kernels")
    assert set(got) == {"flash_attention", "decode_attention", "ssd_scan",
                        "embedding_bag", "fcfs_scan"}
    for name, msg in got.items():
        assert "takes local tensors, got a DTensor" in msg, (name, msg)
