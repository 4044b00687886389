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
  its AdamW first moment within 1e-5 x max |m| of the unsharded step's;
* checkpoints under the mesh (``train(mesh=, ckpt_dir=)``, reduced
  mamba2-130m, fp32 and bf16): bit for bit.  The files of a sharded run
  equal its ranks' tensors gathered; 2 steps, a checkpoint and a resume
  for 2 more repeat the uninterrupted 4-step run (losses, parameters,
  AdamW state), every restored leaf placed as ``param_shardings`` places
  it; a one-card checkpoint resumes under the mesh and a mesh checkpoint
  on one card; rank 0 alone writes, keeping the last 3; a float32 mesh
  checkpoint restores in the reference's ``checkpoint.restore``.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks as ranks  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models.layers import moe_layer as ref_moe_layer  # noqa: E402
from repro.models.transformer import get_model as ref_get_model  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.transformer import (get_model, lm_untree,  # noqa: E402
                                            make_trainable)
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


def _ref_lm(arch: str, seed: int, replace: dict | None = None) -> tuple:
    """(payload case, reference logits, reference greedy tokens) of
    ``arch``'s ``reduced()`` configuration with the fields of ``replace``
    on top; an encoder-decoder's frames drawn from the seed too."""
    replace = replace or {}
    ref = ref_get_model(dataclasses.replace(REF_ARCHS[arch].reduced(),
                                            **replace))
    params = ref.init_params(jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, ref.cfg.vocab_size,
                          (BATCH, PROMPT)).astype(np.int32)
    extra = None
    if ref.cfg.family == "encdec":
        extra = rng.standard_normal(
            (BATCH, ref.cfg.encoder_seq, ref.cfg.d_model)).astype(
                np.float32) * 0.5
    max_len = PROMPT + STEPS
    cache, last = ref.prefill(params, jnp.asarray(tokens), max_len,
                              None if extra is None else jnp.asarray(extra))
    logits = [np.asarray(last)]
    greedy = [np.asarray(jnp.argmax(last[:, -1], -1).astype(jnp.int32))
              [:, None]]
    for _ in range(STEPS):
        step, cache = ref.decode_step(params, cache, jnp.asarray(greedy[-1]))
        logits.append(np.asarray(step))
        greedy.append(np.asarray(jnp.argmax(step[:, -1], -1)
                                 .astype(jnp.int32))[:, None])
    case = {"arch": arch, "params": jax.tree.map(np.asarray, params),
            "tokens": tokens, "extra": extra, "max_len": max_len,
            "fed": greedy[:STEPS], "replace": replace}
    return case, logits, greedy


def ckpt_payload(root: Path, replace: dict | None = None) -> dict:
    """The checkpoint checks' payload: a directory for the ranks' files,
    and in it the one-card checkpoint of each type (``train()`` on the CPU,
    2 steps, a checkpoint at step 2) that the ranks resume under the
    mesh."""
    one_card = {}
    for dtype in ranks.DTYPES:
        one_card[dtype] = str(root / "one-card" / dtype)
        with ranks.reduced_arch("mamba2-130m", replace):
            train("mamba2-130m", steps=2, ckpt_dir=one_card[dtype],
                  ckpt_every=2, log_every=100, device="cpu",
                  param_dtype=ranks.DTYPES[dtype], **ranks.TRAIN)
    return {"dir": str(root), "one_card": one_card, "replace": replace}


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


def check_files_equal_the_gathered_tensors(got: dict) -> None:
    """(a) and (d): the step-4 file of the run that checkpoints every step
    equals its ranks' tensors gathered, leaf for leaf and bit for bit;
    rank 0 made all six writes (four there, two in the resumed run's
    directory) and no other rank any; the last three are kept."""
    assert got["differ_files"]["every"] == []
    assert got["writes"] == [6, 0, 0, 0]
    assert got["kept"] == [f"step_{s:010d}.{x}" for s in (2, 3, 4)
                           for x in ("json", "npz")]


def check_resume_repeats_the_run(got: dict) -> None:
    """(b): 2 steps, a checkpoint, then 2 more after a resume repeat the
    uninterrupted 4-step run bit for bit (losses, parameters, master, m,
    v), every restored leaf placed as its parameter; the step counter is
    a plain tensor."""
    assert got["steps"] == (4, 4, 2)
    assert len(got["losses"]) == 4
    assert got["resumed_losses"] == got["losses"][2:]
    assert got["differ_params"] == [] and got["differ_opt"] == []
    assert got["off_mesh"]["resumed"] == []


def check_one_card_checkpoint_resumes_under_the_mesh(got: dict) -> None:
    """(c): a one-card checkpoint restored under the mesh: its placed
    leaves equal the file, placed by ``param_shardings``."""
    assert got["differ_files"]["one_card"] == []
    assert got["off_mesh"]["one_card"] == []


def check_mesh_checkpoint_resumes_on_one_card(got: dict, root: Path,
                                              dtype: str,
                                              replace: dict | None) -> None:
    """(c): the resumed sharded run's step-4 checkpoint restored by
    ``train(resume=True)`` on one card equals the ranks' parameters."""
    with ranks.reduced_arch("mamba2-130m", replace):
        params, opt, _ = train("mamba2-130m", steps=0, resume=True,
                               ckpt_dir=str(root / dtype / "resume"),
                               device="cpu", param_dtype=ranks.DTYPES[dtype],
                               **ranks.TRAIN)
    assert int(opt.step) == 4
    for name, p in params.named_parameters():
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      got["params"][name], err_msg=name)


def check_restores_in_the_reference(got: dict, ref_ckpt, root: Path,
                                    replace: dict | None) -> None:
    """(e): the float32 mesh checkpoint restores in the reference's
    ``checkpoint.restore`` into its own train state, with the same leaf
    count and shapes, the parameters the ranks' own."""
    cfg = dataclasses.replace(REF_ARCHS["mamba2-130m"].reduced(),
                              **(replace or {}))
    params = ref_get_model(cfg).init_params(jax.random.PRNGKey(0),
                                            jnp.float32)
    like = {"params": params, "opt": ref_adamw.init(params)}
    back, step = ref_ckpt.restore(root / "float32" / "every", like)
    assert step == 4
    leaves, want = jax.tree.leaves(back), jax.tree.leaves(like)
    assert len(leaves) == len(want)
    assert [a.shape for a in leaves] == [b.shape for b in want]
    port = lm_untree(dataclasses.replace(get_arch("mamba2-130m").reduced(),
                                         **(replace or {})),
                     jax.tree.map(np.asarray, back["params"]))
    for name, p in port.items():
        np.testing.assert_array_equal(p, got["params"][name], err_msg=name)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's answers, then one spawn of the four ranks: (the
    answers, every rank's results, the payload)."""
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
    payload = {"mesh": (2, 2), "moe": moe, "hints": hints, "lm": lm,
               "batch": batch,
               "ckpt": ckpt_payload(tmp_path_factory.mktemp("ckpt"))}
    results = run_ranks(ranks.checks, WORLD, payload, device="cpu",
                        timeout=300)
    return want, results, payload


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


def test_head_split_adds_no_collective_on_this_mesh(spawned):
    """"model" (2) divides every head count of these runs, so
    ``sharding.split_heads`` and ``merge_heads`` gather nothing (ROADMAP
    C-F6): the prefills, decode steps and ``train(mesh=)`` run the
    collectives they ran before the repair."""
    for name in [f"lm {label}" for label in LM_CASES] + ["train"]:
        assert _got(spawned, name)["head_gathers"] == 0, name


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


@pytest.mark.parametrize("dtype", list(ranks.DTYPES))
def test_mesh_checkpoint_files_equal_the_gathered_tensors(spawned, dtype):
    check_files_equal_the_gathered_tensors(_got(spawned, f"ckpt {dtype}"))


@pytest.mark.parametrize("dtype", list(ranks.DTYPES))
def test_mesh_resume_repeats_the_uninterrupted_run(spawned, dtype):
    check_resume_repeats_the_run(_got(spawned, f"ckpt {dtype}"))


@pytest.mark.parametrize("dtype", list(ranks.DTYPES))
def test_one_card_checkpoint_resumes_under_the_mesh(spawned, dtype):
    check_one_card_checkpoint_resumes_under_the_mesh(
        _got(spawned, f"ckpt {dtype}"))


@pytest.mark.parametrize("dtype", list(ranks.DTYPES))
def test_mesh_checkpoint_resumes_on_one_card(spawned, dtype):
    check_mesh_checkpoint_resumes_on_one_card(
        _got(spawned, f"ckpt {dtype}"), Path(spawned[2]["ckpt"]["dir"]),
        dtype, None)


def test_mesh_checkpoint_restores_in_the_reference(spawned, ref_ckpt):
    check_restores_in_the_reference(_got(spawned, "ckpt float32"), ref_ckpt,
                                    Path(spawned[2]["ckpt"]["dir"]), None)
