"""Port parity: heads split over a model axis that does not divide them
(``launch.sharding.split_heads`` and ``merge_heads``), and checkpoints
under that mesh, on four gloo ranks on the CPU on a (1, 4) ("data",
"model") mesh, against the reference on one device.

DTensor cannot unflatten a projection's last dimension, sharded over
"model", into a head count that "model" does not divide (XLA's
partitioner can).  On the tree before the repair (``split_heads`` and
``merge_heads`` absent) these raise ``Cannot unflatten unevenly sharded
tensor``:
* the prefills of the reduced qwen2.5-3b, whisper-tiny and olmoe-1b-7b
  (2 KV heads) and of a reduced minicpm3-4b with 6 heads (MLA, at its
  query split);
* a training step of a mamba2-130m cut to d_model 208 with 13 SSM heads
  of 32, in the backward of the merge of its heads, where the
  row-parallel ``out_proj`` hands back a gradient sharded over "model".
  The cut with 6 heads of 16 (d_model 48), which ``train(mesh=)`` runs
  here, does not raise there: at that size DTensor's cheapest strategy
  hands the gradient back whole.
The repair gathers that dimension first; the kernels then run every head
on each rank (``sharding.split_elems`` drops "model").

Rank 0 also counts the collectives of one qwen2.5-3b prefill by kind
(``CommDebugMode``), and the dry run's walk of the same call on torch's
``fake`` group of 4 (``tests/torch_production_walk.py heads``) must count
the same (ROADMAP C-F7: before the repair the walk missed every
collective DTensor issues inside an op).

One module-scoped spawn (``launch.mesh.run_ranks``) of 4 ranks runs the
checks of ``tests/torch_dist_ranks.py`` on the (1, 4) mesh; this process
computes the reference's answers first, from the same replaced
configurations.  Tolerances are ``tests/test_torch_distributed.py``'s:
prefill and decode logits within 1e-5 x max |logits| with the same greedy
tokens; ``train(mesh=)`` against ``train()`` by its AdamW bounds; the
13-head step's loss within 1e-5 (relative) and its AdamW first moment
within 1e-5 x max |m| of the unsharded step's (the ``grad_shardings``
bound: after 3 steps the AdamW bound on the parameters does not hold
there, since an element whose gradient lies within rounding of AdamW's
eps moves by a fraction of lr either way); the checkpoint checks bit for
bit, in fp32 and bf16.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks as ranks  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.transformer import get_model, make_trainable  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_distributed import (LR, STEPS, WORLD, _ref_lm,  # noqa: E402
                                    check_files_equal_the_gathered_tensors,
                                    check_mesh_checkpoint_resumes_on_one_card,
                                    check_one_card_checkpoint_resumes_under_the_mesh,
                                    check_restores_in_the_reference,
                                    check_resume_repeats_the_run,
                                    ckpt_payload, ref_ckpt)

# the configurations whose heads "model" (4) does not divide: label →
# (arch, fields replaced on its reduced() configuration)
LM_CASES = {"qwen2.5-3b": ("qwen2.5-3b", {}),
            "whisper-tiny": ("whisper-tiny", {}),
            "olmoe-1b-7b": ("olmoe-1b-7b", {}),
            "minicpm3-4b 6 heads": ("minicpm3-4b",
                                    {"n_heads": 6, "n_kv_heads": 6})}
SSM = {"d_model": 48}                        # d_inner 96: 6 SSM heads of 16
SSM_WIDE = {"d_model": 208, "ssm_headdim": 32}  # d_inner 416: 13 heads of 32
# the SSM and hybrid LMs, whose decode step runs on the reference's split
# (``ssm.ssm_decode_step`` given the "model" group): label → (arch,
# fields replaced, whether "model" divides the SSM heads).  Reduced, 8
# heads of 16 over 4; with SSM, 6.
SSM_CASES = {"mamba2-130m": ("mamba2-130m", {}, True),
             "zamba2-2.7b": ("zamba2-2.7b", {}, True),
             "mamba2-130m 6 heads": ("mamba2-130m", SSM, False)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's answers, then one spawn of the four ranks: (the
    answers, every rank's results, the payload)."""
    want, lm = {}, {}
    cases = {**LM_CASES, **{k: v[:2] for k, v in SSM_CASES.items()}}
    for seed, (label, (arch, replace)) in enumerate(cases.items()):
        case, logits, greedy = _ref_lm(arch, seed, replace)
        lm[label] = case
        want[label] = (logits, greedy)
    chunk = SyntheticTokens(256, seed=5).batch(4, 17)
    batch = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
    payload = {"mesh": (1, 4), "lm": lm, "collectives": "qwen2.5-3b",
               "ssm_step": {"replace": SSM_WIDE, "batch": batch},
               "ckpt": ckpt_payload(tmp_path_factory.mktemp("ckpt"), SSM)}
    results = run_ranks(ranks.checks, WORLD, payload, device="cpu",
                        timeout=300)
    return want, results, payload


def _got(spawned, name: str) -> dict:
    got = spawned[1][0][name]
    assert "error" not in got, got.get("error")
    return got


def _matches_reference(spawned, label: str) -> dict:
    """The ranks' prefill and decode logits of ``label`` within 1e-5 x max
    |logits| of the reference's, the same greedy tokens; their results."""
    got = _got(spawned, f"lm {label}")
    logits, greedy = spawned[0][label]
    assert len(got["logits"]) == len(logits) == STEPS + 1
    for i, (g, w) in enumerate(zip(got["logits"], logits)):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), i
    for i, (g, w) in enumerate(zip(got["greedy"], greedy)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {i}")
    return got


@pytest.mark.parametrize("label", list(LM_CASES))
def test_prefill_and_decode_match_reference(spawned, label):
    got = _matches_reference(spawned, label)
    # "model" does not divide the KV heads: the cache keeps them whole
    for name in ("k", "v", "ckv", "krope"):
        if name in got["cache_placements"]:
            assert got["cache_placements"][name] == \
                "[Replicate(), Replicate()]", name
    assert got["embed_placements"] == "[Replicate(), Shard(dim=0)]"


@pytest.mark.parametrize("label", list(SSM_CASES))
def test_ssm_prefill_and_decode_match_reference(spawned, label):
    """The SSM and hybrid LMs on (1, 4): the decode step on each rank's
    heads and shards of ``in_proj`` and ``out_proj`` (ROADMAP F-6a)."""
    got = _matches_reference(spawned, label)
    # the state splits its heads over "model" where it divides them
    state = got["cache_placements"]["state"]
    assert ("Shard" in state) == SSM_CASES[label][2], state


@pytest.mark.parametrize("label", list(SSM_CASES))
def test_ssm_decode_step_gathers_no_weight_and_no_state(spawned, label):
    """Every all-gather of a decode step takes an activation: no operand
    has the local shape of a parameter or of a layer's SSM state (before
    the repair each Mamba-2 layer gathered its weights, and its state
    heads where they were split); with 8 heads some are gathered (the
    ``in_proj`` product's column shards), with 6 none."""
    got = _got(spawned, f"lm {label}")
    held = {tuple(s) for s in got["held"]}
    gathered = [tuple(s) for s in got["step_gathers"]]
    assert not held & set(gathered), (held & set(gathered))
    if SSM_CASES[label][0] == "mamba2-130m":
        assert bool(gathered) == SSM_CASES[label][2], gathered


def test_the_head_split_gathers_where_model_does_not_divide(spawned):
    """On (1, 4) each case's split of its 2 KV heads (6 MLA heads; the
    13-head SSM step's merge, on its gradient) gathers; the 6-head
    SSM's ``train(mesh=)`` may or may not, by DTensor's strategy."""
    for name in [f"lm {label}" for label in LM_CASES] + ["ssm_step"]:
        assert _got(spawned, name)["head_gathers"] > 0, name


# CommDebugMode's op names → the walk's collective kinds
_KINDS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all"}


def test_dry_run_walk_counts_the_prefill_collectives(spawned):
    """(d): the walk of rank 0's prefill on a fake world of 4 at (1, 4)
    counts its collectives by kind as the gloo run counted them."""
    if importlib.util.find_spec(
            "torch.testing._internal.distributed.fake_pg") is None:
        pytest.skip("this torch has no fake process group")
    ran = {}
    for op, n in _got(spawned, "collectives").items():
        kind = _KINDS.get(op.rsplit(".", 1)[-1], op)
        ran[kind] = ran.get(kind, 0) + n
    case = spawned[2]["lm"]["qwen2.5-3b"]
    here = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(here.parent / "src"),
                                         env.get("PYTHONPATH", "")])
    arg = json.dumps({"arch": case["arch"], "replace": case["replace"],
                      "tokens": list(case["tokens"].shape),
                      "max_len": case["max_len"]})
    run = subprocess.run([sys.executable, str(here / "torch_production_walk.py"),
                          "heads", arg], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    walked = json.loads(run.stdout.strip().splitlines()[-1])
    assert ran and walked == ran


def test_every_rank_holds_the_same_logits(spawned):
    first = spawned[1][0]
    for other in spawned[1][1:]:
        for label in [*LM_CASES, *SSM_CASES]:
            for a, b in zip(first[f"lm {label}"]["logits"],
                            other[f"lm {label}"]["logits"]):
                np.testing.assert_array_equal(a, b, err_msg=label)


def test_train_with_six_ssm_heads_matches_train(spawned):
    got = _got(spawned, "train")
    with ranks.reduced_arch("mamba2-130m", SSM):
        params, _, losses = train("mamba2-130m", steps=3, device="cpu",
                                  log_every=3, **ranks.TRAIN)
    assert params.layers[0].ssm["A_log"].shape == (6,)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    gaps = np.concatenate([
        np.abs(got["params"][n] - p.detach().numpy()).ravel()
        for n, p in params.named_parameters()])
    assert gaps.max() <= 0.05 * LR and gaps.mean() <= 1e-5 * LR
    assert got["placements"]["layers.0.ssm.out_proj"] == \
        "[Replicate(), Shard(dim=0)]"


def test_step_with_thirteen_ssm_heads_matches_the_unsharded_step(spawned):
    got = _got(spawned, "ssm_step")
    cfg = dataclasses.replace(get_arch("mamba2-130m").reduced(), **SSM_WIDE)
    api = get_model(cfg)
    params = make_trainable(api.init_params(torch.Generator().manual_seed(0),
                                            torch.float32, "cpu"))
    assert params.layers[0].ssm["A_log"].shape == (13,)
    opt = adamw.init(dict(params.named_parameters()))
    batch = {k: torch.from_numpy(v)
             for k, v in spawned[2]["ssm_step"]["batch"].items()}
    _, opt, metrics = make_train_step(api, 1)(params, opt, batch)
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    for name, m in opt.m.items():
        want = m.numpy()
        np.testing.assert_allclose(got["m"][name], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


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
        dtype, SSM)


def test_mesh_checkpoint_restores_in_the_reference(spawned, ref_ckpt):
    check_restores_in_the_reference(_got(spawned, "ckpt float32"), ref_ckpt,
                                    Path(spawned[2]["ckpt"]["dir"]), SSM)
