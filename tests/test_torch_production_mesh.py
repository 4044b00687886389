"""The port at the reference's production layout, through its dry run
(``launch.dryrun``): a (16, 16) ("data", "model") mesh over 256 ranks and
a (2, 16, 16) ("pod", "data", "model") one over 512, built on the CPU
from torch's ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``, private to torch: the
test skips where the installed torch lacks it), the steps walked on the
meta device.

``tests/torch_production_walk.py`` runs in a subprocess (the fake group
must not leak into this process): every architecture's ``prefill_32k``
and ``decode_32k`` step, the cells that ``cell_is_applicable`` skips
skipped, and each family's training step at full width (depth cut to one
hybrid block or two layers, a global batch of 16 sequences of 128 in one
microbatch).  Every cell must walk.  Where "model" does not divide the
KV heads, the KV cache's ``k`` and ``v`` stay whole on "model"; where it
divides them, they split their heads over it.

On the tree before ``sharding.split_heads`` and ``merge_heads``, the
prefill and decode of qwen2.5-3b, qwen2-7b, minicpm3-4b, internvl2-1b,
whisper-tiny and mixtral-8x22b raised ``Cannot unflatten unevenly sharded
tensor``, and so did the training steps of every family but the MoE and
the hybrid (mamba2-130m in the backward of the merge of its 24 heads).

The dry run's gates (ROADMAP C-F7):
(a) one rank's parameter and AdamW bytes equal, bit for bit, the sum of
    rank 0's ``shard_shape`` bytes under the reference's
    ``param_shardings`` (``tests/ref_rank_bytes.py``, a second subprocess
    with 512 forced host devices), for every architecture at both meshes;
(b) per-device flops split the one-card walk of the same step (see
    ``test_per_device_flops_split_the_one_card_walk``);
(c) the multi-pod mesh splits the batch over ("pod", "data"), so a cell
    whose batch divides 32 halves its per-device flops and keeps its
    per-device parameter bytes;
(e) C-F7's cases: under a mesh the walk counts each rank's local product
    and the collectives DTensor issues inside an op, and counts a call
    alike when walked twice.  On the tree before the repair the walk
    counted the global product (4,194,304 flops) and no all-gather.
And C-F9's: ``layers.dense`` on (B, 1, D) rows that ``DTensor.from_local``
made runs one product; before the repair ``x @ w`` ran as a batched
product on ``w`` expanded, which DTensor copied for each local row.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_arch  # noqa: E402

if importlib.util.find_spec("torch.testing._internal.distributed.fake_pg") \
        is None:
    pytest.skip("this torch has no fake process group "
                "(torch.testing._internal.distributed.fake_pg)",
                allow_module_level=True)

import torch_production_walk as walk  # noqa: E402

HERE = Path(__file__).resolve().parent

MODEL = walk.MESH[1]
CELLS = [f"{a} {s}" for a in ARCHS for s in ("prefill_32k", "decode_32k")]
TRAIN = [f"{a} train_4k" for a in walk.FAMILIES.values()]
GATED = [f"{a} {s}" for a, s in walk.GATED]
MULTI = [f"{a} {s}" for a, s in walk.MULTI]
SIZES = {"pod": 2, "data": 16, "model": 16}
# ROADMAP C-R38: rank 0's bytes at both meshes, from the reference's specs
REFERENCE_TABLE = {"qwen2.5-3b": (424_918_272, 2_549_509_636),
                   "mixtral-8x22b": (1_111_044_096, 6_633_234_436)}


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), env.get("PYTHONPATH", "")])
    return env


@pytest.fixture(scope="module")
def both():
    """The port's walk and the reference's rank bytes, run side by side."""
    ref = subprocess.Popen([sys.executable, str(HERE / "ref_rank_bytes.py")],
                           env=_env() | {"JAX_PLATFORMS": "cpu"},
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    run = subprocess.run([sys.executable, str(HERE / "torch_production_walk.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    ref_out, ref_err = ref.communicate(timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    assert ref.returncode == 0, ref_err[-4000:]
    return (json.loads(run.stdout.strip().splitlines()[-1]),
            json.loads(ref_out.strip().splitlines()[-1]))


@pytest.fixture(scope="module")
def walked(both):
    return both[0]


def _check(walked, cell: str) -> dict:
    got = walked["cells"][cell]
    if "skipped" in got:
        return got
    assert got["ok"], got["error"]
    assert got["flops_per_device"] > 0
    return got


def _n(axes) -> int:
    return math.prod(SIZES[a] for a in axes)


@pytest.mark.parametrize("cell", CELLS)
def test_serving_step_walks_at_the_production_layout(walked, cell):
    got = _check(walked, cell)
    if "skipped" in got:
        return
    cfg = get_arch(cell.split()[0])
    for name, placements in got["cache_placements"].items():
        if name not in ("k", "v"):
            continue
        on_model = placements.strip("[]").split(", ")[1]
        if cfg.n_kv_heads % MODEL:
            assert on_model == "Replicate()", (name, placements)
        else:
            assert on_model == "Shard(dim=3)", (name, placements)


def test_every_gqa_cache_was_checked(walked):
    """The decode and prefill cells of every architecture with a GQA cache
    reported its placements, and at least one of them keeps the heads
    whole (the case the repair is for)."""
    reported = [c for c in CELLS
                if "k" in walked["cells"][c].get("cache_placements", {})]
    assert len(reported) >= 14
    assert any(get_arch(c.split()[0]).n_kv_heads % MODEL for c in reported)


@pytest.mark.parametrize("cell", TRAIN)
def test_training_step_walks_at_the_production_layout(walked, cell):
    _check(walked, cell)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_rank_bytes_equal_the_reference(both, arch, mesh):
    """(a): one rank's parameter and AdamW bytes, bit for bit; a walked
    cell's record carries the same parameter bytes."""
    walked, ref = both
    assert walked["state"][mesh][arch] == ref[mesh][arch]
    cells = walked["cells"] if mesh == "single" else walked["multi"]
    for cell, rec in cells.items():
        if cell.split()[0] == arch and rec.get("ok") and \
                not cell.endswith("train_4k"):
            assert rec["memory_analysis"]["argument_params_bytes"] == \
                ref[mesh][arch]["params"], cell


def test_reference_rank_bytes_reproduce_the_recorded_table(both):
    """The reference side gives ROADMAP C-R38's table at both meshes."""
    ref = both[1]
    for mesh in ("single", "multi"):
        for arch, (params, adamw) in REFERENCE_TABLE.items():
            assert ref[mesh][arch] == {"params": params, "adamw": adamw}


@pytest.mark.parametrize("cell", GATED)
def test_per_device_flops_split_the_one_card_walk(walked, cell):
    """(b): with b the ranks of the cell's batch axes (``split["batch"]``,
    none where "data" does not divide the batch) and n(axes) the ranks of
    a list of mesh axes,

        flops/device = Σ_w F(w) / n_w + Σ_k K_k / n(split[k]) + F_0 / b

    within 1e-3 relative, where the one-card walk of the same step gives
    F(w), the flops of the products on parameter w, K_k, kernel k's flops
    (``kernels``; split[k] is ``split["attention"]`` for the attention
    kernels, ``split["ssd_scan"]`` for the SSD scan) and F_0, the products
    on no parameter; and n_w is n(split["experts"]) for the experts'
    weights (the capacity buffer whole on "data"),
    n(split["moe_dispatch"]) for the MoE router (every rank routes every
    token), and otherwise b, times 16 where w's spec names "model"."""
    rec = _check(walked, cell)
    one = walked["one_card"][cell]
    split = rec["split"]
    b = _n(split["batch"])
    want = 0.0
    for w, flops in one["by_weight"].items():
        if ".experts." in w:
            n = _n(split["experts"])
        elif w.endswith(".router"):
            n = _n(split["moe_dispatch"])
        elif not w:
            n = b
        else:
            n = b * (SIZES["model"] if "model" in one["axes"][w] else 1)
        want += flops / n
    for k, flops in one["kernels"].items():
        want += flops / _n(split["ssd_scan" if k == "ssd_scan"
                                 else "attention"])
    assert sum(one["by_weight"].values()) + sum(one["kernels"].values()) \
        == pytest.approx(one["flops"], rel=1e-9)
    assert rec["flops_per_device"] == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("cell", MULTI)
def test_multi_pod_mesh_halves_the_flops(walked, cell):
    """(c): the batch splits over ("pod", "data"), 32 ranks; the parameters
    split as on one pod."""
    one_pod, two = _check(walked, cell), walked["multi"][cell]
    assert two["ok"], two.get("error")
    assert two["chips"] == 512 and two["split"]["batch"] == ["pod", "data"]
    assert two["flops_per_device"] == pytest.approx(
        one_pod["flops_per_device"] / 2, rel=1e-3)
    assert two["memory_analysis"]["argument_params_bytes"] == \
        one_pod["memory_analysis"]["argument_params_bytes"]


@pytest.mark.parametrize("cell", CELLS + TRAIN)
def test_memory_analysis_adds_up(walked, cell):
    got = _check(walked, cell)
    if "skipped" in got:
        return
    mem = got["memory_analysis"]
    parts = [v for k, v in mem.items() if k.startswith("argument_")
             and k != "argument_size_in_bytes"]
    assert mem["argument_size_in_bytes"] == sum(parts) > 0
    assert mem["alias_size_in_bytes"] == mem.get("argument_cache_bytes", 0)
    assert mem["temp_size_in_bytes"] is None
    assert mem["generated_code_size_in_bytes"] is None
    assert mem["output_size_in_bytes"] > 0
    if cell.endswith("train_4k"):
        assert mem["argument_adamw_bytes"] > mem["argument_params_bytes"]


def test_walk_counts_the_local_product(walked):
    """(e): x (64, 128) [Shard(0), Replicate()] times w (128, 256)
    [Replicate(), Shard(1)] on (2, 2): each rank's (32, 128) x (128, 128),
    no collective."""
    got = walked["cf7"]["column"]
    assert got["flops"] == 1_048_576
    assert not any(got["collective_counts"].values())


def test_walk_counts_the_gather_inside_the_op(walked):
    """(e): x (64, 128) [Replicate(), Shard(1)] times the same w: DTensor
    gathers x inside the op, one all-gather, then each rank's
    (64, 128) x (128, 128)."""
    got = walked["cf7"]["gathered"]
    assert got["collective_counts"]["all-gather"] == 1
    assert sum(got["collective_counts"].values()) == 1
    assert got["flops"] == 2 * 64 * 128 * 128


def test_second_walk_of_a_call_counts_alike(walked):
    """(e): DTensor's sharding propagation ran the op at the whole shapes
    on the first walk only (a miss of its cache); neither walk counts it."""
    assert walked["cf7"]["again"] == walked["cf7"]["gathered"]


def test_dense_runs_one_product_on_rows_from_local(walked):
    """C-F9: x (8, 1, 128) from ``DTensor.from_local`` (global strides
    (128, 256, 1): the size-1 dimension's scaled by the shard count, so
    ``matmul`` does not fold it) [Shard(0), Replicate()] times a
    replicated w (128, 96) through ``layers.dense``: each rank's one
    (4, 128) x (128, 96) product, its operands read and its output
    written once (on the tree before, ``x @ w`` copied w for each of the
    4 local rows and ran a batched product: 2 ops, several times the
    bytes)."""
    got = walked["cf7"]["dense"]
    assert got["n_ops"] == 1
    assert got["flops"] == 2 * 4 * 128 * 96
    assert got["hbm_bytes"] == 4 * (4 * 128 + 128 * 96 + 4 * 96)
    assert not any(got["collective_counts"].values())


def test_zamba2_decode_step_gathers_no_weight_and_no_state(walked):
    """ROADMAP F-6a: zamba2-2.7b's ``decode_32k`` step at (16, 16), whose
    "model" axis divides its 80 SSM heads, runs each Mamba-2 layer on its
    shards of the weights and of the state.  No all-gather's operand has
    the local shape of a parameter or of a layer's state (before the
    repair every layer gathered its ``in_proj`` and ``out_proj`` a token,
    4.873e9 wire bytes a rank); its wire bytes a rank lie 100 times below
    that, and the collective term no longer dominates."""
    got = walked["ssm_gathers"]
    held = {tuple(s) for s in got["held"]}
    gathered = {tuple(s) for s in got["gathered"]}
    assert gathered and not held & gathered, held & gathered
    rec = _check(walked, " ".join(walk.SSM_GATHERS))
    assert rec["collective_bytes_per_device"] < 4.873e9 / 100
    assert rec["roofline"]["dominant"] != "collective"
