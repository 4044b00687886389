"""The port at the reference's production layout: a (16, 16) ("data",
"model") mesh over 256 ranks, built on the CPU from torch's ``fake``
process group (``torch.testing._internal.distributed.fake_pg``, private to
torch: the test skips where the installed torch lacks it), the steps
walked on the meta device.

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
"""

import importlib.util
import json
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


@pytest.fixture(scope="module")
def walked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), env.get("PYTHONPATH", "")])
    run = subprocess.run([sys.executable, str(HERE / "torch_production_walk.py")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _check(walked, cell: str) -> dict:
    got = walked[cell]
    if "skipped" in got:
        return got
    assert got["ok"], got["error"]
    assert got["flops"] > 0
    return got


@pytest.mark.parametrize("cell", CELLS)
def test_serving_step_walks_at_the_production_layout(walked, cell):
    got = _check(walked, cell)
    if "skipped" in got:
        return
    cfg = get_arch(cell.split()[0])
    for name, placements in got["cache"].items():
        on_model = placements.strip("[]").split(", ")[1]
        if cfg.n_kv_heads % MODEL:
            assert on_model == "Replicate()", (name, placements)
        else:
            assert on_model == "Shard(dim=3)", (name, placements)


def test_every_gqa_cache_was_checked(walked):
    """The decode and prefill cells of every architecture with a GQA cache
    reported its placements, and at least one of them keeps the heads
    whole (the case the repair is for)."""
    reported = [c for c in CELLS if walked[c].get("cache")]
    assert len(reported) >= 14
    assert any(get_arch(c.split()[0]).n_kv_heads % MODEL for c in reported)


@pytest.mark.parametrize("cell", TRAIN)
def test_training_step_walks_at_the_production_layout(walked, cell):
    _check(walked, cell)
