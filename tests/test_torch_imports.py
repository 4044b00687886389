"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU by themselves."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return {**env, **extra}


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    modules = _port_modules()
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location(\n"
        f"    'chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=_env(PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(modules) >= 15 and set(modules) <= set(loaded)
    assert {"repro_torch.models.ssm", "repro_torch.kernels.ssd_scan"} <= set(modules)
    assert {"repro_torch.prng", "repro_torch.serving.instance",
            "repro_torch.serving.simulator", "repro_torch.serving.pool",
            "repro_torch.core.baselines",
            "repro_torch.kernels.fcfs_scan"} <= set(modules)
    assert {"repro_torch.serving.telemetry", "repro_torch.serving.routing",
            "repro_torch.serving.autoscaler",
            "repro_torch.serving.handoff"} <= set(modules)
    assert {"repro_torch.launch.serve",
            "repro_torch.models.paper_models"} <= set(modules)
    assert "repro_torch.serving.cells" in modules
    assert {"repro_torch.optim.adamw", "repro_torch.data.pipeline",
            "repro_torch.serving.checkpoint", "repro_torch.kernels.autograd",
            "repro_torch.launch.train"} <= set(modules)
    assert {"repro_torch.launch.mesh", "repro_torch.launch.sharding",
            "repro_torch.launch.specs", "repro_torch.roofline",
            "repro_torch.roofline.analysis", "repro_torch.roofline.op_walk",
            "repro_torch.roofline.report"} <= set(modules)
    bad = [m for m in loaded if m == "jax" or m.startswith(("jax.", "jaxlib"))
           or m == "repro" or m.startswith("repro.")]
    assert bad == []
    assert {"repro_torch.launch.host_collectives"} <= set(modules)


def test_rank_code_imports_no_jax_and_no_reference():
    """What the spawned ranks of ``tests/test_torch_distributed.py`` run
    (``tests/torch_dist_ranks.py``) and of ``chip_smoke.py``'s phase 12
    (``chip_smoke.mesh_ranks``, the launcher) import neither JAX nor the
    reference."""
    code = (
        "import json, sys\n"
        "import torch_dist_ranks, chip_smoke\n"
        "from repro_torch.launch import mesh\n"
        "assert callable(torch_dist_ranks.checks)\n"
        "assert callable(chip_smoke.mesh_ranks)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=_env(PYTHONPATH=os.pathsep.join(
                             [str(ROOT / "src"), str(ROOT / "tests"),
                              str(ROOT)])))
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m == "jax" or m.startswith(("jax.", "jaxlib"))
           or m == "repro" or m.startswith("repro.")]
    assert bad == []


def _entry_points():
    from repro_torch.core import RibbonOptimizer, SearchSpace, run_ribbon
    from repro_torch.configs import get_arch
    from repro_torch.core.gp import GaussianProcess
    from repro_torch.launch.serve import serve
    from repro_torch.models.paper_models import (PAPER_MODELS,
                                                 make_random_batch,
                                                 mtwnd_init)
    from repro_torch.models.transformer import get_model, lm_from_numpy
    from repro_torch.serving import (PoolEvaluator, PoolSimulator, PoolState,
                                     make_paper_setup, paper_workload,
                                     rescale)
    from repro_torch.scenario import (ScenarioEngine, build_episode,
                                      paper_simulator_plane,
                                      tiered_simulator_plane)
    from repro_torch.serving import StreamingSimulator, paper_spec
    from repro_torch.serving.engine import DEFAULT_CELLS, ClusterEngine
    from repro_torch.serving.instance import AWS_INSTANCES, MODEL_PROFILES
    space = SearchSpace((2, 2), (1.0, 2.0))
    episode = build_episode("diurnal", n=10, window=5)
    pool_args = (MODEL_PROFILES["mtwnd"], [AWS_INSTANCES["g4dn"]],
                 paper_workload("mtwnd", n_queries=10))
    lm = get_model(get_arch("qwen2.5-3b").reduced())
    ssm_lm = get_model(get_arch("mamba2-130m").reduced())
    hybrid_lm = get_model(get_arch("zamba2-2.7b").reduced())
    moe_lm = get_model(get_arch("olmoe-1b-7b").reduced())
    encdec_lm = get_model(get_arch("whisper-tiny").reduced())
    from repro_torch.serving import H100_CELLS, search_cells
    from repro_torch.launch.train import train
    from repro_torch.launch.mesh import make_local_mesh, run_ranks
    return {
        "ClusterEngine": lambda: ClusterEngine("mtwnd", DEFAULT_CELLS),
        "RibbonOptimizer": lambda: RibbonOptimizer(space),
        "run_ribbon": lambda: run_ribbon(space, lambda c: 1.0, budget=2),
        "GaussianProcess": lambda: GaussianProcess(2, (2, 2)),
        "mtwnd_init": lambda: mtwnd_init(torch.Generator(), "smoke"),
        "make_random_batch": lambda: make_random_batch("mtwnd", "smoke", 2),
        "lm_init_params": lambda: lm.init_params(torch.Generator()),
        "lm_init_cache": lambda: lm.init_cache(1, 8),
        "lm_from_numpy": lambda: lm_from_numpy(lm.cfg, {}),
        "ssm_init_params": lambda: ssm_lm.init_params(torch.Generator()),
        "ssm_init_cache": lambda: ssm_lm.init_cache(1, 8),
        "hybrid_init_params": lambda: hybrid_lm.init_params(torch.Generator()),
        "hybrid_init_cache": lambda: hybrid_lm.init_cache(1, 8),
        "moe_init_params": lambda: moe_lm.init_params(torch.Generator()),
        "encdec_init_params": lambda: encdec_lm.init_params(
            torch.Generator()),
        "encdec_init_cache": lambda: encdec_lm.init_cache(1, 8),
        "search_cells": lambda: search_cells(list(H100_CELLS.values())),
        "train": lambda: train("mamba2-130m", steps=1),
        "make_local_mesh": lambda: make_local_mesh(),
        "run_ranks": lambda: run_ranks(len, 2),
        "PoolSimulator": lambda: PoolSimulator(*pool_args),
        "PoolEvaluator": lambda: PoolEvaluator(*pool_args),
        "make_paper_setup": lambda: make_paper_setup("mtwnd", n_queries=10),
        "segment_from": lambda: PoolSimulator(*pool_args).segment_from(
            PoolState.idle(40), (1,)),
        "grid_from": lambda: PoolEvaluator(*pool_args).grid_from(
            PoolState.idle(40), [(1,)], [1.0]),
        "rescale": lambda: rescale(RibbonOptimizer(space),
                                   PoolEvaluator(*pool_args),
                                   load_factors=[1.0, 1.5]),
        "StreamingSimulator": lambda: StreamingSimulator(
            *pool_args[:2], paper_spec("mtwnd")),
        "paper_simulator_plane": lambda: paper_simulator_plane(
            "mtwnd", episode),
        "tiered_simulator_plane": lambda: tiered_simulator_plane(
            "mtwnd", episode),
        "ScenarioEngine": lambda: ScenarioEngine(episode, None, space),
        "serve": lambda: serve("vgg19", verbose=False),
        **{f"{name}_init": (lambda m=m: m.init(torch.Generator(), "smoke"))
           for name, m in PAPER_MODELS.items() if name != "mtwnd"},
    }


@pytest.mark.parametrize("name", ["ClusterEngine", "RibbonOptimizer",
                                  "run_ribbon", "GaussianProcess",
                                  "mtwnd_init", "make_random_batch",
                                  "lm_init_params", "lm_init_cache",
                                  "lm_from_numpy", "ssm_init_params",
                                  "ssm_init_cache", "hybrid_init_params",
                                  "hybrid_init_cache", "moe_init_params",
                                  "encdec_init_params", "encdec_init_cache",
                                  "search_cells", "train", "make_local_mesh",
                                  "run_ranks",
                                  "PoolSimulator",
                                  "PoolEvaluator", "make_paper_setup",
                                  "segment_from", "grid_from", "rescale",
                                  "StreamingSimulator",
                                  "paper_simulator_plane",
                                  "tiered_simulator_plane",
                                  "ScenarioEngine", "serve", "candle_init",
                                  "resnet50_init", "vgg19_init",
                                  "dien_init"])
def test_entry_point_without_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_roofline_report_runs_without_a_card():
    """The report walks its cells on the meta device: it allocates nothing
    and launches nothing, so it runs with no card and takes no device."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.report", "--arch",
         "mamba2-130m", "--shape", "decode_32k"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=_env(PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "| mamba2-130m | decode_32k |" in out.stdout
    assert "### Roofline table" in out.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=_env())
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=_env())
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
