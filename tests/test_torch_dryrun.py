"""The port's dry run end to end through its CLI, in a subprocess (the
CLI builds torch's ``fake`` process group of 256 ranks, which must not
leak into this process): the reference's two dry-run tests
(``tests/test_dryrun_integration.py``), which the reference gates behind
``REPRO_RUN_COMPILE_TESTS`` because XLA compiles for minutes; a walk on
the meta device takes seconds, so these always run.  Then the report
reads the records the CLI wrote (``roofline.report --mesh``)."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

if importlib.util.find_spec("torch.testing._internal.distributed.fake_pg") \
        is None:
    pytest.skip("this torch has no fake process group "
                "(torch.testing._internal.distributed.fake_pg)",
                allow_module_level=True)

REPO = Path(__file__).resolve().parents[1]


def _run(module: str, args: list, timeout: float):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=env | {"PYTHONPATH": str(REPO / "src")})


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    """One CLI run writing both cells' records."""
    out = tmp_path_factory.mktemp("dryrun")
    for arch, shape in (("whisper-tiny", "decode_32k"),
                        ("qwen2.5-3b", "long_500k")):
        proc = _run("repro_torch.launch.dryrun",
                    ["--arch", arch, "--shape", shape, "--mesh", "single",
                     "--out", str(out)], timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    return out


def test_dryrun_cell_subprocess(out_dir):
    """The smallest architecture's decode on the single-pod mesh: a full
    roofline record through the CLI."""
    rec = json.loads((out_dir / "whisper-tiny_decode_32k_single.json")
                     .read_text())
    assert rec["chips"] == 256
    r = rec["roofline"]
    assert r["compute_s"] > 0 and r["bytes_per_device"] > 0
    assert rec["flops_per_device"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")


def test_dryrun_skip_record_subprocess(out_dir):
    """long_500k on a quadratic-attention architecture writes a skip
    record."""
    rec = json.loads((out_dir / "qwen2_5-3b_long_500k_single.json")
                     .read_text())
    assert "skipped" in rec


def test_report_reads_the_dry_run_records(out_dir):
    """``report --mesh single`` prints the reference's tables from the
    records; the skip goes to the skips table."""
    proc = _run("repro_torch.roofline.report",
                ["--mesh", "single", "--out", str(out_dir)], timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "| whisper-tiny | decode_32k |" in proc.stdout
    assert "### Roofline table" in proc.stdout
    skips = proc.stdout.split("### Skips")[1]
    assert "| qwen2.5-3b | long_500k |" in skips
