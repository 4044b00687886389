"""The training rows of ``chip_smoke.py`` on the CPU: the launch formula
it holds the card's counts to, and the MoE routing tape of its fp32 gate.

On the card each kernel wrapper counts its launches; on the CPU the same
autograd Functions (``kernels.autograd.FlashAttention``, ``SSDScan``) run
the plain versions, so their forwards are counted here instead.  One
``make_train_step`` of every family at ``reduced()`` (B 2 x S 16, two
microbatches, the smoke's own model and batch helpers, an encoder-decoder
with its frames) must make exactly ``chip_smoke.train_launches`` calls:
each forward's, and the same again in remat's recompute.  The fp32 gate's
MoE replay must use every expert pick the kernel path recorded, once, in
the order recorded (the forward's layers, then the recompute's in reverse
order), and leave the tape empty.  The formula is read from the script
itself, as ``tests/test_torch_ssd.py`` reads its gates, so that the two
cannot drift apart.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import autograd as kernel_autograd  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

# (label, architecture): every family
FAMILIES = [("dense", "qwen2.5-3b"), ("mla", "minicpm3-4b"),
            ("moe", "olmoe-1b-7b"), ("vlm", "internvl2-1b"),
            ("ssm", "mamba2-130m"), ("hybrid", "zamba2-2.7b"),
            ("encdec", "whisper-tiny")]
BATCH, SEQ, N_MICRO = 2, 16, 2


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def counted(monkeypatch):
    """Calls of each kernel's autograd Function forward, by kernel name."""
    counts = {"flash_attention": 0, "ssd_scan": 0}
    for name, fn in (("flash_attention", kernel_autograd.FlashAttention),
                     ("ssd_scan", kernel_autograd.SSDScan)):
        def forward(ctx, *args, _name=name, _real=fn.forward):
            counts[_name] += 1
            return _real(ctx, *args)
        monkeypatch.setattr(fn, "forward", staticmethod(forward))
    return counts


@pytest.mark.parametrize("arch", [a for _, a in FAMILIES],
                         ids=[f for f, _ in FAMILIES])
def test_train_step_makes_the_smokes_launches(smoke, counted, arch):
    cfg = get_arch(arch).reduced()
    assert cfg.remat
    api, params = smoke._train_model(cfg, "cpu")
    batch = smoke._train_batch(cfg, BATCH, SEQ, "cpu")
    assert ("extra" in batch) == (cfg.family == "encdec")
    step = make_train_step(api, N_MICRO)
    _, _, metrics = step(params, adamw.init(dict(params.named_parameters())),
                         batch)
    assert np.isfinite(float(metrics["loss"]))
    want = smoke.train_launches(cfg, N_MICRO)
    assert want and all(n > 0 for n in want.values())
    assert counted == {k: want.get(k, 0) for k in counted}


def test_launch_formula_at_the_rows_shapes(smoke):
    """The card's counts a microbatch, before remat's x 2, for the rows the
    smoke trains: zamba2-2.7b's 54 Mamba-2 layers and 9 shared-block
    calls, whisper-tiny's 4 encoder, 4 self and 4 cross attentions, one
    flash call a layer for the cut MoE and MLA rows; the 8b rows as
    before (a launch a layer)."""
    per_micro = {"zamba2-2.7b": {"ssd_scan": 54, "flash_attention": 9},
                 "whisper-tiny": {"flash_attention": 12},
                 "olmoe-1b-7b-n_layers": {"flash_attention": 4},
                 "minicpm3-4b-n_layers": {"flash_attention": 16}}
    for row in smoke.TRAIN_ROWS:
        cfg = dataclasses.replace(get_arch(row.arch), **dict(row.changes))
        got = smoke.train_launches(cfg, smoke.TRAIN_MICRO, 3)
        assert got == {k: n * 2 * smoke.TRAIN_MICRO * 3
                       for k, n in per_micro[row.label].items()}
    kernels = {"mamba2-130m": "ssd_scan", "internvl2-1b": "flash_attention"}
    assert set(smoke.TRAIN_RUNS) == set(kernels)
    for arch in smoke.TRAIN_RUNS:
        cfg = get_arch(arch)
        assert smoke.train_launches(cfg) == {kernels[arch]: 2 * cfg.n_layers}


@pytest.mark.parametrize("n_micro", [1, 2])
def test_moe_gate_replays_every_recorded_pick(smoke, counted, n_micro):
    """olmoe-1b-7b at ``reduced()``: the fp32 gate's steps record the
    kernel path's picks and replay them on the plain path's step; every
    layer routes twice a microbatch (the forward and remat's recompute),
    and the replay pops exactly what was pushed.  On the CPU both paths
    run the same math, so no pick flips and the steps agree."""
    cfg = get_arch("olmoe-1b-7b").reduced()
    api, params = smoke._train_model(cfg, "cpu")
    batch = smoke._train_batch(cfg, BATCH, SEQ, "cpu")
    tapes = []
    real = smoke.RoutingTape.drained

    def drained(self, label):
        tapes.append(self)
        real(self, label)

    paths = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(smoke.RoutingTape, "drained", drained)
        out = smoke.fp32_gate_steps(api, params, batch, paths.append, n_micro)
    assert paths == ["kernel", "plain"]
    (tape,) = tapes
    assert not tape.picks
    assert tape.pushed == tape.popped == 2 * cfg.n_layers * n_micro
    assert out["flips"] == (0, 2 * cfg.n_layers * BATCH * SEQ)
    assert counted == {"flash_attention": 2 * cfg.n_layers * n_micro,
                       "ssd_scan": 0}
    np.testing.assert_allclose(out["kernel"][0], out["plain"][0], rtol=1e-6)
    for name, m in out["plain"][1].items():
        np.testing.assert_allclose(out["kernel"][1][name].numpy(), m.numpy(),
                                   rtol=0, atol=1e-6 * float(m.abs().max()))


def test_tape_refuses_a_replay_left_short(smoke):
    """A replay that pops fewer picks than were pushed fails the gate."""
    tape = smoke.RoutingTape()
    picks = torch.tensor([[0, 1], [1, 2]])

    def real(moe, xt, k):
        return torch.full((2, 3), 1 / 3), torch.full((2, 2), 0.5), picks

    with tape.recording(True):
        tape.route(real, None, None, 2)
        tape.route(real, None, None, 2)
    with tape.recording(False):
        tape.route(real, None, None, 2)
    with pytest.raises(AssertionError, match="1 picks after 2 recorded"):
        tape.drained("short replay")
