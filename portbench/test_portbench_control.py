"""The control comes out not correct: the reference computed one precision
below the configurations' bf16 (fp8 e4m3 on every linear layer's inputs)
and put in the program's place reads, on a number a cell compares, more
than that cell's own limit.

On the card this was read at each cell's own size on three seeds or more
(``calibrate.py``; the readings are in PERF.md).  Here it runs on the CPU
at a size a test run holds: each cell's configuration cut in width (and
zamba2's in depth), a few prompts, the control's pick judged at every
position against the float32 reference.  The decode mix runs against the
decode cell's file, which PERF.md keeps for a later cell.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import check

ROOT = Path(__file__).resolve().parents[1]

SMALL = {
    "decoder": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                    d_head=64, vocab_size=4096, n_experts=16, top_k=4,
                    d_expert=128),
    "hybrid": dict(n_layers=24, attn_every=6, d_model=256, n_heads=4,
                   n_kv_heads=4, d_head=64, d_ff=512, vocab_size=4096,
                   ssm_state=32, ssm_headdim=32, ssm_chunk=32),
}
# (configuration, cell file, prompts, prompt length, tokens served a prompt)
CASES = [("olmoe-1b-7b", "olmoe-decode-b64", 4, 64, 32),
         ("olmoe-1b-7b", "olmoe-prefill-b4", 32, 64, 1),
         ("zamba2-2.7b", "zamba2-prefill-b2", 8, 64, 1)]


@pytest.mark.parametrize("config,cell,b,length,served", CASES,
                         ids=[c[1] for c in CASES])
def test_the_control_is_not_correct(config, cell, b, length, served):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json")
                     .read_text())
    cfg["arch"].update(SMALL[cfg["reference"]])
    limits = json.loads((ROOT / "portbench" / "workloads" / f"{cell}.json")
                        .read_text())["check"]
    seed = 12
    gen = torch.Generator().manual_seed(seed)
    vocab = cfg["arch"]["vocab_size"]
    prompts = torch.randint(0, vocab, (b, length), generator=gen)
    tokens = torch.randint(0, vocab, (b, served), generator=gen)
    got = check.Judge(cfg, seed, "cpu").gaps(prompts, tokens, control=True)
    theirs = got["control_gaps"]
    err = check.row_errors(got["control_rows"], got["rows"])
    readings = {"max_logit_gap": float(theirs.max()),
                "mean_logit_gap": float(theirs.mean()),
                "max_row_err": float(err[:, 0].max()),
                "rms_row_err": float(err[:, 1].max())}
    failed = [n for n in readings if n in limits and readings[n] > limits[n]]
    assert failed, (readings, limits)
