"""The plain reference against the port's CPU path at ``cfg.reduced()``
sizes, and the benchmark's imports.

The port (``repro_torch``, float32 on the CPU: its kernels' plain
versions) prefills and decodes greedily through its own steps; the
reference runs once over the prompts and the served tokens, teacher
forced, and its logits at every served position must equal the port's
within float32 rounding.  The MoE layer is held at a capacity that drops
pairs, in the prefill's call and in each decode step's.  This test may
import both; the reference imports nothing of the port.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from portbench import reference
from portbench.reference.common import Precision, expert_capacity, moe
from portbench.weights import load_into_port, make

HERE = Path(__file__).resolve().parent


def _port_logits(cfg, w, prompts, steps):
    """The port's logits (B, steps + 1, V) at the positions it served from
    and the tokens (B, steps + 1) it served."""
    from repro_torch.launch import steps as entry
    from repro_torch.models.transformer import get_model
    api = get_model(cfg)
    model = api.init_params(None, torch.float32, "meta")
    load_into_port(model, w)
    cache, logits = entry.make_prefill_step(api, prompts.shape[1] + steps)(
        model, {"tokens": prompts})
    out = [logits[:, -1]]
    tok = out[0].argmax(-1).to(torch.int32)[:, None]
    served = [tok]
    for _ in range(steps):
        logits, cache = api.decode_step(model, cache, tok)
        out.append(logits[:, -1])
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        served.append(tok)
    return torch.stack(out, 1), torch.cat(served, 1)


def _case(name, **changes):
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(name).reduced(), **changes)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return cfg, fields


@pytest.mark.parametrize("name,kind,changes", [
    ("olmoe-1b-7b", "decoder", {}),
    ("olmoe-1b-7b", "decoder", {"moe_capacity_factor": 1.0}),
    ("zamba2-2.7b", "hybrid", {}),
])
def test_reference_agrees_with_the_port(name, kind, changes):
    cfg, arch = _case(name, **changes)
    ref = reference.load(kind)
    w = make(ref.params(arch), 2**40 + 11, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, arch["vocab_size"], (3, 16), generator=gen,
                            dtype=torch.int32)
    steps = 5
    port, served = _port_logits(cfg, {k: v.clone() for k, v in w.items()},
                                prompts, steps)
    tokens = torch.cat([prompts, served[:, :-1]], 1).long()
    h = ref.final_hidden(Precision("float32"), arch, lambda n: w[n], tokens,
                         prompts.shape[1], prompts.shape[1] - 1)
    theirs = h @ w["lm_head"]
    scale = float(theirs.abs().max())
    assert float((port - theirs).abs().max()) <= 1e-4 * scale


def test_moe_drops_past_capacity_per_call():
    """Three tokens all picking experts 0 and 1 (router columns that rank
    them first): a call of 3 tokens has capacity max(ceil(3*2/4*1), 2) = 2,
    so the third token's picks are dropped; in calls of one token each
    nothing is dropped."""
    assert expert_capacity(3, 2, 4, 1.0) == 2
    d = 4
    router = torch.zeros(d, 4)
    router[0, 0], router[0, 1] = 2.0, 1.0
    x = torch.ones(3, d)
    eye = torch.eye(d).expand(4, d, d)
    w1 = w3 = eye * 3.0
    w2 = eye
    prec = Precision("float32")
    one_call = moe(prec, x, torch.zeros(3, dtype=torch.long), router,
                   w1, w3, w2, 2, 1.0)
    per_token = moe(prec, x, torch.arange(3), router, w1, w3, w2, 2, 1.0)
    assert torch.equal(one_call[0], per_token[0])
    assert torch.equal(one_call[1], per_token[1])
    assert torch.equal(one_call[2], torch.zeros(d))
    assert per_token[2].abs().sum() > 0


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_a_reference_free_of_the_port(path):
    """By whole top-level name: nothing under portbench/ imports jax,
    jaxlib, flax or repro, and only the harness, which builds the system
    under test, and the tests import repro_torch: not the reference, the
    comparison, the counts, the traffic or the readers."""
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "repro"}
    if path.name != "harness.py" and not path.name.startswith("test_"):
        assert "repro_torch" not in found
