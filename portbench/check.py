"""The comparison that decides ``correct``.

After the window, with the port's state freed, the plain reference
(``reference/<kind>.py``, float32, TF32 off) runs once over each sampled
request: its prompts followed by the tokens the port served, teacher
forced, the MoE capacity counted per call as the port served them.  At the
position before each served token it reads the reference's logits: the
numbers compared are the widest and the mean gap by which a served token's
logit lies below the reference's best there (greedy decoding serves the
argmax, so a sound bf16 run shows gaps only where its rounding flips a
near-tie), and the error of the port's whole logits row at each prompt's
last position against the reference's row, over that row's standard
deviation: the widest entry's (``max_row_err``) and the root mean square
(``rms_row_err``), each of the worst row, and the root mean square of the
median row (``mid_row_err``), which a few rows moved by a flipped expert
pick leave alone.  The rows catch errors that leave the argmax where it
was.

The control is the same reference computed one precision lower (fp8 e4m3
on every linear layer's inputs), put in the port's place: at the same
positions it reads the gap of the token the control puts first, and its
own logits rows.  Only ``calibrate.py`` runs it.
"""

from __future__ import annotations

import torch

from . import reference
from .reference.common import Precision
from .weights import make

HEAD_ROWS = 2048
# the numbers a cell file may hold a limit for, besides ``min_tokens``
COMPARED = ("max_logit_gap", "mean_logit_gap", "max_row_err", "rms_row_err",
            "mid_row_err")


def _weights(cfg: dict, seed: int, device):
    """name -> float32 tensor, drawn again from the seed as the run drew
    them (the port's tensors are gone by now)."""
    ref = reference.load(cfg["reference"])
    served = getattr(torch, cfg["precision"])
    raw = make(ref.params(cfg["arch"]), seed, served, device)

    def w(name: str) -> torch.Tensor:
        return raw[name].float()
    return ref, w


def _hidden(ref, cfg, w, prec, prompts, served):
    """Final normed hidden states (B, G, D) before each of the G served
    tokens of each of the B prompts."""
    length = prompts.shape[1]
    tokens = torch.cat([prompts, served[:, :-1]], dim=1).long()
    return ref.final_hidden(prec, cfg["arch"], w, tokens, length, length - 1)


def _gaps(w, hidden, choose) -> torch.Tensor:
    """For each row of hidden (N, D): the reference's best logit minus its
    logit at the token ``choose(rows, block)`` names."""
    head = w("lm_head")
    out = []
    for i in range(0, hidden.shape[0], HEAD_ROWS):
        blk = hidden[i:i + HEAD_ROWS]
        logits = blk @ head
        pick = choose(i, blk)
        out.append(logits.max(dim=-1).values
                   - logits.gather(1, pick[:, None])[:, 0])
    return torch.cat(out)


def row_errors(rows: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """rows and ref (B, V) -> (B, 2): the widest and the root mean square
    |rows - ref| of each row, over the standard deviation of ref's row."""
    err = (rows.float() - ref).abs()
    scale = ref.std(dim=-1)
    return torch.stack([err.amax(dim=-1) / scale,
                        err.pow(2).mean(dim=-1).sqrt() / scale], dim=-1)


class Judge:
    """The reference of one run: ``gaps`` of the port's served tokens, its
    logits rows and, for the calibration, the control's picks and rows."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg = cfg
        self.ref, self.w = _weights(cfg, seed, device)

    def gaps(self, prompts, served, control: bool = False):
        """prompts (B, L), served (B, G) on the device -> {"gaps": of the
        served tokens (B·G,), "rows": the reference's logits (B, V) at the
        last prompt position}; with ``control`` also "control_gaps", of
        the control's picks, and "control_rows", its logits there."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                h = _hidden(self.ref, self.cfg, self.w, Precision("float32"),
                            prompts, served)
                h = h.reshape(-1, h.shape[-1])
                flat = served.reshape(-1).long()
                head = self.w("lm_head")
                first = torch.arange(0, h.shape[0], served.shape[1],
                                     device=h.device)
                out = {"gaps": _gaps(self.w, h,
                                     lambda i, b: flat[i:i + b.shape[0]]),
                       "rows": h[first] @ head}
                if not control:
                    return out
                low = Precision("fp8")
                hc = _hidden(self.ref, self.cfg, self.w, low, prompts,
                             served).reshape(-1, h.shape[-1])
                out["control_gaps"] = _gaps(
                    self.w, h, lambda i, b: low.linear(
                        hc[i:i + b.shape[0]], head).argmax(dim=-1))
                out["control_rows"] = low.linear(hc[first], head)
                return out
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
