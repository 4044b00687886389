"""Step builders: prefill and greedy decode, the serving steps.

Counterpart of ``repro/launch/steps.py`` (``make_prefill_step`` :75,
``make_decode_step`` :82).  Training steps are not ported (ROADMAP A-15f).
"""

from __future__ import annotations

import torch

from ..models.transformer import ModelApi


def make_prefill_step(api: ModelApi, max_len: int):
    def prefill_step(params, batch: dict):
        """batch {"tokens": (B, S)[, "extra"]} → (cache, last logits)."""
        return api.prefill(params, batch["tokens"], max_len,
                           batch.get("extra"))
    return prefill_step


def make_decode_step(api: ModelApi):
    def serve_step(params, cache: dict, tokens: torch.Tensor):
        """One new token for every sequence against the standing cache:
        returns the greedy next tokens (B, 1) int32 and the cache (updated
        in place)."""
        logits, cache = api.decode_step(params, cache, tokens)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], cache
    return serve_step
