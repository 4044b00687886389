"""Plain PyTorch versions of the port's kernels.

Each function here computes what its kernel computes, in the same order of
operations, so the CUDA kernel can be held against it on the card and the
CPU path can use it.  Counterpart of ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch


def embedding_bag_ref(indices: torch.Tensor, table: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """indices (n_bags, bag) → (n_bags, D) sums of table rows.

    Lookups are added in order, j = 0 .. bag-1, from zero, in float32
    (product and sum rounded separately when weighted), and the sum is cast
    to the table's type once.  The JAX reference accumulates in the table's
    type, so the two agree bit for bit in float32 and differ by bf16
    rounding in bf16.
    """
    n_bags, bag = indices.shape
    rows = table.index_select(0, indices.reshape(-1).long())
    rows = rows.reshape(n_bags, bag, table.shape[1]).float()
    out = torch.zeros(n_bags, table.shape[1], dtype=torch.float32,
                      device=table.device)
    for j in range(bag):
        row = rows[:, j]
        out += row if weights is None else row * weights[:, j, None]
    return out.to(table.dtype)


MASKED = -1e30   # the score of a masked entry, as in the reference


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, KH, D) → (B, S, H, D), query head h
    reading KV head h // (H // KH).

    The full (S, T) score matrix in float32 (from float32 copies of q and
    k, as the kernel computes), scaled, masked to -1e30 by the causal and
    window masks built from indices (query i sees key j iff j <= i when
    causal and i - j < window when window > 0), a float32 softmax, the
    probabilities cast to v's type and multiplied by v.  The reference's
    ``flash_attention_ref`` on the kernel's (B, S, H, D) layout instead of
    its collapsed (B·H, S, D).
    """
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, s, kh, h // kh, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    scores = torch.where(mask, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor, *,
                         scale: float | None = None) -> torch.Tensor:
    """q (B, 1, H, D); k, v (B, T, KH, D); pos (T,) → (B, 1, H, D).

    Slot j counts iff ``pos[j] >= 0``; empty slots score -1e30.  Float32
    scores and softmax, probabilities cast to v's type.  The reference's
    ``decode_attention_ref`` on the kernel's layouts instead of its
    collapsed (B·KH, G, D) and (B·KH, T, D).
    """
    b, _, h, d = q.shape
    kh = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, kh, h // kh, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    scores = torch.where(pos >= 0, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v)
    return out.reshape(b, 1, h, d)
