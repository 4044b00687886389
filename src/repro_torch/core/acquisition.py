"""Expected Improvement acquisition over the enumerated integer lattice.

Paper §4: for each unexplored configuration, EI takes its GP mean and
variance and computes the expected improvement over the best explored one.
The acquisition respects the already-sampled cells and the active prune
set ℙ by masking both out before the argmax; ``torch.argmax`` returns the
first maximum, as the reference's ``jnp.argmax`` does.  Counterpart of
``repro/core/acquisition.py``.
"""

from __future__ import annotations

import math

import torch

from .gp import gp_posterior

_NEG = -1e30


def expected_improvement(mean: torch.Tensor, std: torch.Tensor,
                         best_y) -> torch.Tensor:
    """EI for maximization: E[max(f - best, 0)] under N(mean, std^2)."""
    std = torch.clamp(std, min=1e-9)
    z = (mean - best_y) / std
    cdf = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return (mean - best_y) * cdf + std * pdf


def select_next(mean, std, best_y, sampled_mask, pruned_mask):
    """Argmax of EI over configurations that are neither sampled nor pruned.

    Returns (index, masked EI).  If everything is masked the index points at
    the max over the blocked set (the caller detects exhaustion by count).
    """
    ei = expected_improvement(mean, std, best_y)
    masked_ei = torch.where(sampled_mask | pruned_mask, _NEG, ei)
    return torch.argmax(masked_ei), masked_ei


def select_next_cost_aware(mean, std, best_y, sampled_mask, pruned_mask,
                           costs, cost_exponent=1.0):
    """EI per dollar: weight EI by 1/price^gamma, so cheap configurations,
    which cost less to deploy for a measurement, are sampled first."""
    ei = expected_improvement(mean, std, best_y)
    weight = torch.pow(torch.clamp(costs, min=1e-9), -cost_exponent)
    masked = torch.where(sampled_mask | pruned_mask, _NEG, ei * weight)
    return torch.argmax(masked), masked


def select_batch(x_obs, y_obs, mask, lattice, denom, best_y, blocked,
                 weights, q: int):
    """Top-q selection with the constant-liar rule.

    Runs q BO iterations (GP refit, EI, masked argmax) in a Python loop of
    device operations.  After each pick the chosen lattice point is appended
    to the observation buffers with a "lie" of ``best_y``, so the refitted
    posterior collapses its variance there and the next pick moves away.

    x_obs/y_obs/mask: padded GP buffers with >= q free rows (caller clamps q).
    lattice:          (size, d) candidate configs (raw counts).
    blocked:          (size,) bool, True = sampled or pruned.
    weights:          (size,) EI multiplier (ones, or 1/cost^gamma).
    Returns (picks (q,) int64 lattice indices, scores (q,) masked EI at pick
    time, blocked' with the picks set).  A score <= _NEG/2 flags an
    exhausted pick the caller must drop.  The inputs are left unchanged.
    """
    lattice = lattice.to(x_obs.dtype)
    x_obs, y_obs, mask, blocked = (t.clone() for t in (x_obs, y_obs, mask,
                                                       blocked))
    picks = torch.zeros(q, dtype=torch.int64, device=x_obs.device)
    scores = torch.zeros(q, dtype=torch.float32, device=x_obs.device)
    for k in range(q):
        mean, std = gp_posterior(x_obs, y_obs, mask, lattice, denom)
        ei = expected_improvement(mean, std, best_y)
        masked = torch.where(blocked, _NEG, ei * weights)
        idx = torch.argmax(masked)
        picks[k] = idx
        scores[k] = masked[idx]
        blocked[idx] = True
        if k + 1 < q:
            # constant liar: pretend the pick was observed at the incumbent
            # value (the last pick's lie would feed no later pick)
            slot = torch.sum(mask).long()
            x_obs[slot] = lattice[idx]
            y_obs[slot] = best_y
            mask[slot] = 1.0
    return picks, scores, blocked
