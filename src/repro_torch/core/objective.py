"""RIBBON's two-regime objective function (paper Eq. 2).

                | (1/2) * R_sat(x) / T_qos                          if QoS violated
        f(x) =  |
                | 1/2 + (1/2) * (1 - sum_i p_i x_i / sum_i p_i m_i) otherwise

Any QoS-meeting configuration scores above any violating one (f >= 1/2
against f < 1/2); the violating regime rewards a higher satisfaction rate,
the meeting regime a lower cost.  Counterpart of ``repro/core/objective.py``.
"""

from __future__ import annotations

import torch


def ribbon_objective(qos_rate: float, cost: float, qos_target: float,
                     max_cost: float) -> float:
    """Scalar Eq. 2 (python floats, used by the orchestration loop)."""
    if qos_rate < qos_target:
        return 0.5 * qos_rate / qos_target
    return 0.5 + 0.5 * (1.0 - cost / max_cost)


def ribbon_objective_batch(qos_rates: torch.Tensor, costs: torch.Tensor,
                           qos_target, max_cost) -> torch.Tensor:
    """Vectorized Eq. 2 over tensors of (qos_rate, cost)."""
    violating = 0.5 * qos_rates / qos_target
    meeting = 0.5 + 0.5 * (1.0 - costs / max_cost)
    return torch.where(qos_rates < qos_target, violating, meeting)
