"""Roofline terms on one NVIDIA H100, from the op walk's counts.

Counterpart of ``repro/roofline/analysis.py``, with this card's constants
in place of the TPU's.  NVIDIA H100 SXM5 80GB data sheet, dense rates
(no sparsity) at the card's full 700 W:

    989.4 TFLOP/s bf16 (tensor cores) · 67 TFLOP/s fp32 outside them
    3.35 TB/s HBM3 · NVLink 4 at 450 GB/s each direction (900 GB/s total)

A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs
slower under load.  Terms, per device (``op_walk.analyze`` counts what one
device runs):

    compute    = flops      / PEAK_FLOPS
    memory     = HBM bytes  / HBM_BW
    collective = wire bytes / LINK_BW

``count_params`` and ``model_flops`` are the reference's, line for line
(pure Python on the configuration).
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989.4e12        # bf16 dense, tensor cores, per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per direction, NVLink 4
# peak by the type of a product's operands: bf16 and fp16 on the tensor
# cores, fp32 outside them (TF32 off, as the port computes)
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float16": PEAK_FLOPS,
                       "float32": 67e12}

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


def collective_bytes(acc) -> dict[str, float]:
    """Operand bytes by collective kind that an ``op_walk.OpAccounting``
    recorded (zero of each kind on one card)."""
    return {k: acc.collective_operand_bytes.get(k, 0.0)
            for k in COLLECTIVE_OPS}


def typed_compute_s(flops_by_dtype: dict) -> float:
    """The compute term with each type's products at that type's peak
    (PEAK_FLOPS_BY_DTYPE; another type at PEAK_FLOPS)."""
    return sum(f / PEAK_FLOPS_BY_DTYPE.get(dt, PEAK_FLOPS)
               for dt, f in flops_by_dtype.items())


@dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_per_device: float
    n_chips: int

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the bound set by the dominant term that is the
        compute term (useful-compute efficiency upper bound)."""
        if self.bound_time_s == 0:
            return 0.0
        return self.compute_s / self.bound_time_s

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_per_device": self.collective_per_device,
            "n_chips": self.n_chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape_kind: str, n_tokens: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for training,
    2·N·D for inference forward."""
    n_params = count_params(cfg, active_only=True)
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n_params * n_tokens


def count_params(cfg, active_only: bool = False) -> float:
    """Analytical parameter count (active params only when requested)."""
    d, v, n_layers = cfg.d_model, cfg.vocab_size, cfg.n_layers
    total = 2 * v * d                      # embed + head
    if cfg.family == "ssm" or cfg.family == "hybrid":
        d_in = cfg.d_inner
        g, n = cfg.ssm_ngroups, cfg.ssm_state
        nh = cfg.ssm_nheads
        per = d * (2 * d_in + 2 * g * n + nh) + d_in * d \
            + cfg.conv_kernel * (d_in + 2 * g * n)
        n_mamba = n_layers
        total += n_mamba * per
        if cfg.family == "hybrid":
            h = cfg.n_heads * cfg.d_head
            kvd = cfg.n_kv_heads * cfg.d_head
            total += d * h + 2 * d * kvd + h * d + 3 * d * cfg.d_ff
        return total
    h = cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    if cfg.attention == "mla":
        attn = (d * cfg.q_lora_rank
                + cfg.q_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                + d * cfg.kv_lora_rank + d * cfg.qk_rope_dim
                + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * d)
    else:
        attn = d * h + 2 * d * kvd + h * d
    if cfg.is_moe:
        e_used = cfg.top_k if active_only else cfg.n_experts
        ff = 3 * d * cfg.expert_ff * e_used + d * cfg.n_experts  # + router
    else:
        ff = 3 * d * cfg.d_ff
    n_dec = n_layers
    total += n_dec * (attn + ff)
    if cfg.family == "encdec":
        total += cfg.n_encoder_layers * (attn + 2 * d * cfg.d_ff) \
            + n_layers * (d * h + 2 * d * kvd + h * d)   # cross attention
    return total
