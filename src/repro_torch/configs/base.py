"""Architecture configuration schema for the serving model zoo.

One frozen dataclass describes every assigned architecture family: dense GQA
transformers, MLA, sliding-window, MoE, SSM (Mamba2/SSD), hybrid, encoder-
decoder (Whisper), and stub-frontend VLMs.  Full configs are exercised only by
the dry-run (ShapeDtypeStruct lowering); ``reduced()`` yields a CPU-runnable
smoke config of the same family.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free layers
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # defaults to d_model // n_heads

    # attention options
    attention: str = "gqa"      # gqa | mla | none
    qkv_bias: bool = False
    sliding_window: int = 0     # 0 = full attention
    rope_theta: float = 1e4

    # MLA (latent attention) options
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE options
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0           # per-expert hidden dim (d_ff used if 0)
    moe_capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD) options
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    conv_kernel: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style): one shared attention block every `attn_every`
    # mamba layers
    attn_every: int = 0

    # encoder-decoder (whisper-style)
    n_encoder_layers: int = 0
    encoder_seq: int = 0        # precomputed frame embeddings (stub frontend)

    # VLM (stub frontend): precomputed patch embeddings prepended to text
    n_patches: int = 0

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # distribution hints
    fsdp: bool = False          # additionally shard big weights over 'data'
    remat: bool = True

    # ---- perf-variant knobs (EXPERIMENTS.md §Perf; defaults = the
    # paper-faithful/naive baseline) ----
    # shard decode KV/latent caches over the *sequence* (window) dim on the
    # model axis: partial-softmax decode with small combine collectives
    # instead of per-layer full-cache all-gathers
    seq_parallel_kv: bool = False
    # MoE dispatch-buffer sharding when n_experts doesn't divide the model
    # axis: "none" (naive; buffer replicated → all-reduce), or "capacity"
    # (shard the capacity dim → reduce-scatter + sharded expert GEMMs)
    moe_buffer_shard: str = "none"
    # int8 KV cache with per-(token, head) scales: halves decode cache
    # traffic (GQA decoder family; beyond-paper)
    kv_quant_int8: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.d_head == 0 and self.n_heads > 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def supports_long_context(self) -> bool:
        """sub-quadratic attention → long_500k cell runs (see DESIGN.md)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def expert_ff(self) -> int:
        return self.d_expert if self.d_expert else self.d_ff

    def reduced(self) -> "ArchConfig":
        """Smoke-test configuration: same family/topology, tiny sizes."""
        updates = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else
                         max(2, self.attn_every)),
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_head=16 if self.n_heads else 0,
            d_ff=128,
            vocab_size=256,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_expert=32 if self.n_experts else 0,
            # dropless at smoke scale so decode ≡ forward exactly
            moe_capacity_factor=8.0,
            q_lora_rank=24 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            # deliberately != nope+rope so value-dim bugs surface at smoke scale
            v_head_dim=24 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=16 if self.encoder_seq else 0,
            n_patches=8 if self.n_patches else 0,
            fsdp=False,
        )
        if self.attn_every:
            updates["n_layers"] = 4
        return dataclasses.replace(self, **updates)
