"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560, ssm_state=64, with a
SHARED attention block (32H) applied every 6 layers [arXiv:2411.15242].
Serve-time adaptation (DESIGN.md §4): the shared attention uses a sliding
window so long_500k decode is memory-bounded."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
    conv_kernel=4, ssm_chunk=256,
    attn_every=6, sliding_window=4096,
    rope_theta=1e4,
)
