"""mamba2-130m [ssm]: 24L d_model=768 attention-free, ssm_state=128,
SSD (state-space duality) [arXiv:2405.21060]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
    conv_kernel=4, ssm_chunk=256,
)
