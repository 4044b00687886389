"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864,
vocab=151655 (Qwen2-0.5B LM backbone); InternViT frontend is a STUB —
input_specs() provides precomputed patch embeddings [arXiv:2404.16821]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655,
    n_patches=256, qkv_bias=True, rope_theta=1e6,
)
