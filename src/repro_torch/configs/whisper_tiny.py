"""whisper-tiny [audio enc-dec]: 4L enc + 4L dec, d_model=384 6H (kv=6)
d_ff=1536 vocab=51865; conv frame frontend is a STUB — input_specs()
provides precomputed frame embeddings (1500 frames) [arXiv:2212.04356]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    n_encoder_layers=4, encoder_seq=1500,
    qkv_bias=True, rope_theta=1e4,
)
