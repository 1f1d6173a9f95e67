"""whisper-tiny — enc-dec, conv frontend stub [arXiv:2212.04356;
unverified]. 4 encoder + 4 decoder layers, learned positions, LayerNorm."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    n_enc_layers=4, enc_seq=1500,
    rope_variant="none", norm_type="layer", ffn_type="gelu", bias=True,
    stub_frontend=True, tie_embeddings=True,
    source="arXiv:2212.04356",
))
