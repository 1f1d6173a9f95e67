"""llama3-405b — GQA, 128k vocab [arXiv:2407.21783; unverified]"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256,
    rope_variant="full", rope_theta=5e5, ffn_type="swiglu",
    source="arXiv:2407.21783",
))
