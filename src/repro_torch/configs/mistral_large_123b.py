"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab=32768,
    rope_variant="full", rope_theta=1e6, ffn_type="swiglu",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
))
