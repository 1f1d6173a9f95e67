"""stablelm-1.6b — MHA (kv=32) [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352,
    rope_variant="half", rope_theta=1e4, ffn_type="swiglu",
    source="hf:stabilityai/stablelm-2-1_6b",
))
