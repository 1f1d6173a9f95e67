"""chatglm3-6b — RoPE 2d (half-rotary), GQA kv=2 [arXiv:2406.12793; hf]"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024,
    rope_variant="half", rope_theta=1e4, ffn_type="swiglu", bias=False,
    source="arXiv:2406.12793",
))
