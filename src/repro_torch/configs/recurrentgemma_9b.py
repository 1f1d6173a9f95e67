"""recurrentgemma-9b (Griffin) — RG-LRU + local attn 1:2, MQA kv=1,
window 2048 [arXiv:2402.19427; unverified]. 38 layers = 12×(rec,rec,attn)
groups + 2 trailing recurrent layers."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000,
    window=2048, block_pattern=("rec", "rec", "attn"), conv_width=4,
    lru_width=4096, rope_variant="full", rope_theta=1e4, ffn_type="geglu",
    source="arXiv:2402.19427",
))
