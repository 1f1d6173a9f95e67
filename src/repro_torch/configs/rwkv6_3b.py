"""rwkv6-3b (Finch) — attention-free, data-dependent decay
[arXiv:2404.05892; hf]. 40 heads × 64 head_dim."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab=65536,
    rwkv_head_dim=64, rope_variant="none",
    source="arXiv:2404.05892",
))
