"""moonshot-v1-16b-a3b (Moonlight) — MoE 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]

A copy of the JAX package's config: its depth (48 layers) and attention
(MHA, 16 heads of 128) are that config's and are not checked here
against the published one."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840,
    n_experts=64, top_k=6, n_shared_experts=2, first_k_dense=1,
    dense_d_ff=11264, capacity_factor=1.25,
    rope_variant="full", rope_theta=5e4, ffn_type="swiglu",
    source="hf:moonshotai/Moonlight-16B-A3B",
))
