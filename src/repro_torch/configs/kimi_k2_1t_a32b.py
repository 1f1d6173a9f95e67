"""kimi-k2-1t-a32b — trillion-param MoE, 384e top-8 [arXiv:2501.kimi2;
unverified]. head_dim 7168/64 = 112 (GQA 64/8: the JAX config's
approximation of the attention, not checked against the published
model); on one card the port serves it at full width and 5 of its 61
layers (``launch.serve.kimi_smoke_workload``)."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, n_shared_experts=1, first_k_dense=1,
    dense_d_ff=18432, capacity_factor=1.25,
    rope_variant="full", rope_theta=5e4, ffn_type="swiglu",
    source="arXiv:2501.kimi2",
))
