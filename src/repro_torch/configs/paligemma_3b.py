"""paligemma-3b — SigLIP (stub) + gemma backbone, MQA kv=1
[arXiv:2407.07726; hf]. 256 image patch tokens prepended; the head is
tied to the embedding table."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257216,
    rope_variant="full", rope_theta=1e4, ffn_type="geglu",
    stub_frontend=True, n_prefix_embeds=256, tie_embeddings=True,
    source="arXiv:2407.07726",
))
