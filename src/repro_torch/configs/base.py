"""Architecture configuration schema (a copy of ``repro.configs.base``:
the port imports nothing from the JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | ssm | hybrid | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25

    # --- attention / positional ---
    rope_variant: str = "full"       # full | half (GLM 2d-RoPE) | none | learned
    rope_theta: float = 1e4
    window: Optional[int] = None
    head_dim_override: int = 0

    # --- ffn ---
    ffn_type: str = "swiglu"         # swiglu | geglu | gelu

    # --- hybrid (Griffin / RecurrentGemma) ---
    block_pattern: Tuple[str, ...] = ()
    conv_width: int = 4
    lru_width: int = 0

    # --- ssm (RWKV6) ---
    rwkv_head_dim: int = 64

    # --- encoder-decoder (Whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500

    # --- modality frontend stubs (vlm / audio) ---
    stub_frontend: bool = False
    n_prefix_embeds: int = 0

    # --- misc ---
    tie_embeddings: bool = False
    norm_type: str = "rms"           # rms | layer
    param_dtype: str = "bfloat16"
    bias: bool = False
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.head_dim_override:
            return self.head_dim_override
        return self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (same rule as the JAX
        package, so both name the same reduced shapes)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 * max(1, len(self.block_pattern) or 1)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            d_ff=256,
            dense_d_ff=256 if self.dense_d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            first_k_dense=min(self.first_k_dense, 1),
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=32,
            n_prefix_embeds=min(self.n_prefix_embeds, 8),
            lru_width=128 if self.lru_width else 0,
            head_dim_override=32 if self.head_dim_override else 0,
            rwkv_head_dim=32,
            window=min(self.window, 16) if self.window else None,
            param_dtype="float32",
        )
