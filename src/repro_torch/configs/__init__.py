"""Architecture configs of the port. Importing this package populates the
registry with the archs the port runs (dense decoders, the MoE family,
the VLM family, RWKV6, the bert-tiny encoder, griffin and whisper)."""
from .base import ArchConfig
from .registry import REGISTRY, all_archs, get_arch

from . import (bert_tiny, chatglm3_6b, kimi_k2_1t_a32b,  # noqa: F401
               llama3_405b, mistral_large_123b, moonshot_v1_16b_a3b,
               paligemma_3b, recurrentgemma_9b, rwkv6_3b, stablelm_1_6b,
               whisper_tiny)

__all__ = ["ArchConfig", "REGISTRY", "all_archs", "get_arch"]
