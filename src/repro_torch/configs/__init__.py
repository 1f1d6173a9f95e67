"""Architecture configs of the port. Importing this package populates the
registry with the archs the port serves (dense decoders, the MoE family,
the VLM family and RWKV6)."""
from .base import ArchConfig
from .registry import REGISTRY, all_archs, get_arch

from . import (chatglm3_6b, kimi_k2_1t_a32b, llama3_405b,  # noqa: F401
               mistral_large_123b, moonshot_v1_16b_a3b, paligemma_3b,
               rwkv6_3b, stablelm_1_6b)

__all__ = ["ArchConfig", "REGISTRY", "all_archs", "get_arch"]
