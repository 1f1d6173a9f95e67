"""Architecture configs of the port. Importing this package populates the
registry with the archs the port serves (dense decoders and RWKV6)."""
from .base import ArchConfig
from .registry import REGISTRY, all_archs, get_arch

from . import (chatglm3_6b, llama3_405b, mistral_large_123b,  # noqa: F401
               rwkv6_3b, stablelm_1_6b)

__all__ = ["ArchConfig", "REGISTRY", "all_archs", "get_arch"]
