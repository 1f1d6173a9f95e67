"""Architecture configs of the port. Importing this package populates the
registry with the dense archs the port serves."""
from .base import ArchConfig
from .registry import REGISTRY, all_archs, get_arch

from . import chatglm3_6b, llama3_405b, stablelm_1_6b  # noqa: F401

__all__ = ["ArchConfig", "REGISTRY", "all_archs", "get_arch"]
