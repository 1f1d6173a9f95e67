"""Architecture registry of the port."""
from __future__ import annotations

from .base import ArchConfig

REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    return REGISTRY[name]


def all_archs():
    return dict(REGISTRY)
