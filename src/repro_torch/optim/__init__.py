"""Optimizers of the port: AdamW (:mod:`.adamw`)."""
from . import adamw
from .adamw import OptConfig, OptState

__all__ = ["OptConfig", "OptState", "adamw"]
