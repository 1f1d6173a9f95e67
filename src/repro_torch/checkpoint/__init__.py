"""Checkpoints of the port, in the JAX package's on-disk format."""
from . import ckpt

__all__ = ["ckpt"]
