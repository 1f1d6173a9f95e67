"""PyTorch/CUDA port of the SplitQuant serving stack (the JAX package
``repro`` is the reference).

Module names mirror ``repro`` so each counterpart is easy to find. The
package imports ``torch`` and numpy only: never ``jax`` and nothing from
``repro``. Entry points run on the CUDA card unless the caller asks for
the CPU explicitly (``device="cpu"``); with no card and no explicit CPU
request they raise (:func:`resolve_device`).
"""
from __future__ import annotations

from .device import resolve_device

__all__ = ["resolve_device"]
