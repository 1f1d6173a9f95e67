"""Models of the port: the dense, MoE and VLM decoder over a plain KV
cache or the engine's slot cache (:mod:`.transformer`) and RWKV6
(:mod:`.rwkv6`).
:func:`get_model` maps a config's family to its module."""
from __future__ import annotations

from . import rwkv6, transformer


def get_model(cfg):
    """The module implementing ``cfg``'s family (``transformer`` for
    dense, moe and vlm, ``rwkv6`` for ssm); the other families are not
    ported."""
    if cfg.family in transformer.FAMILIES:
        return transformer
    if cfg.family == "ssm":
        return rwkv6
    raise NotImplementedError(f"the {cfg.family!r} family ({cfg.name}) is "
                              f"not ported")


__all__ = ["get_model", "rwkv6", "transformer"]
