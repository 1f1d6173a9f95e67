"""Models of the port: the dense, MoE and VLM decoder over a plain KV
cache or the engine's slot cache (:mod:`.transformer`), RWKV6
(:mod:`.rwkv6`) and the bert-tiny encoder (:mod:`.bert_tiny`).
:func:`get_model` maps a config's family to its module."""
from __future__ import annotations

from . import bert_tiny, rwkv6, transformer


def get_model(cfg):
    """The module implementing ``cfg``'s family (``transformer`` for
    dense, moe and vlm, ``rwkv6`` for ssm, ``bert_tiny`` for encoder);
    the audio and hybrid families are not ported."""
    if cfg.family in transformer.FAMILIES:
        return transformer
    if cfg.family == "ssm":
        return rwkv6
    if cfg.family == "encoder":
        return bert_tiny
    raise NotImplementedError(f"the {cfg.family!r} family ({cfg.name}) is "
                              f"not ported")


__all__ = ["bert_tiny", "get_model", "rwkv6", "transformer"]
