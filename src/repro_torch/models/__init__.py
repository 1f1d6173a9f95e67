"""Models of the port: the dense, MoE and VLM decoder over a plain KV
cache or the engine's slot cache (:mod:`.transformer`), RWKV6
(:mod:`.rwkv6`), the bert-tiny encoder (:mod:`.bert_tiny`), griffin
(:mod:`.griffin`) and whisper (:mod:`.whisper`). :func:`get_model` maps
a config's family to its module."""
from __future__ import annotations

from . import bert_tiny, griffin, rwkv6, transformer, whisper

#: the module of each family that is not the decoder's
_FAMILY_MODULES = {"ssm": rwkv6, "encoder": bert_tiny, "hybrid": griffin,
                   "audio": whisper}


def get_model(cfg):
    """The module implementing ``cfg``'s family (``transformer`` for
    dense, moe and vlm, ``rwkv6`` for ssm, ``bert_tiny`` for encoder,
    ``griffin`` for hybrid, ``whisper`` for audio)."""
    if cfg.family in transformer.FAMILIES:
        return transformer
    if cfg.family in _FAMILY_MODULES:
        return _FAMILY_MODULES[cfg.family]
    raise NotImplementedError(f"the {cfg.family!r} family ({cfg.name}) is "
                              f"not ported")


__all__ = ["bert_tiny", "get_model", "griffin", "rwkv6", "transformer",
           "whisper"]
