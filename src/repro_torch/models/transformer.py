"""Dense decoder-only LM over the engine's slot cache (port of the slot
entry points of ``repro.models.transformer``).

Parameters are plain nested dicts with the JAX package's names; the layer
stack is a Python list of per-layer dicts (the JAX ``(L, …)`` stack and
its ``lax.scan`` become a loop). The initializer is the port's own,
seeded by a ``torch.Generator``, at the same shapes.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .attention import attention_block
from .common import (apply_norm, dense, dtype_of, embed_init, embed_lookup,
                     he_init, init_norm)
from .ffn import apply_ffn, init_ffn


def _init_layer(gen, cfg, dtype, device):
    d, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "attn": {
            "wq": he_init(gen, (d, Hq * D), dtype, device),
            "wk": he_init(gen, (d, Hkv * D), dtype, device),
            "wv": he_init(gen, (d, Hkv * D), dtype, device),
            "wo": he_init(gen, (Hq * D, d), dtype, device, fan_in=Hq * D),
        },
        "ln1": init_norm(d, cfg.norm_type, dtype, device),
        "ln2": init_norm(d, cfg.norm_type, dtype, device),
        "ffn": init_ffn(gen, d, cfg.d_ff, cfg.ffn_type, dtype, device,
                        bias=cfg.bias),
    }


def init(cfg, seed: int = 0, device=None):
    """Seeded random parameters at the config's shapes, on ``device``
    (the card unless ``device="cpu"``)."""
    if cfg.family != "dense" or cfg.tie_embeddings:
        raise NotImplementedError(f"the port serves dense decoders with an "
                                  f"untied head, got {cfg.name!r}")
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {"embed": embed_init(gen, (cfg.vocab, cfg.d_model), dtype,
                                  device),
              "final_norm": init_norm(cfg.d_model, cfg.norm_type, dtype,
                                      device),
              "layers": [_init_layer(gen, cfg, dtype, device)
                         for _ in range(cfg.n_layers)]}
    params["lm_head"] = he_init(gen, (cfg.d_model, cfg.vocab), dtype, device)
    return params


def _forward_slots(params, cfg, cache, tokens, positions, slot_chunk=None,
                   verify: bool = False):
    x = embed_lookup(params["embed"], tokens)
    for layer, lp in enumerate(params["layers"]):
        h = apply_norm(x, lp["ln1"], cfg.norm_type)
        x = x + attention_block(lp["attn"], h, cfg, positions, cache, layer,
                                slot_chunk=slot_chunk, spec_verify=verify)
        h = apply_norm(x, lp["ln2"], cfg.norm_type)
        x = x + apply_ffn(lp["ffn"], h, cfg.ffn_type)
    if slot_chunk is not None and not verify:
        # only the chunk's last valid token feeds the head (the engine
        # samples the first generated token from it): (1, 1, V), not
        # (1, Sc, V)
        length = slot_chunk[2]
        x = x[:, length - 1:length]
    x = apply_norm(x, params["final_norm"], cfg.norm_type)
    return dense(x, params["lm_head"]).float()


def decode_step_slots(params, cfg, cache, tokens, pos):
    """One decode step over every slot of the cache (updated in place).
    tokens (N, 1) int; pos (N,) per-slot absolute positions. Returns
    logits (N, 1, V) fp32."""
    positions = pos.reshape(-1, 1).to(torch.int32)
    return _forward_slots(params, cfg, cache, tokens, positions)


def prefill_chunk_slots(params, cfg, cache, tokens, slot: int,
                        pos_start: int, length: int):
    """Chunked prefill of one slot straight into the cache (in place):
    tokens (1, Sc) at absolute positions [pos_start, pos_start + Sc),
    the first ``length`` of them real. Returns the logits (1, V) of the
    chunk's last valid token."""
    Sc = tokens.shape[1]
    positions = pos_start + torch.arange(Sc, dtype=torch.int32,
                                         device=tokens.device)
    logits = _forward_slots(params, cfg, cache, tokens, positions,
                            slot_chunk=(slot, pos_start, length))
    return logits[:, 0]


def verify_step_slots(params, cfg, cache, tokens, slot: int, pos_start: int,
                      length: int):
    """Speculative verify of one slot's draft window in one pass: tokens
    (1, Sq) = [last committed token, drafts...] at positions
    [pos_start, pos_start + Sq), the first ``length`` real. Like a prefill
    chunk, the window's K/V are written into the slot (in place), but
    every row attends the window through the storage round trip and
    every row's logits are kept, so row j's argmax is the token a plain
    decode step would produce after window token j. Returns logits
    (1, Sq, V) fp32; rows at >= length are padding."""
    Sq = tokens.shape[1]
    positions = pos_start + torch.arange(Sq, dtype=torch.int32,
                                         device=tokens.device)
    return _forward_slots(params, cfg, cache, tokens, positions,
                          slot_chunk=(slot, pos_start, length), verify=True)
