"""Attention sub-layer over the engine's slot cache (port of the two
slot-cache branches of ``repro.models.attention.attention_block``): the
fused decode step and the chunked prefill of one slot."""
from __future__ import annotations

from .common import apply_rope, dense


def attention_block(p, x, cfg, positions, cache, layer: int, *,
                    slot_chunk=None, spec_verify: bool = False):
    """Projections + RoPE + slot-cache attention + output projection.

    p: {"wq","wk","wv","wo"(,biases)}; x: (B, S, d); ``cache`` is the
    engine's :class:`~repro_torch.engine.kvcache.SlotKVCache`, updated in
    place at ``layer``.

    Decode (``slot_chunk=None``, S == 1): positions (N, 1); the new K/V
    are written (quantized in int8 mode) and attention reads the cache
    through the fused decode kernel.
    Chunked prefill (``slot_chunk=(slot, pos_start, length)``, B == 1):
    positions (Sq,); the chunk attends the slot's earlier rows plus its
    own K/V, and its codes are written into rows [pos_start, +Sq).
    ``spec_verify`` (with ``slot_chunk``): the chunk is a speculative
    draft window and attends its own K/V through the cache's storage
    round trip, so each row scores what a plain decode step would.
    """
    from ..engine.kvcache import (fused_slot_attention, slot_chunk_prefill,
                                  slot_layer_write)
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(x, p["wq"], p.get("bq")).reshape(B, S, Hq, D)
    k = dense(x, p["wk"], p.get("bk")).reshape(B, S, Hkv, D)
    v = dense(x, p["wv"], p.get("bv")).reshape(B, S, Hkv, D)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_variant)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_variant)
    if slot_chunk is not None:
        if B != 1:
            raise ValueError(f"chunked prefill runs one slot, got B={B}")
        slot, pos_start, length = slot_chunk
        o = slot_chunk_prefill(cache, layer, q[0], k[0], v[0], slot,
                               pos_start, length, verify=spec_verify)[None]
    elif S == 1:
        slot_layer_write(cache, layer, k, v, positions)
        o = fused_slot_attention(cache, layer, q[:, 0],
                                 positions[:, 0])[:, None]
    else:
        raise NotImplementedError("slot-cache attention takes one decode "
                                  "token per slot or one prefill chunk")
    return dense(o.reshape(B, S, Hq * D), p["wo"], p.get("bo"))
