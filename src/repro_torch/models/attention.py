"""GQA attention (port of ``repro.models.attention``): the dense pass and
the chunked online-softmax form of ``attend`` with causal, window and
validity masks, the plain ``KVCache`` of the wave loop (a ring of
``window`` rows for griffin's local attention), and the attention
sub-layer over it or over the engine's slot cache, bidirectional
(whisper's encoder) or over an encoder's K/V (its cross-attention).

The JAX package writes this attention in jnp, not Pallas, so plain
PyTorch is its port; the slot-cache branches go through the port's
kernels (:mod:`repro_torch.engine.kvcache`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .common import apply_rope, dense

NEG_INF = -1e30


class KVCache(NamedTuple):
    """Per-layer-stack KV cache of the wave loop, updated in place by
    decode steps. ``slot_pos[t]`` records the absolute position stored
    in row t (-1 = empty or padding)."""
    k: torch.Tensor          # (L, B, T, Hkv, D)
    v: torch.Tensor          # (L, B, T, Hkv, D)
    slot_pos: torch.Tensor   # (L, T) int32, or (L, B, T) when positions
                             # are per-request (padded prefill)


def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """Boolean validity, always (B|1, S, T). kv_pos may hold -1 (empty
    ring rows, padding). q_pos (S,) or (B, S); kv_pos (T,) or (B, T)."""
    q = q_pos if q_pos.dim() == 2 else q_pos[None]          # (Bq, S)
    kv = kv_pos if kv_pos.dim() == 2 else kv_pos[None]      # (Bk, T)
    m = kv[:, None, :] >= 0
    if causal:
        m = m & (kv[:, None, :] <= q[:, :, None])
    if window is not None:
        m = m & (kv[:, None, :] > q[:, :, None] - window)
    return m


def _expand(t, G: int):
    """(B, c, Hkv, D) → (B, c, Hq, D): query head h reads kv head h // G."""
    return t if G == 1 else t.repeat_interleave(G, dim=2)


def _scores(qs, k):
    """q·k in fp32 (the JAX einsum's ``preferred_element_type``): the
    operands are cast up, so torch never rounds the sum to bf16."""
    return torch.einsum("bshd,bthd->bsht", qs.float(), k.float())


def attend(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
           kv_chunk: Optional[int] = None):
    """q: (B, S, Hq, D); k, v: (B, T, Hkv, D). Returns (B, S, Hq, D) in
    q's dtype. ``kv_chunk`` switches to the online-softmax scan over KV
    chunks; None does one dense pass. Masked scores are ``NEG_INF``, not
    -inf, so a query with no valid key (a left-pad row) stays finite."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qs = (q * (D ** -0.5)).to(q.dtype)

    if kv_chunk is None or T <= kv_chunk:
        s = _scores(qs, _expand(k, G))                       # (B, S, Hq, T)
        m = _mask(q_pos, kv_pos, causal, window)             # (B|1, S, T)
        s = torch.where(m[:, :, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bsht,bthd->bshd", p.float(), _expand(v, G).float())
        return o.to(q.dtype)

    if T % kv_chunk:
        raise ValueError(f"T={T} is not a multiple of kv_chunk={kv_chunk}")
    m_run = torch.full((B, S, Hq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, S, Hq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, Hq, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, T, kv_chunk):
        k_i = _expand(k[:, c0:c0 + kv_chunk], G)
        v_i = _expand(v[:, c0:c0 + kv_chunk], G)
        p_i = kv_pos[..., c0:c0 + kv_chunk]
        s = _scores(qs, k_i)                                 # (B, S, Hq, c)
        msk = _mask(q_pos, p_i, causal, window)
        s = torch.where(msk[:, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bsht,bthd->bshd", p.to(q.dtype).float(), v_i.float())
        m_run = m_new
    o = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return o.to(q.dtype)


def _cache_update(cache: KVCache, layer: int, k, v, positions):
    """Write one decode token's K/V into ``layer``'s ring row
    ``positions[0] % T`` in place (JAX's ``dynamic_update_slice``), with
    its position in ``slot_pos`` (shared (T,) or per-request (B, T));
    returns the layer's (k, v, kv_pos) for attention."""
    if k.shape[1] != 1:
        raise ValueError(f"a KVCache step takes one token, got {k.shape[1]}")
    ck, cv, sp = cache.k[layer], cache.v[layer], cache.slot_pos[layer]
    pos = positions.to(torch.int32)
    row = (pos[:1] % ck.shape[1]).long()
    ck.index_copy_(1, row, k.to(ck.dtype))
    cv.index_copy_(1, row, v.to(cv.dtype))
    if sp.dim() == 1:
        sp.index_copy_(0, row, pos[:1])
    else:
        sp.index_copy_(1, row, pos[:1].expand(sp.shape[0], 1))
    return ck.to(k.dtype), cv.to(v.dtype), sp


def attention_block(p, x, cfg, positions, cache=None, layer: int = 0, *,
                    causal: bool = True, window=None, kv_chunk=None,
                    cross_kv=None, want_kv=False, kv_pos_override=None,
                    slot_chunk=None, spec_verify: bool = False,
                    fused_attn: bool = True):
    """Projections + RoPE + (cache) + attention (causal unless
    ``causal=False``, within ``window`` positions, if given; ``kv_chunk``
    selects ``attend``'s online-softmax form) + output projection.

    p: {"wq","wk","wv","wo"(,biases)}; x: (B, S, d). ``cross_kv``: the
    (k, v, kv_pos) of encoder-decoder cross-attention, ``wk``/``wv`` (and
    their biases) already applied by the caller; only q (with ``bq``)
    and the output are projected here, and no cache is read. ``cache``:

    - None: prefill or a cache-free pass; queries attend this call's
      K/V at ``kv_pos_override`` ((B, S), -1 = pad) or ``positions``.
      ``want_kv`` also returns the post-RoPE (k, v).
    - a :class:`KVCache`: a decode step (S == 1, shared positions (1,));
      ``layer``'s ring row is written in place and attention reads the
      layer's whole cache.
    - the engine's :class:`~repro_torch.engine.kvcache.SlotKVCache`,
      updated in place at ``layer``. Decode (``slot_chunk=None``, S == 1):
      positions (N, 1); the new K/V are written (quantized in int8 mode)
      and attention reads the cache through the fused decode kernel,
      or, with ``fused_attn=False``, ``attend`` reads a full-precision
      copy of the layer's whole cache in the step's dtype (the
      materialize path, the fused kernel's oracle).
      Chunked prefill (``slot_chunk=(slot, pos_start, length)``, B == 1):
      positions (Sq,); the chunk attends the slot's earlier rows plus its
      own K/V, and its codes are written into rows [pos_start, +Sq).
      ``spec_verify`` (with ``slot_chunk``): the chunk is a speculative
      draft window and attends its own K/V through the cache's storage
      round trip, so each row scores what a plain decode step would.

    Returns (out, kv): kv is (k, v) with ``want_kv`` and no cache, else
    None.
    """
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(x, p["wq"], p.get("bq")).reshape(B, S, Hq, D)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_variant)
    kw = dict(causal=causal, window=window, kv_chunk=kv_chunk)
    if cross_kv is not None:
        k, v, kv_pos = cross_kv
        o = attend(q, k, v, positions, kv_pos, **kw)
        return dense(o.reshape(B, S, Hq * D), p["wo"], p.get("bo")), None
    k = dense(x, p["wk"], p.get("bk")).reshape(B, S, Hkv, D)
    v = dense(x, p["wv"], p.get("bv")).reshape(B, S, Hkv, D)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_variant)
    kv = None
    if cache is None:
        kv_pos = positions if kv_pos_override is None else kv_pos_override
        if want_kv:
            kv = (k, v)
        o = attend(q, k, v, positions, kv_pos, **kw)
    elif isinstance(cache, KVCache):
        ck, cv, kv_pos = _cache_update(cache, layer, k, v, positions)
        o = attend(q, ck, cv, positions, kv_pos, **kw)
    else:
        if not causal:
            raise NotImplementedError("slot-cache attention is causal")
        o = _slot_attention(cache, layer, q, k, v, positions, slot_chunk,
                            spec_verify, window, fused_attn)
    return dense(o.reshape(B, S, Hq * D), p["wo"], p.get("bo")), kv


def _slot_attention(cache, layer, q, k, v, positions, slot_chunk,
                    spec_verify, window, fused_attn=True):
    """The engine's slot-cache branches of :func:`attention_block`."""
    from ..engine.kvcache import (fused_slot_attention, slot_chunk_prefill,
                                  slot_layer_update, slot_layer_write)
    if window is not None:
        raise NotImplementedError("slot-cache attention takes no window")
    B, S = q.shape[:2]
    if slot_chunk is not None:
        if B != 1:
            raise ValueError(f"chunked prefill runs one slot, got B={B}")
        slot, pos_start, length = slot_chunk
        return slot_chunk_prefill(cache, layer, q[0], k[0], v[0], slot,
                                  pos_start, length, verify=spec_verify)[None]
    if S == 1 and not fused_attn:
        kf, vf, kv_pos = slot_layer_update(cache, layer, k, v, positions)
        return attend(q, kf, vf, positions, kv_pos)
    if S == 1:
        slot_layer_write(cache, layer, k, v, positions)
        return fused_slot_attention(cache, layer, q[:, 0],
                                    positions[:, 0])[:, None]
    raise NotImplementedError("slot-cache attention takes one decode "
                              "token per slot or one prefill chunk")
