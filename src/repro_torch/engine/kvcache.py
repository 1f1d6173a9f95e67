"""Slot-indexed KV cache of the continuous-batching engine (port of
``repro.engine.kvcache``).

Same layout and dtypes as the JAX package: ``k``/``v`` (L, N, T, Hkv, D)
— N fixed slots, T = max sequence length — with ``kv_pos`` (L, N, T)
int32 recording the absolute position at each row (-1 = empty). In int8
mode every written K/V head vector is split into ``qchunks`` contiguous
sub-channel chunks quantized with their own dynamic range (SplitQuant
§4.2); per-entry fp32 ``{k,v}_{scale,zero}`` (L, N, T, Hkv, C) start at
scale 1 / zero 0 so unwritten rows dequantize to a finite 0.

Where the JAX package donates the cache to a jitted step and gets a new
one back, the port preallocates it once and updates it in place.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..kernels.decode_attention import decode_attention
from ..kernels.prefill_attention import prefill_attention, quantize_kv

__all__ = ["SlotKVCache", "init_slot_cache", "quantize_kv",
           "slot_layer_write", "fused_slot_attention", "slot_chunk_prefill",
           "clear_slot"]


@dataclasses.dataclass
class SlotKVCache:
    """mode="fp": fp32 k/v (the JAX engine's default storage), scales are
    zero-size placeholders (L, N, T, Hkv, 0). mode="int8": int8 codes +
    per-entry scales."""

    k: torch.Tensor
    v: torch.Tensor
    kv_pos: torch.Tensor          # (L, N, T) int32, -1 = empty
    k_scale: torch.Tensor
    k_zero: torch.Tensor
    v_scale: torch.Tensor
    v_zero: torch.Tensor
    mode: str = "fp"
    qchunks: int = 4

    @property
    def n_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.kv_pos, self.k_scale,
                             self.k_zero, self.v_scale, self.v_zero))


def init_slot_cache(cfg, n_slots: int, max_len: int, *, mode: str = "fp",
                    qchunks: int = 4, device=None) -> SlotKVCache:
    """Preallocate the engine cache for a dense config on ``device`` (the
    card unless ``device="cpu"``)."""
    device = resolve_device(device)
    if mode not in ("fp", "int8"):
        raise ValueError(f"unknown KV cache mode {mode!r}")
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if mode == "int8" and D % qchunks:
        raise ValueError(f"head_dim {D} not divisible by qchunks {qchunks}")
    shape = (L, n_slots, max_len, Hkv, D)
    C = qchunks if mode == "int8" else 0
    kv_dtype = torch.int8 if mode == "int8" else torch.float32
    sshape = (L, n_slots, max_len, Hkv, C)
    f32 = dict(dtype=torch.float32, device=device)
    return SlotKVCache(
        k=torch.zeros(shape, dtype=kv_dtype, device=device),
        v=torch.zeros(shape, dtype=kv_dtype, device=device),
        kv_pos=torch.full((L, n_slots, max_len), -1, dtype=torch.int32,
                          device=device),
        k_scale=torch.ones(sshape, **f32), k_zero=torch.zeros(sshape, **f32),
        v_scale=torch.ones(sshape, **f32), v_zero=torch.zeros(sshape, **f32),
        mode=mode, qchunks=qchunks)


def slot_layer_write(cache: SlotKVCache, layer: int, k_new, v_new,
                     positions) -> None:
    """One decode step's cache write for one layer, in place: quantize
    (int8 mode) and store each slot's new token at row positions % T.
    k_new/v_new (N, 1, Hkv, D) post-RoPE; positions (N, 1)."""
    N, T = cache.n_slots, cache.max_len
    pos = positions[:, 0].to(torch.int32)
    n_idx = torch.arange(N, device=pos.device)
    t_idx = (pos % T).long()
    cache.kv_pos[layer, n_idx, t_idx] = pos
    if cache.mode == "int8":
        qk, ks, kz = quantize_kv(k_new[:, 0], cache.qchunks)
        qv, vs, vz = quantize_kv(v_new[:, 0], cache.qchunks)
        for buf, val in ((cache.k, qk), (cache.v, qv), (cache.k_scale, ks),
                         (cache.k_zero, kz), (cache.v_scale, vs),
                         (cache.v_zero, vz)):
            buf[layer, n_idx, t_idx] = val
    else:
        cache.k[layer, n_idx, t_idx] = k_new[:, 0].to(cache.k.dtype)
        cache.v[layer, n_idx, t_idx] = v_new[:, 0].to(cache.v.dtype)


def fused_slot_attention(cache: SlotKVCache, layer: int, q, q_pos):
    """Decode attention for one layer straight off the (possibly INT8)
    cache, after :func:`slot_layer_write`. q (N, Hq, D); q_pos (N,).
    Returns (N, Hq, D)."""
    if cache.mode == "int8":
        return decode_attention(q, cache.k[layer], cache.v[layer],
                                cache.kv_pos[layer], q_pos,
                                cache.k_scale[layer], cache.k_zero[layer],
                                cache.v_scale[layer], cache.v_zero[layer])
    return decode_attention(q, cache.k[layer], cache.v[layer],
                            cache.kv_pos[layer], q_pos)


def slot_chunk_prefill(cache: SlotKVCache, layer: int, q, k_new, v_new,
                       slot: int, pos_start: int, length: int):
    """One chunked-prefill step for one layer and one slot: fused
    attention over the slot's earlier rows + the chunk's own K/V, then
    the chunk (codes in int8 mode) is written into rows
    [pos_start, pos_start + Sq) of the slot, in place. Only the first
    ``length`` rows become visible; the padded tail is marked -1, and
    rows at or past max_len are dropped (a bucket-padded last chunk may
    stick out past the cache). Returns o (Sq, Hq, D)."""
    Sq = q.shape[0]
    T = cache.max_len
    if cache.mode == "int8":
        o, (qk, qv, ks, kz, vs, vz) = prefill_attention(
            q, k_new, v_new, cache.k[layer, slot], cache.v[layer, slot],
            cache.kv_pos[layer, slot], pos_start, length,
            cache.k_scale[layer, slot], cache.k_zero[layer, slot],
            cache.v_scale[layer, slot], cache.v_zero[layer, slot])
        rows = {"k": qk, "v": qv, "k_scale": ks, "k_zero": kz,
                "v_scale": vs, "v_zero": vz}
    else:
        o, _ = prefill_attention(q, k_new, v_new, cache.k[layer, slot],
                                 cache.v[layer, slot],
                                 cache.kv_pos[layer, slot], pos_start, length)
        rows = {"k": k_new, "v": v_new}
    keep = min(Sq, T - pos_start)            # rows < max_len; drop the rest
    end = pos_start + keep
    for name, val in rows.items():
        buf = getattr(cache, name)
        buf[layer, slot, pos_start:end] = val[:keep].to(buf.dtype)
    posv = torch.arange(pos_start, end, dtype=torch.int32, device=q.device)
    posv[length:] = -1
    cache.kv_pos[layer, slot, pos_start:end] = posv
    return o


def clear_slot(cache: SlotKVCache, slot: int) -> None:
    """Mark a slot empty in every layer (retire). The K/V bytes stay:
    kv_pos = -1 masks them and the next prefill overwrites the rows."""
    cache.kv_pos[:, slot] = -1
