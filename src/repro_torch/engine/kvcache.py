"""Slot-indexed KV cache of the continuous-batching engine (port of
``repro.engine.kvcache``).

Same layout and dtypes as the JAX package: ``k``/``v`` (L, N, T, Hkv, D)
— N fixed slots, T = max sequence length — with ``kv_pos`` (L, N, T)
int32 recording the absolute position at each row (-1 = empty). In int8
mode every written K/V head vector is split into ``qchunks`` contiguous
sub-channel chunks quantized with their own dynamic range (SplitQuant
§4.2); per-entry fp32 ``{k,v}_{scale,zero}`` (L, N, T, Hkv, C) start at
scale 1 / zero 0 so unwritten rows dequantize to a finite 0. With static
scales from a calibration recipe (``kv_scales=``) they are per-layer
constants (L, 1, 1, Hkv, C) instead: writes quantize with them (no
min/max reduce) and never write a scale. In fp mode the rows are stored
in the cache's float type, fp32 (the JAX engine's default), bf16 or
float16 (its ``kv_dtype="bfloat16"`` and ``"float16"``): writes cast to
it, reads widen it to fp32.

Where the JAX package donates the cache to a jitted step and gets a new
one back, the port preallocates it once and updates it in place: every
write of a layer (a decode step's tokens, a prefill chunk, a verify
window) is one :func:`~repro_torch.kernels.prefill_attention.write_kv_rows`
launch on the card, which quantizes K and V and stores codes, scales and
``kv_pos`` into the slot rows itself. A one-shot prefill
(:func:`write_prefill`) is one such launch a layer.

:func:`materialize_layer` and :func:`slot_layer_update` are the JAX
package's materialize read path (``fused_attn=False``): a full-precision
copy of a layer's whole cache, attended in plain PyTorch. It is the
oracle the fused decode kernel is held to, and JAX computes it in jnp.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.decode_attention import decode_attention, dequant_chunk
from ..kernels.prefill_attention import (prefill_attention, quantize_kv,
                                         quantize_kv_static, write_kv_rows)

__all__ = ["SlotKVCache", "init_slot_cache", "check_static_scales",
           "quantize_kv", "quantize_kv_static", "dequantize_kv",
           "slot_layer_write", "materialize_layer", "slot_layer_update",
           "fused_slot_attention", "slot_chunk_prefill",
           "hotswap_static_scales", "write_prefill", "clear_slot",
           "rollback_slot", "occupied_slots", "kv_quality_counters",
           "CACHE_DATA_FIELDS"]

SCALE_KEYS = ("k_scale", "k_zero", "v_scale", "v_zero")

#: Data tensors of SlotKVCache in declaration order — what an engine
#: snapshot (engine/recovery.py) persists, under the JAX package's names;
#: mode / qchunks / static are manifest metadata.
CACHE_DATA_FIELDS = ("k", "v", "kv_pos", "k_scale", "k_zero",
                     "v_scale", "v_zero")


@dataclasses.dataclass
class SlotKVCache:
    """mode="fp": fp32, bf16 or float16 k/v (the JAX engine's
    ``kv_dtype``), scales
    are zero-size placeholders (L, N, T, Hkv, 0). mode="int8": int8 codes +
    per-entry scales (L, N, T, Hkv, C), or, with ``static``, per-layer
    constants (L, 1, 1, Hkv, C)."""

    k: torch.Tensor
    v: torch.Tensor
    kv_pos: torch.Tensor          # (L, N, T) int32, -1 = empty
    k_scale: torch.Tensor
    k_zero: torch.Tensor
    v_scale: torch.Tensor
    v_zero: torch.Tensor
    mode: str = "fp"
    qchunks: int = 4
    static: bool = False

    def layer_scales(self, layer: int):
        """The four static (Hkv, C) constants of ``layer``."""
        return tuple(getattr(self, f)[layer, 0, 0] for f in SCALE_KEYS)

    @property
    def n_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in CACHE_DATA_FIELDS)

    def bytes_per_token(self) -> float:
        """Storage bytes per cached token per layer (K and V). Static
        scales are per-layer constants — amortized to ~0 a token."""
        Hkv, D = self.k.shape[-2], self.k.shape[-1]
        per_chunk = (0 if self.static
                     else 2 * 4 * self.k_scale.shape[-1])   # scale+zero fp32
        return 2 * (Hkv * D * self.k.element_size() + Hkv * per_chunk)


def init_slot_cache(cfg, n_slots: int, max_len: int, *, mode: str = "fp",
                    dtype=torch.float32, qchunks: int = 4, kv_scales=None,
                    device=None) -> SlotKVCache:
    """Preallocate the engine cache for a dense config on ``device`` (the
    card unless ``device="cpu"``). ``dtype``: the fp mode's storage type
    (the kernels take fp32, bf16 and float16). ``kv_scales`` (int8 mode only):
    static constants from a calibration recipe, ``k_scale / k_zero /
    v_scale / v_zero`` each (L, Hkv, C)."""
    device = resolve_device(device)
    if mode not in ("fp", "int8"):
        raise ValueError(f"unknown KV cache mode {mode!r}")
    if kv_scales is not None and mode != "int8":
        raise ValueError("static kv_scales require mode='int8'")
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if mode == "int8" and D % qchunks:
        raise ValueError(f"head_dim {D} not divisible by qchunks {qchunks}")
    shape = (L, n_slots, max_len, Hkv, D)
    kv_dtype = torch.int8 if mode == "int8" else dtype
    kv = dict(k=torch.zeros(shape, dtype=kv_dtype, device=device),
              v=torch.zeros(shape, dtype=kv_dtype, device=device),
              kv_pos=torch.full((L, n_slots, max_len), -1, dtype=torch.int32,
                                device=device))
    if kv_scales is not None:
        got = check_static_scales(kv_scales, L, Hkv, qchunks)
        return SlotKVCache(**kv, **{k: t.to(device) for k, t in got.items()},
                           mode=mode, qchunks=qchunks, static=True)
    C = qchunks if mode == "int8" else 0
    sshape = (L, n_slots, max_len, Hkv, C)
    f32 = dict(dtype=torch.float32, device=device)
    return SlotKVCache(
        **kv,
        k_scale=torch.ones(sshape, **f32), k_zero=torch.zeros(sshape, **f32),
        v_scale=torch.ones(sshape, **f32), v_zero=torch.zeros(sshape, **f32),
        mode=mode, qchunks=qchunks)


def check_static_scales(kv_scales: dict, L: int, Hkv: int,
                        qchunks: int) -> dict:
    """Validate recipe kv_scales ((L, Hkv, C) each, numpy or tensors) and
    reshape them to the per-layer-constant cache layout (L, 1, 1, Hkv, C),
    fp32."""
    expect = (L, Hkv, qchunks)
    got = {}
    for kk in SCALE_KEYS:
        arr = kv_scales[kk]
        arr = (arr.float() if isinstance(arr, torch.Tensor)
               else torch.from_numpy(np.asarray(arr, np.float32)))
        if tuple(arr.shape) != expect:
            raise ValueError(
                f"static kv_scales[{kk!r}] has shape {tuple(arr.shape)}"
                f", expected (L, Hkv, qchunks) = {expect} — was the "
                f"recipe calibrated with a different qchunks or arch?")
        got[kk] = arr.reshape(L, 1, 1, Hkv, qchunks).contiguous()
    return got


def dequantize_kv(q, scale, zero, dtype=torch.float32) -> torch.Tensor:
    """codes (..., Hkv, D), scale/zero (..., Hkv, C) → x̂ (..., Hkv, D)
    in ``dtype``: (q - Z) / S in fp32 per sub-channel chunk, then
    cast."""
    return dequant_chunk(q, scale, zero).to(dtype)


def _write_operands(cache: SlotKVCache, layer: int) -> tuple:
    """:func:`write_kv_rows`'s destination of ``layer``: its K/V rows,
    kv_pos and scales (per-entry (N, T, Hkv, C), static (Hkv, C), or
    none over a float cache)."""
    if cache.static:
        sc = cache.layer_scales(layer)
    elif cache.mode == "int8":
        sc = tuple(getattr(cache, f)[layer] for f in SCALE_KEYS)
    else:
        sc = ()
    return (cache.k[layer], cache.v[layer], cache.kv_pos[layer], *sc)


def slot_layer_write(cache: SlotKVCache, layer: int, k_new, v_new,
                     positions) -> None:
    """One decode step's cache write for one layer, in place: quantize
    (int8 mode) and store each slot's new token at row positions % T, in
    one launch. k_new/v_new (N, 1, Hkv, D) post-RoPE; positions (N, 1)."""
    pos = positions.reshape(-1)
    if pos.dtype != torch.int32:
        pos = pos.to(torch.int32)
    write_kv_rows(k_new[:, 0], v_new[:, 0], *_write_operands(cache, layer),
                  positions=pos)


def materialize_layer(cache: SlotKVCache, layer: int,
                      dtype=torch.float32) -> tuple:
    """Full-precision (k, v) (N, T, Hkv, D) of ``layer``'s whole cache in
    ``dtype``: the codes dequantized with their per-entry or static
    scales, or the float rows cast. The materialize read path: a full
    dequant pass and an fp copy per call."""
    if cache.mode == "int8":
        sc = (cache.layer_scales(layer) if cache.static else
              tuple(getattr(cache, f)[layer] for f in SCALE_KEYS))
        return (dequantize_kv(cache.k[layer], sc[0], sc[1], dtype),
                dequantize_kv(cache.v[layer], sc[2], sc[3], dtype))
    return cache.k[layer].to(dtype), cache.v[layer].to(dtype)


def slot_layer_update(cache: SlotKVCache, layer: int, k_new, v_new,
                      positions) -> tuple:
    """The materialize path's write and read: :func:`slot_layer_write`
    (in place), then the layer's whole cache in k_new's dtype. Returns
    (k_full, v_full, kv_pos) with k_full/v_full (N, T, Hkv, D)."""
    slot_layer_write(cache, layer, k_new, v_new, positions)
    k_full, v_full = materialize_layer(cache, layer, k_new.dtype)
    return k_full, v_full, cache.kv_pos[layer]


def fused_slot_attention(cache: SlotKVCache, layer: int, q, q_pos):
    """Decode attention for one layer straight off the (possibly INT8)
    cache, after :func:`slot_layer_write`. q (N, Hq, D); q_pos (N,).
    Returns (N, Hq, D)."""
    if cache.static:
        return decode_attention(q, cache.k[layer], cache.v[layer],
                                cache.kv_pos[layer], q_pos,
                                *cache.layer_scales(layer))
    if cache.mode == "int8":
        return decode_attention(q, cache.k[layer], cache.v[layer],
                                cache.kv_pos[layer], q_pos,
                                cache.k_scale[layer], cache.k_zero[layer],
                                cache.v_scale[layer], cache.v_zero[layer])
    return decode_attention(q, cache.k[layer], cache.v[layer],
                            cache.kv_pos[layer], q_pos)


def slot_chunk_prefill(cache: SlotKVCache, layer: int, q, k_new, v_new,
                       slot: int, pos_start: int, length: int, *,
                       verify: bool = False):
    """One chunked-prefill step for one layer and one slot, in place: the
    chunk (codes in int8 mode) is written into rows [pos_start,
    pos_start + Sq) of the slot first — only the first ``length`` rows
    become visible, the padded tail is marked -1, and rows at or past
    max_len are dropped (a bucket-padded last chunk may stick out past the
    cache) — and then attends the slot's earlier rows plus its own K/V.
    Writing first is safe: attention counts a cache row only where
    0 <= kv_pos < pos_start, and the chunk's rows hold positions at or
    past pos_start. ``verify``: the chunk is a speculative draft window
    and attends its own K/V through the storage round trip, read back
    from the rows just written; a window whose ``length`` reaches past
    max_len (the engine never sends one) attends rows that were dropped,
    so its codes are quantized apart from the cache instead, as the
    standalone :func:`prefill_attention` does. Returns o (Sq, Hq, D)."""
    k, v, kv_pos, *sc = _write_operands(cache, layer)
    write_kv_rows(k_new, v_new, k, v, kv_pos, *sc, slot=slot,
                  pos_start=pos_start, length=length)
    if not cache.static:             # the slot's per-entry scales
        sc = [s[slot] for s in sc]
    cached = not (verify and sc and pos_start + length > cache.max_len)
    o, _ = prefill_attention(q, k_new, v_new, k[slot], v[slot], kv_pos[slot],
                             pos_start, length, *sc, verify=verify,
                             window_cached=cached)
    return o


def hotswap_static_scales(cache: SlotKVCache, kv_scales) -> SlotKVCache:
    """Switch a dynamic int8 cache to static recipe scales without
    draining its slots: every code is dequantized with its per-entry
    scales and requantized with the per-layer constants (rows kv_pos
    marks invalid carry garbage, masked as before), and the per-entry
    scale arrays give way to the (L, 1, 1, Hkv, C) constants. Returns the
    new cache; the codes are rewritten in place, one layer at a time."""
    if cache.mode != "int8":
        raise ValueError("hot-swap requires an int8 cache")
    if cache.static:
        raise ValueError("cache already serves static scales")
    L, Hkv = cache.k.shape[0], cache.k.shape[-2]
    got = {k: t.to(cache.k.device)
           for k, t in check_static_scales(kv_scales, L, Hkv,
                                           cache.qchunks).items()}
    for layer in range(L):
        for f in ("k", "v"):
            codes = getattr(cache, f)
            x = dequant_chunk(codes[layer], getattr(cache, f"{f}_scale")[layer],
                              getattr(cache, f"{f}_zero")[layer])
            codes[layer] = quantize_kv_static(x, got[f"{f}_scale"][layer, 0, 0],
                                              got[f"{f}_zero"][layer, 0, 0])
    return dataclasses.replace(cache, static=True, **got)


def write_prefill(cache: SlotKVCache, slot: int, prefill_cache,
                  length: int) -> None:
    """Write one request's one-shot prefill K/V (a
    :class:`~repro_torch.models.attention.KVCache` of batch 1, k/v
    (L, 1, S, Hkv, D)) into ``slot``, in place: one
    :func:`write_kv_rows` launch a layer, in the cache's mode (codes and
    per-entry scales, codes with the static constants, or a cast). The
    slot's whole kv_pos row is rewritten: positions [0, length) become
    visible and every other row reads -1, which clears a previous
    occupant and the bucket's right-padding. The padding rows' codes (S
    > length) are written too and stay masked."""
    k, v = prefill_cache.k, prefill_cache.v
    S = k.shape[2]
    if S > cache.max_len:
        raise ValueError(f"prefill length {S} exceeds cache max_len "
                         f"{cache.max_len}")
    clear_slot(cache, slot)
    for layer in range(k.shape[0]):
        write_kv_rows(k[layer, 0], v[layer, 0],
                      *_write_operands(cache, layer), slot=slot,
                      pos_start=0, length=length)


def clear_slot(cache: SlotKVCache, slot: int) -> None:
    """Mark a slot empty in every layer (retire). The K/V bytes stay:
    kv_pos = -1 masks them and the next prefill overwrites the rows."""
    cache.kv_pos[:, slot] = -1


def rollback_slot(cache: SlotKVCache, slot: int, accept_len: int) -> None:
    """Undo speculative writes past the accepted point, in place: rows of
    ``slot`` holding a position at or past ``accept_len`` get kv_pos -1,
    in every layer. Every read masks rows by kv_pos, so that is the whole
    rollback; the next write at those positions overwrites the bytes."""
    row = cache.kv_pos[:, slot]
    row.masked_fill_(row >= accept_len, -1)


def occupied_slots(cache: SlotKVCache) -> list[int]:
    """Slots with ANY valid (kv_pos >= 0) row — the slot-pool leak check:
    after a full drain every request has retired and ``clear_slot``
    marked its rows -1, so a non-empty result means a retire path forgot
    the cache half of the slot. One copy of the position plane to the
    host; diagnostics, not hot path."""
    pos = cache.kv_pos.cpu().numpy()                  # (L, N, T)
    return np.unique(np.nonzero((pos >= 0).any(axis=(0, 2)))[0]).tolist()


# -------------------------------------------------- quality counters ---
def kv_quality_counters(cache: SlotKVCache, max_rows: int = 4096,
                        ref_scales=None) -> dict:
    """Sample quantization-quality counters from a live int8 slot cache
    (``obs.quality``, DESIGN.md §10), as the JAX package does.

    Reads only rows kv_pos marks valid (stale retired or rolled-back
    bytes would poison the statistics), in (L, N, T) row-major order,
    thinned evenly to ``max_rows`` (layer, slot, token) rows so the copy
    stays bounded: the rows are gathered on the cache's device and only
    they (at most ``max_rows`` a field) go to the host, where the
    statistics are numpy. Returns a flat dict of numbers and lists — the
    shape the tracer's ``counter`` records and the Chrome exporter
    expect:

    * ``{k,v}_clip_frac`` / ``{k,v}_occupancy`` — code saturation and
      code-range use (``quality.code_stats``); the static-scale drift
      signals (clipping up = recipe too narrow, occupancy down = too
      wide).
    * dynamic scales only: ``{k,v}_span_median`` / ``_span_outlier_hist``
      — per-chunk range spread and the OCS outlier histogram, plus
      ``_occupancy_vs_ref`` when a recipe's ``ref_scales`` dict
      ((L, Hkv, C) arrays, the layout of ``init_slot_cache``'s
      ``kv_scales``) is given to compare live ranges against.
    """
    from ..obs.quality import code_stats, scale_to_span, span_stats

    if cache.mode != "int8":
        raise ValueError("KV quality counters require an int8 cache")
    idx = torch.nonzero(cache.kv_pos >= 0)          # (n, 3), row-major
    n_valid = int(idx.shape[0])
    out: dict = {"valid_rows": n_valid, "static": int(cache.static),
                 "qchunks": cache.qchunks}
    if not n_valid:
        return out
    if n_valid > max_rows:                      # even, deterministic
        keep = np.linspace(0, n_valid - 1, max_rows).astype(np.int64)
        idx = idx[torch.from_numpy(keep).to(idx.device)]
    lidx, nidx, tidx = idx.unbind(1)
    lidx_h = lidx.cpu().numpy()
    out["sampled_rows"] = int(idx.shape[0])
    for name, codes in (("k", cache.k), ("v", cache.v)):
        cs = code_stats(codes[lidx, nidx, tidx].cpu().numpy(), bits=8)
        out[f"{name}_clip_frac"] = cs["clip_frac"]
        out[f"{name}_occupancy"] = cs["occupancy"]
    if not cache.static:
        for name, scale in (("k", cache.k_scale), ("v", cache.v_scale)):
            spans = scale_to_span(scale[lidx, nidx, tidx].cpu().numpy())
            ref = None
            if ref_scales is not None:
                # recipe scales are per-layer constants (L, Hkv, C):
                # broadcast to the sampled rows through the layer index
                r = ref_scales[f"{name}_scale"]
                r = r.cpu().numpy() if isinstance(r, torch.Tensor) else r
                ref = scale_to_span(np.asarray(r, np.float64)[lidx_h])
            st = span_stats(spans, ref)
            out[f"{name}_span_median"] = st["span_median"]
            out[f"{name}_span_outlier_hist"] = st["outlier_hist"]
            if ref is not None:
                out[f"{name}_occupancy_vs_ref"] = st["occupancy_vs_ref"]
    return out
