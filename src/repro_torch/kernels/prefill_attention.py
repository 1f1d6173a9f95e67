"""Fused chunked-prefill attention for one layer, one slot and one prompt
chunk: the wrapper of the CUDA kernels in ``csrc/prefill_attention.cu``
(which replace the Pallas TPU kernel
``repro/kernels/prefill_attention.py:_prefill_kernel``) and their plain
PyTorch versions.

Shapes:
  q             (Sq, Hq, D)   post-RoPE chunk queries (Sq = padded chunk)
  k_new, v_new  (Sq, Hkv, D)  post-RoPE chunk K/V, full precision
  cache_k/v     (T, Hkv, D)   the slot's rows: int8 codes, or fp32, bf16 or
                              float16
  kv_pos        (T,) int32    absolute position per row, -1 = empty
  pos_start     int           absolute position of chunk token 0
  length        int           valid tokens in the chunk
  scales        fp32, int8 mode: per-entry (T, Hkv, C) ("dynamic"), or
                per-layer static (Hkv, C) constants ("static")

Cache rows are valid iff 0 <= kv_pos < pos_start; the chunk's own K/V are
attended at full precision under key <= query and key < length. In int8
mode the chunk's K/V are quantized for the cache: dynamically per (token,
head, sub-channel chunk), bit-identical to ``engine.kvcache.quantize_kv``
of the JAX package, or with the static constants (``quantize_kv_static``,
the fractional zero folded into the rounding).

The cache write (the counterpart of the TPU kernel's epilogue
``_quantize_chunk`` and of the JAX engine's scatter) is
:func:`write_kv_rows`: one launch of ``csrc/kv_write.cu`` quantizes K and
V together and stores codes, per-entry scales and ``kv_pos`` straight
into a layer's slot rows, for a decode step (row n to slot n at
positions[n] mod T) or for a chunk or verify window of one slot. The
engine writes a chunk first and attends after (``window_cached=True``):
the chunk's rows hold positions at or past pos_start, which no attention
counts. :func:`quantize_kv` and :func:`quantize_kv_static` launch the
same kernel with a dense destination; the standalone contract of
:func:`prefill_attention` returns the chunk's codes through them.

``verify=True`` is the speculative verify pass: the chunk is a draft
window, and it attends its own K/V through the storage round trip (the
codes it writes, dequantized; over a float cache a cast to its type and
back to fp32) so that
each row scores what a plain decode step of its token would. With
``window_cached`` those codes are read back from the slot's rows.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor
they launch the kernels or raise. The attention variant follows q's
dtype: bf16 goes to the tensor-core kernel (``"bf16_tensor_core"``), which
also cuts the key range across blocks as :func:`prefill_plan` says; fp32
to the CUDA-core kernel (``"fp32_cuda_core"``), which keeps the fp32
numbers. ``prefill_attention.launches``, ``write_kv_rows.launches``,
``quantize_kv.launches`` and ``quantize_kv_static.launches`` count kernel
launches, ``prefill_attention.variant_launches`` the attention's by
variant, ``prefill_attention.mode_launches`` by mode (:data:`MODES`) and
``write_kv_rows.mode_launches`` the write's (:data:`WRITE_MODES`), and
``prefill_attention.dtype_launches`` and ``write_kv_rows.dtype_launches``
each by the cache's dtype (:data:`CACHE_DTYPES`: int8, float32,
bfloat16, float16). The tensor-core kernel takes head_dim 32, 64, 112,
128 and 256.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..core.quantize import QuantConfig, qparams, quantize, value_range
from . import build
from .decode_attention import (CACHE_DTYPES, NEG_INF, check_chunks,
                               check_head_dim, dequant_chunk, merge_partials,
                               pick_kv_chunk)

KV_QCFG = QuantConfig(bits=8, symmetric=False)

TENSOR_CORE = "bf16_tensor_core"
CUDA_CORE = "fp32_cuda_core"
#: query rows (queries x heads of a group) and keys per tile of a
#: tensor-core block
Q_ROWS = 64
KV_TILE = 64
#: blocks per SM the tensor-core split aims at
BLOCKS_PER_SM = 2
#: splits at most, the chunk's own included (the kernel's merge keeps its
#: weights in shared memory)
MAX_SPLITS = 16
#: the modes that ``mode_launches`` counts
MODES = ("fp", "dynamic", "static", "verify_fp", "verify_dynamic",
         "verify_static")
#: the cache modes of the K/V write, as ``write_kv_rows.mode_launches``
#: counts them, and their ids in ``csrc/kv_write.cu``
WRITE_MODES = ("fp", "dynamic", "static")
#: the 16-bit destinations of an fp write, by their ids in
#: ``csrc/kv_write.cu`` (0: fp32 rows or int8 codes)
DST16 = {torch.bfloat16: 1, torch.float16: 2}


def prefill_mode(cache_k, k_scale, verify: bool) -> str:
    """The mode a call runs in (one of :data:`MODES`): static scales are
    (Hkv, C), per-entry ones (T, Hkv, C)."""
    mode = "fp" if cache_k.dtype != torch.int8 else \
        "static" if k_scale.dim() == 2 else "dynamic"
    return f"verify_{mode}" if verify else mode


def prefill_variant(dtype: torch.dtype) -> str:
    """The attention kernel a call in ``dtype`` launches: bf16 on the
    tensor cores, fp32 on the CUDA cores (TF32 or bf16 products would
    change the fp32 numbers)."""
    if dtype == torch.bfloat16:
        return TENSOR_CORE
    if dtype == torch.float32:
        return CUDA_CORE
    raise TypeError(f"q must be float32 or bfloat16, got {dtype}")


class PrefillPlan(NamedTuple):
    """How the tensor-core kernel cuts one call: blocks of ``bq`` queries
    x G heads of one kv-head; the cache rows in ``cache_splits`` ranges of
    ``cache_rows`` rows (the last one running on to T), and the chunk's own
    keys as one more split."""
    bq: int
    cache_rows: int
    cache_splits: int

    @property
    def splits(self) -> int:
        return self.cache_splits + 1

    def cache_range(self, s: int, T: int) -> tuple[int, int]:
        lo = s * self.cache_rows
        return lo, T if s == self.cache_splits - 1 else min(T, lo + self.cache_rows)


@functools.lru_cache(maxsize=4096)
def prefill_plan(Sq: int, T: int, Hkv: int, G: int, pos_start: int,
                 sms: int) -> PrefillPlan:
    """Cut the cache rows below ``pos_start`` (where a slot's earlier
    tokens lie) into whole 64-row tiles across as many splits as bring the
    grid near :data:`BLOCKS_PER_SM` blocks per SM of a card with ``sms``
    SMs, :data:`MAX_SPLITS` splits at most in all; the last cache split
    also scans the rest of T."""
    if G > Q_ROWS:
        raise ValueError(f"the kernel takes at most {Q_ROWS} query heads "
                         f"per kv-head, got {G}")
    bq = Q_ROWS // G
    base = -(-Sq // bq) * Hkv
    live = -(-min(max(pos_start, 0), T) // KV_TILE)
    tiles = -(-T // KV_TILE)
    if live == 0:
        return PrefillPlan(bq, tiles * KV_TILE, 1)
    want = max(1, min(-(-BLOCKS_PER_SM * sms // base) - 1, live,
                      MAX_SPLITS - 1))
    per = -(-live // want)
    return PrefillPlan(bq, per * KV_TILE, -(-live // per))


# ------------------------------------------------------------ quantize ---
def quantize_kv_ref(x: torch.Tensor, qchunks: int):
    """x (..., H, D) → (codes int8 (..., H, D), scale, zero (..., H, C)):
    each of the C contiguous sub-channel chunks gets its own dynamic
    (β, α) → (S, Z) by eqs. (1)-(3)."""
    *lead, H, D = x.shape
    xc = x.reshape(*lead, H, qchunks, D // qchunks)
    beta, alpha = value_range(xc, dim=-1)
    scale, zero = qparams(beta, alpha, KV_QCFG)
    q = quantize(xc, scale[..., None], zero[..., None], KV_QCFG)
    return q.reshape(x.shape), scale, zero


def quantize_kv(x: torch.Tensor, qchunks: int):
    """Dynamic INT8 K/V quantization (see :func:`quantize_kv_ref`); the
    K/V write kernel with a dense destination on the card, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return quantize_kv_ref(x, qchunks)
    build.check_cuda_operands(x)
    *lead, H, D = x.shape
    if D % qchunks:
        raise ValueError(f"head_dim {D} not divisible by qchunks {qchunks}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*lead, H, qchunks), dtype=torch.float32,
                        device=x.device)
    zero = torch.empty_like(scale)
    if x.numel():
        rows = math.prod(lead)
        _kv_write(x, None, codes, None, None, None, (scale, zero, None, None),
                  "dynamic", rows, rows, H, D, qchunks, 0, 0, rows)
        quantize_kv.launches += 1
    return codes, scale, zero


quantize_kv.launches = 0


def quantize_kv_static_ref(x: torch.Tensor, scale, zero) -> torch.Tensor:
    """x (..., H, D), scale/zero broadcastable to (..., H, C) → int8 codes
    clip(rint(S·x + Z)) per contiguous sub-channel chunk: the static
    (calibrated) write, whose fractional zero is folded into the
    rounding; the product and the sum are two fp32 roundings."""
    *lead, H, D = x.shape
    C = scale.shape[-1]
    xc = x.reshape(*lead, H, C, D // C).float()
    q = torch.round(scale[..., None] * xc + zero[..., None])
    return q.clamp(KV_QCFG.qmin, KV_QCFG.qmax).to(torch.int8).reshape(x.shape)


def quantize_kv_static(x: torch.Tensor, scale, zero) -> torch.Tensor:
    """Static INT8 K/V quantization with one layer's constants (see
    :func:`quantize_kv_static_ref`): scale/zero (Hkv, C) or
    (1, 1, Hkv, C). The K/V write kernel with a dense destination on the
    card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return quantize_kv_static_ref(x, scale, zero)
    build.check_cuda_operands(x, scale, zero)
    *lead, H, D = x.shape
    C = scale.shape[-1]
    if tuple(scale.shape) not in ((H, C), (1, 1, H, C)) or \
            zero.shape != scale.shape or scale.dtype != torch.float32 or \
            zero.dtype != torch.float32:
        raise ValueError(f"scale/zero must be fp32 (Hkv, C) or (1, 1, Hkv, "
                         f"C) with Hkv={H}, got {tuple(scale.shape)}")
    if D % C:
        raise ValueError(f"head_dim {D} not divisible by qchunks {C}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        rows = math.prod(lead)
        _kv_write(x, None, codes, None, None, None,
                  (scale.contiguous(), zero.contiguous(), None, None),
                  "static", rows, rows, H, D, C, 0, 0, rows)
        quantize_kv_static.launches += 1
    return codes


quantize_kv_static.launches = 0


# ------------------------------------------------------ the cache write ---
def write_mode(dst_k, k_scale) -> str:
    """The mode of a write into ``dst_k`` (one of :data:`WRITE_MODES`):
    a float (fp32, bf16 or float16) destination is cast to, static scales
    are (Hkv, C), per-entry ones (N, T, Hkv, C)."""
    if dst_k.dtype != torch.int8:
        return "fp"
    return "static" if k_scale.dim() == 2 else "dynamic"


def write_kv_rows_ref(k, v, dst_k, dst_v, kv_pos, k_scale=None, k_zero=None,
                      v_scale=None, v_zero=None, *, positions=None,
                      slot: int = 0, pos_start: int = 0,
                      length: int = 0) -> None:
    """Plain version of :func:`write_kv_rows`: the quantizers' plain
    versions, then PyTorch index and slice assignments."""
    mode = write_mode(dst_k, k_scale)
    if mode == "static":
        pairs = ((dst_k, quantize_kv_static_ref(k, k_scale, k_zero)),
                 (dst_v, quantize_kv_static_ref(v, v_scale, v_zero)))
    elif mode == "dynamic":
        C = k_scale.shape[-1]
        qk, ks, kz = quantize_kv_ref(k, C)
        qv, vs, vz = quantize_kv_ref(v, C)
        pairs = ((dst_k, qk), (dst_v, qv), (k_scale, ks), (k_zero, kz),
                 (v_scale, vs), (v_zero, vz))
    else:
        pairs = ((dst_k, k), (dst_v, v))
    N, T = dst_k.shape[:2]
    if positions is not None:
        pos = positions.reshape(-1).to(torch.int32)
        n_idx = torch.arange(N, device=pos.device)
        t_idx = (pos % T).long()
        if kv_pos is not None:
            kv_pos[n_idx, t_idx] = pos
        for buf, val in pairs:
            buf[n_idx, t_idx] = val.to(buf.dtype)
        return
    keep = max(0, min(k.shape[0], T - pos_start))    # rows past T: dropped
    end = pos_start + keep
    for buf, val in pairs:
        buf[slot, pos_start:end] = val[:keep].to(buf.dtype)
    if kv_pos is not None:
        posv = torch.arange(pos_start, end, dtype=torch.int32,
                            device=k.device)
        posv[length:] = -1
        kv_pos[slot, pos_start:end] = posv


def write_kv_rows(k, v, dst_k, dst_v, kv_pos, k_scale=None, k_zero=None,
                  v_scale=None, v_zero=None, *, positions=None, slot: int = 0,
                  pos_start: int = 0, length: int = 0) -> None:
    """One layer's K/V cache write, in place, in one launch.

    k, v (R, Hkv, D) fp32 or bf16 post-RoPE; ``dst_k``/``dst_v`` the
    layer's (N, T, Hkv, D) rows, int8 codes, or fp32, bf16 or float16 (a
    cast, rounded to nearest even); ``kv_pos`` (N, T) int32. Scales: per-entry
    (N, T, Hkv, C), written (dynamic); per-layer (Hkv, C), read (static);
    none over a float cache.
    ``positions`` (N,) int32: a decode write, row n to slot n at row
    positions[n] mod T, kv_pos = positions[n]. Otherwise a window of
    ``slot``: row r to pos_start + r, dropped at or past T, kv_pos =
    pos_start + r for r < ``length`` and -1 for the padded tail."""
    if k.device.type == "cpu":
        write_kv_rows_ref(k, v, dst_k, dst_v, kv_pos, k_scale, k_zero,
                          v_scale, v_zero, positions=positions, slot=slot,
                          pos_start=pos_start, length=length)
        return
    mode = write_mode(dst_k, k_scale)
    scales = (k_scale, k_zero, v_scale, v_zero) if mode != "fp" else \
        (None,) * 4
    build.check_cuda_operands(k, v, dst_k, dst_v, kv_pos, positions, *scales)
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"k/v must share one of float32, bfloat16, got "
                        f"{k.dtype}, {v.dtype}")
    if k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"k/v must be (R, Hkv, D), got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    R, Hkv, D = k.shape
    if dst_k.dim() != 4 or dst_k.shape[2:] != (Hkv, D) or \
            dst_v.shape != dst_k.shape or dst_v.dtype != dst_k.dtype or \
            dst_k.dtype not in CACHE_DTYPES:
        raise ValueError(f"the destination must be one of "
                         f"{', '.join(CACHE_DTYPES.values())} (N, T, {Hkv}, "
                         f"{D}), got {tuple(dst_k.shape)} {dst_k.dtype}")
    N, T = dst_k.shape[:2]
    if kv_pos.shape != (N, T) or kv_pos.dtype != torch.int32:
        raise ValueError(f"kv_pos must be int32 ({N}, {T})")
    C = k_scale.shape[-1] if mode != "fp" else 1
    want = (Hkv, C) if mode == "static" else (N, T, Hkv, C)
    if mode != "fp" and (D % C or any(
            tuple(s.shape) != want or s.dtype != torch.float32
            for s in scales)):
        raise ValueError(f"{mode} scales must be fp32 {want} with "
                         f"D % C == 0")
    if not all(t.is_contiguous() for t in (dst_k, dst_v, kv_pos, *scales)
               if t is not None):
        raise ValueError("the destination, kv_pos and scales must be "
                         "contiguous (written in place)")
    if positions is not None:
        if positions.shape != (N,) or R != N or \
                positions.dtype != torch.int32 or \
                not positions.is_contiguous():
            raise ValueError(f"a decode write takes one row a slot and "
                             f"contiguous int32 positions ({N},)")
    elif not (0 <= slot < N and pos_start >= 0 and length >= 0):
        raise ValueError(f"window out of range: slot {slot} of {N}, "
                         f"pos_start {pos_start}, length {length}")
    if R:
        _kv_write(k.contiguous(), v.contiguous(), dst_k, dst_v, kv_pos,
                  positions, scales, mode, R, T, Hkv, D, C, int(slot),
                  int(pos_start), int(length))
        write_kv_rows.launches += 1
        write_kv_rows.mode_launches[mode] += 1
        write_kv_rows.dtype_launches[CACHE_DTYPES[dst_k.dtype]] += 1


write_kv_rows.launches = 0
write_kv_rows.mode_launches = dict.fromkeys(WRITE_MODES, 0)
write_kv_rows.dtype_launches = dict.fromkeys(CACHE_DTYPES.values(), 0)


def _kv_write(k, v, dst_k, dst_v, kv_pos, positions, scales, mode: str,
              rows: int, T: int, Hkv: int, D: int, C: int, slot: int,
              pos_start: int, length: int) -> None:
    """Launch ``csrc/kv_write.cu`` (operands checked by the caller; ``v``
    None: K alone)."""
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = build.library()
    err = lib.kv_write(ptr(k), ptr(v), ptr(dst_k), ptr(dst_v), ptr(kv_pos),
                       ptr(positions), *map(ptr, scales), rows, T, Hkv, D, C,
                       slot, pos_start, length, WRITE_MODES.index(mode),
                       int(k.dtype == torch.bfloat16),
                       DST16.get(dst_k.dtype, 0), build.stream_of(k))
    build.check(lib, err, "kv_write")


def window_kv(k_new, v_new, cache_dtype, scales, verify: bool):
    """The chunk's own K/V as fp32, as the chunk attends them: at full
    precision, or (``verify``) through the storage round trip — per-entry
    quantize and dequantize, static quantize and dequantize (``scales``
    (Hkv, C)), or a cast to the cache's float type (a rounding to bf16
    for fp32 K/V over a bf16 cache)."""
    if not verify:
        return k_new.float(), v_new.float()
    if cache_dtype != torch.int8:
        return (k_new.to(cache_dtype).float(), v_new.to(cache_dtype).float())
    ks, kz, vs, vz = scales
    if ks.dim() == 2:
        return (dequant_chunk(quantize_kv_static_ref(k_new, ks, kz), ks, kz),
                dequant_chunk(quantize_kv_static_ref(v_new, vs, vz), vs, vz))
    C = ks.shape[-1]
    return (dequant_chunk(*quantize_kv_ref(k_new, C)),
            dequant_chunk(*quantize_kv_ref(v_new, C)))


def _rows(scale, sl):
    """The scales of cache rows ``sl``: a per-entry (T, Hkv, C) array is
    cut, static (Hkv, C) constants broadcast."""
    return scale if scale.dim() == 2 else scale[sl]


def cached_window(cache_k, cache_v, scales, pos_start: int, Sq: int):
    """A verify window's K/V as fp32 read back from the int8 slot rows
    [pos_start, pos_start + Sq) that :func:`write_kv_rows` has written:
    the rows it kept (those below T) dequantized, the rest zeros (the
    caller masks them)."""
    T = cache_k.shape[0]
    n = max(0, min(Sq, T - pos_start))
    sl = slice(pos_start, pos_start + n)
    ks, kz, vs, vz = scales
    out = []
    for codes, s, z in ((cache_k, ks, kz), (cache_v, vs, vz)):
        x = dequant_chunk(codes[sl], _rows(s, sl), _rows(z, sl))
        out.append(torch.cat([x, x.new_zeros((Sq - n, *x.shape[1:]))]))
    return tuple(out)


# ----------------------------------------------------------- attention ---
def prefill_attention_ref(q, k_new, v_new, cache_k, cache_v, kv_pos,
                          pos_start: int, length: int, k_scale=None,
                          k_zero=None, v_scale=None, v_zero=None, *,
                          kv_chunk=None, verify: bool = False,
                          window_cached: bool = False) -> torch.Tensor:
    """Plain online-softmax sweep: the cache rows in chunks (dead chunks
    skipped), then the chunk's own K/V (through :func:`window_kv`, or in
    verify mode over an int8 cache with ``window_cached``, through
    :func:`cached_window`). Returns (Sq, Hq, D) in q.dtype."""
    int8 = cache_k.dtype == torch.int8
    Sq, Hq, D = q.shape
    T, Hkv = cache_k.shape[0], cache_k.shape[1]
    G = Hq // Hkv
    Tc = pick_kv_chunk(T, kv_chunk)
    dev = q.device
    qs = (q.float() * (D ** -0.5)).reshape(Sq, Hkv, G, D)
    m = torch.full((Sq, Hkv, G), NEG_INF, device=dev)
    l = torch.zeros((Sq, Hkv, G), device=dev)
    acc = torch.zeros((Sq, Hkv, G, D), device=dev)

    def update(m, l, acc, kc, vc, valid):
        # kc/vc (Tk, Hkv, D); valid (Sq|1, Tk)
        s = (qs[:, :, :, None, :] * kc.permute(1, 0, 2)[None, :, None]).sum(-1)
        msk = valid[:, None, None, :]
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = (p[..., None] * vc.permute(1, 0, 2)[None, :, None]).sum(-2)
        return m_new, l, acc * corr[..., None] + pv

    for t0 in range(0, T, Tc):
        sl = slice(t0, t0 + Tc)
        pos_c = kv_pos[sl]
        valid = (pos_c >= 0) & (pos_c < pos_start)
        if not bool(valid.any()):
            continue
        if int8:
            kc = dequant_chunk(cache_k[sl], _rows(k_scale, sl),
                               _rows(k_zero, sl))
            vc = dequant_chunk(cache_v[sl], _rows(v_scale, sl),
                               _rows(v_zero, sl))
        else:
            kc, vc = cache_k[sl].float(), cache_v[sl].float()
        m, l, acc = update(m, l, acc, kc, vc, valid[None])
    idx = torch.arange(Sq, device=dev)
    valid = (idx[None, :] <= idx[:, None]) & (idx[None, :] < length)
    scales = (k_scale, k_zero, v_scale, v_zero)
    if verify and int8 and window_cached:
        kn, vn = cached_window(cache_k, cache_v, scales, pos_start, Sq)
    else:
        kn, vn = window_kv(k_new, v_new, cache_k.dtype, scales, verify)
    m, l, acc = update(m, l, acc, kn, vn, valid)
    o = torch.where(l[..., None] > 0, acc / l.clamp(min=1e-30)[..., None], 0.0)
    return o.reshape(Sq, Hq, D).to(q.dtype)


def prefill_attention_split_ref(q, k_new, v_new, cache_k, cache_v, kv_pos,
                                pos_start: int, length: int, k_scale=None,
                                k_zero=None, v_scale=None, v_zero=None, *,
                                plan: PrefillPlan, verify: bool = False
                                ) -> torch.Tensor:
    """The tensor-core kernel's split of the key range in plain PyTorch
    (fp32, without its bf16 rounding points): each cache range of the plan
    and then the chunk's own keys as one more split, each an online
    softmax over 64-key tiles (a cache tile with no live row skipped),
    merged by log-sum-exp in split order. Returns (Sq, Hq, D) in
    q.dtype."""
    int8 = cache_k.dtype == torch.int8
    Sq, Hq, D = q.shape
    T, Hkv = cache_k.shape[0], cache_k.shape[1]
    G = Hq // Hkv
    dev = q.device
    qs = (q.float() * (D ** -0.5)).reshape(Sq, Hkv, G, D)
    idx = torch.arange(Sq, device=dev)

    def walk(keys):
        """keys: list of (kc, vc, valid (Sq|1, Tk)) tiles."""
        m = torch.full((Sq, Hkv, G), NEG_INF, device=dev)
        l = torch.zeros((Sq, Hkv, G), device=dev)
        acc = torch.zeros((Sq, Hkv, G, D), device=dev)
        for kc, vc, valid in keys:
            s = (qs[:, :, :, None, :] *
                 kc.permute(1, 0, 2)[None, :, None]).sum(-1)
            msk = valid[:, None, None, :]
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = (p[..., None] * vc.permute(1, 0, 2)[None, :, None]).sum(-2)
            acc = acc * corr[..., None] + pv
            m = m_new
        return m, l, acc

    parts = []
    for sp in range(plan.cache_splits):
        lo, hi = plan.cache_range(sp, T)
        tiles = []
        for t0 in range(lo, hi, KV_TILE):
            sl = slice(t0, min(hi, t0 + KV_TILE))
            pos_c = kv_pos[sl]
            valid = (pos_c >= 0) & (pos_c < pos_start)
            if not bool(valid.any()):
                continue
            if int8:
                kc = dequant_chunk(cache_k[sl], _rows(k_scale, sl),
                                   _rows(k_zero, sl))
                vc = dequant_chunk(cache_v[sl], _rows(v_scale, sl),
                                   _rows(v_zero, sl))
            else:
                kc, vc = cache_k[sl].float(), cache_v[sl].float()
            tiles.append((kc, vc, valid[None]))
        parts.append(walk(tiles))
    kn, vn = window_kv(k_new, v_new, cache_k.dtype,
                       (k_scale, k_zero, v_scale, v_zero), verify)
    tiles = []
    for t0 in range(0, min(Sq, length), KV_TILE):
        key = torch.arange(t0, min(Sq, t0 + KV_TILE), device=dev)
        valid = (key[None, :] <= idx[:, None]) & (key[None, :] < length)
        sl = slice(t0, t0 + len(key))
        tiles.append((kn[sl], vn[sl], valid))
    parts.append(walk(tiles))
    _, l, acc = merge_partials(*zip(*parts))
    o = torch.where(l[..., None] > 0, acc / l.clamp(min=1e-30)[..., None], 0.0)
    return o.reshape(Sq, Hq, D).to(q.dtype)


def _check_cuda(q, k_new, v_new, cache_k, cache_v, kv_pos, scales):
    build.check_cuda_operands(q, k_new, v_new, cache_k, cache_v, kv_pos,
                              *scales)
    Sq, Hq, D = q.shape
    if k_new.dim() != 3 or k_new.shape[0] != Sq or k_new.shape[2] != D \
            or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new must be (Sq, Hkv, D), got "
                         f"{tuple(k_new.shape)}")
    Hkv = k_new.shape[1]
    if cache_k.dim() != 3 or cache_k.shape[1:] != (Hkv, D) \
            or cache_v.shape != cache_k.shape:
        raise ValueError(f"cache must be (T, Hkv, D), got "
                         f"{tuple(cache_k.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if kv_pos.shape != (cache_k.shape[0],):
        raise ValueError("kv_pos must be (T,)")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError("q/k_new/v_new must share one of float32, bfloat16")
    if cache_k.dtype not in CACHE_DTYPES or cache_v.dtype != cache_k.dtype:
        raise TypeError(f"the cache must be one of "
                        f"{', '.join(CACHE_DTYPES.values())}, got "
                        f"{cache_k.dtype}, {cache_v.dtype}")
    if cache_k.dtype == torch.int8:
        if any(s is None for s in scales):
            raise ValueError("int8 mode requires all four scale arrays")
        C = scales[0].shape[-1]
        want = (Hkv, C) if scales[0].dim() == 2 else \
            (cache_k.shape[0], Hkv, C)
        for s in scales:
            if tuple(s.shape) != want or s.dtype != torch.float32:
                raise ValueError("scales must be fp32 (T, Hkv, C) per entry "
                                 "or (Hkv, C) static")
        if D % C:
            raise ValueError(f"head_dim {D} not divisible by qchunks {C}")
        if q.dtype == torch.bfloat16:
            check_chunks(D, C)
    if q.dtype == torch.bfloat16:
        check_head_dim(D)


def prefill_attention(q, k_new, v_new, cache_k, cache_v, kv_pos,
                      pos_start: int, length: int, k_scale=None, k_zero=None,
                      v_scale=None, v_zero=None, *, verify: bool = False,
                      window_cached: bool = False):
    """Chunked-prefill attention plus, in int8 mode, the chunk's codes.

    fp mode (fp32, bf16 or float16 cache): returns (o, ()).
    int8 per-entry scales (T, Hkv, C): returns (o, (qk, qv, ks, kz, vs,
    vz)) — the chunk's codes and fresh per-entry scales, for the caller
    to write into the slot.
    int8 static scales (Hkv, C): returns (o, (qk, qv)); the scales are
    constants and nothing else is written.
    ``verify``: the speculative verify pass (module doc); the returned
    codes are the same.
    ``window_cached``: the chunk is already in the slot's rows
    [pos_start, pos_start + Sq) (:func:`write_kv_rows`): no quantizer
    runs, (o, ()) is returned, and in verify mode over an int8 cache the
    window attends those rows' codes, so ``length`` must not pass T -
    pos_start.
    """
    scales = (k_scale, k_zero, v_scale, v_zero)
    int8 = cache_k.dtype == torch.int8
    static = int8 and k_scale.dim() == 2
    aux = ()
    if window_cached:
        if int8 and verify and not 0 <= pos_start <= \
                cache_k.shape[0] - length:
            raise ValueError(f"a verify window read from the cache must lie "
                             f"in it: pos_start {pos_start} + length "
                             f"{length} > T {cache_k.shape[0]}")
    elif int8:
        # the chunk's codes first: the epilogue's, and in verify mode what
        # the window attends
        if static:
            aux = (quantize_kv_static(k_new, k_scale, k_zero),
                   quantize_kv_static(v_new, v_scale, v_zero))
        else:
            C = k_scale.shape[-1]
            qk, ks, kz = quantize_kv(k_new, C)
            qv, vs, vz = quantize_kv(v_new, C)
            aux = (qk, qv, ks, kz, vs, vz)
    if q.device.type == "cpu":
        o = prefill_attention_ref(q, k_new, v_new, cache_k, cache_v, kv_pos,
                                  pos_start, length, *scales, verify=verify,
                                  window_cached=window_cached)
        return o, aux
    _check_cuda(q, k_new, v_new, cache_k, cache_v, kv_pos, scales)
    Sq, Hq, D = q.shape
    T, Hkv = cache_k.shape[0], cache_k.shape[1]
    C = scales[0].shape[-1] if int8 else 0
    mode = prefill_mode(cache_k, k_scale, verify)
    ts = [t.contiguous() for t in (q, k_new, v_new, cache_k, cache_v)]
    if kv_pos.dtype != torch.int32:   # .to() costs host time even idle
        kv_pos = kv_pos.to(torch.int32)
    kv_pos = kv_pos.contiguous()
    sc = [s.contiguous() for s in scales] if int8 else [None] * 4
    # the window's codes and per-entry scales (verify over an int8 cache):
    # the slot's rows from pos_start, or the codes quantized above
    win = [None] * 6
    if int8 and verify and window_cached:
        row = pos_start * Hkv
        win = [ts[3].data_ptr() + row * D, ts[4].data_ptr() + row * D] + (
            [None] * 4 if static else [s.data_ptr() + 4 * row * C
                                       for s in sc])
    elif int8 and verify:
        win = [t.data_ptr() for t in aux[:2]] + (
            [None] * 4 if static else [t.data_ptr() for t in aux[2:]])
    o = torch.empty_like(ts[0])
    variant = prefill_variant(q.dtype)
    part_o = part_ml = counter = None
    rows = splits = 0
    if variant == TENSOR_CORE:
        G = Hq // Hkv
        p = prefill_plan(Sq, T, Hkv, G, int(pos_start),
                         build.sm_count(q.device.index or 0))
        rows, splits = p.cache_rows, p.cache_splits
        # one fp32 workspace: the partial outputs (splits, Sq, Hq, D),
        # then the running max and sum (splits, Sq, Hq, 2)
        n = p.splits * Sq * Hq
        ws = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
        part_o = ws.data_ptr()
        part_ml = part_o + 4 * n * D
        counter = build.merge_counters("prefill_attention", q.device,
                                       -(-Sq // p.bq) * Hkv).data_ptr()
    lib = build.library()
    err = lib.prefill_attention(
        *(t.data_ptr() for t in ts), kv_pos.data_ptr(),
        *(None if s is None else s.data_ptr() for s in sc), *win,
        o.data_ptr(), part_o, part_ml, counter, Sq, T, Hq, Hkv, D, C,
        int(pos_start), int(length), cache_k.element_size(),
        int(cache_k.dtype == torch.float16), int(static),
        int(verify), int(variant == TENSOR_CORE), rows, splits,
        D ** -0.5, build.stream_of(q))
    build.check(lib, err, "prefill_attention")
    prefill_attention.launches += 1
    prefill_attention.variant_launches[variant] += 1
    prefill_attention.mode_launches[mode] += 1
    prefill_attention.dtype_launches[CACHE_DTYPES[cache_k.dtype]] += 1
    return o, aux


def reset_counts() -> None:
    """Set the attention's total, per-variant, per-mode and per-dtype
    launch counts, the write's total, per-mode and per-dtype counts and
    the two standalone quantizers' counts to 0."""
    for fn in (prefill_attention, write_kv_rows, quantize_kv,
               quantize_kv_static):
        fn.launches = 0
    for counts in (prefill_attention.variant_launches,
                   prefill_attention.mode_launches,
                   prefill_attention.dtype_launches,
                   write_kv_rows.mode_launches,
                   write_kv_rows.dtype_launches):
        for v in counts:
            counts[v] = 0


prefill_attention.launches = 0
prefill_attention.variant_launches = {TENSOR_CORE: 0, CUDA_CORE: 0}
prefill_attention.mode_launches = dict.fromkeys(MODES, 0)
prefill_attention.dtype_launches = dict.fromkeys(CACHE_DTYPES.values(), 0)
