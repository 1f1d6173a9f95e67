"""Fused decode attention over one layer's slot cache: the wrapper of the
CUDA kernel ``csrc/decode_attention.cu`` (which replaces the Pallas TPU
kernel ``repro/kernels/decode_attention.py:_fused_kernel``), its launch
plan, and its plain PyTorch versions.

Shapes (one layer, one query token per slot):
  q       (N, Hq, D)     post-RoPE queries
  k, v    (N, T, Hkv, D) int8 codes (int8 mode), or fp32, bf16 or
          float16 (fp mode: the engine's ``kv_dtype``)
  kv_pos  (N, T) int32   absolute position per row, -1 = empty
  q_pos   (N,)   int32   per-slot current position
  scales  fp32, int8 mode: per-entry (N, T, Hkv, C) ("dynamic"), or
          per-layer static constants (1, 1, Hkv, C) or (Hkv, C)
          ("static", from a calibration recipe)

An entry is valid when 0 <= kv_pos <= q_pos; an empty slot returns exact
0. The mode follows k's dtype and the scales' shape. On a CPU tensor the
wrapper runs the plain
version :func:`decode_attention_ref`; on a CUDA tensor it launches the
kernel or raises. The kernel splits T across blocks (flash-decoding) as
:func:`decode_plan` says, and the last block of each (slot, head group)
merges the splits; :func:`decode_attention_split_ref` repeats its
arithmetic (32-row tiles, warps, splits, log-sum-exp merges) in plain
PyTorch. ``decode_attention.launches`` counts kernel launches (one per
call), ``decode_attention.variant_launches`` splits them by plan:
``"split"`` (T cut across blocks, merged in the kernel) and ``"whole"``
(one block per (slot, head group) walks all of T), and
``decode_attention.mode_launches`` by mode: ``"fp"``, ``"dynamic"`` and
``"static"``, and ``decode_attention.dtype_launches`` by the cache's dtype
(:data:`CACHE_DTYPES`). The kernels take the head_dims of
:data:`HEAD_DIMS` (32-256).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import build

NEG_INF = -1e30

#: rows of one warp tile of the kernel, and warps per block at most
TILE_ROWS = 32
MAX_WARPS = 4
#: blocks per SM the split aims at, and the 32-row tiles a split holds at
#: least (one per warp): chosen with ``python -m
#: repro_torch.launch.attention_sweep`` on the serving shapes (PERF.md)
BLOCKS_PER_SM = 2
MIN_SPLIT_TILES = 4
#: the 32-row tiles a split holds at most: a long slot is cut finer than
#: the grid alone asks, so that its blocks, each walking its range
#: serially, do not outlast the rest of the grid (and a warp keeps one
#: valid-row mask per tile for at most 64 tiles)
MAX_SPLIT_TILES = 32
#: splits at most (the kernel's merge keeps its weights in shared memory)
MAX_SPLITS = 64
#: the two kinds of launch that ``variant_launches`` counts
SPLIT = "split"
WHOLE = "whole"
#: the modes that ``mode_launches`` counts
MODES = ("fp", "dynamic", "static")
#: the cache dtypes the kernels take, by the names ``dtype_launches``
#: counts (shared with the prefill attention and the K/V write)
CACHE_DTYPES = {torch.int8: "int8", torch.float32: "float32",
                torch.bfloat16: "bfloat16", torch.float16: "float16"}
#: the head_dims the attention kernels take (112: kimi-k2-1t-a32b; 256:
#: paligemma-3b)
HEAD_DIMS = (32, 64, 112, 128, 256)
#: the largest head_dim at which a decode block takes 16 query heads: at
#: D = 256 a lane's P.V holds 8 columns a head, and 16 heads of them
#: would spill
GROUP16_MAX_D = 128


def is_static(scale, N: int, T: int) -> bool:
    """Scales of one layer are per-layer static constants, (Hkv, C) or
    (1, 1, Hkv, C), rather than per-entry (N, T, Hkv, C) ones (a
    one-slot, one-row cache reads the same either way)."""
    return scale.dim() == 2 or (scale.dim() == 4 and
                                tuple(scale.shape[:2]) == (1, 1) and
                                (N, T) != (1, 1))


def decode_mode(k, k_scale) -> str:
    """The mode a call runs in: "fp", "dynamic" or "static"."""
    if k.dtype != torch.int8:
        return "fp"
    return "static" if is_static(k_scale, k.shape[0], k.shape[1]) \
        else "dynamic"


def _rows(scale, sl, static: bool):
    """The scales of rows ``sl`` of T: a per-entry array is cut, static
    constants broadcast."""
    return scale if static else scale[:, sl]


def head_group(G: int, D: int = 0) -> int:
    """Query heads a block takes: the largest of 16, 4, 1 that divides G
    (the kernel is instantiated for these three; groups of 4 for
    chatglm3-6b's 16 were slower, PERF.md), 4 at most above
    :data:`GROUP16_MAX_D`."""
    if G % 16 == 0 and D <= GROUP16_MAX_D:
        return 16
    return 4 if G % 4 == 0 else 1


class DecodePlan(NamedTuple):
    """How the kernel cuts one call: blocks of ``group`` query heads of
    one kv-head and one slot, each over ``rows`` rows of T (a multiple of
    :data:`TILE_ROWS`) in ``splits`` ranges, none empty, with ``warps``
    warps taking its 32-row tiles in turn."""
    group: int
    splits: int
    rows: int
    warps: int


@functools.lru_cache(maxsize=1024)
def decode_plan(N: int, T: int, Hkv: int, G: int, sms: int,
                D: int = 0) -> DecodePlan:
    """Split T so that the grid (N x Hkv x G/group x splits blocks) comes
    near :data:`BLOCKS_PER_SM` blocks per SM of a card with ``sms`` SMs,
    in whole 32-row tiles, at least :data:`MIN_SPLIT_TILES` of them a
    split (or all of T) and at most :data:`MAX_SPLIT_TILES` where that
    allows, and at most :data:`MAX_SPLITS` splits. ``D``: the head_dim
    (:func:`head_group`)."""
    group = head_group(G, D)
    base = N * Hkv * (G // group)
    tiles = -(-T // TILE_ROWS)
    want = min(max(-(-BLOCKS_PER_SM * sms // base),
                   -(-tiles // MAX_SPLIT_TILES)), tiles, MAX_SPLITS)
    per = min(tiles, max(-(-tiles // want), MIN_SPLIT_TILES))
    return DecodePlan(group, -(-tiles // per), per * TILE_ROWS,
                      min(MAX_WARPS, per))


def pick_kv_chunk(T: int, kv_chunk: Optional[int]) -> int:
    """Largest divisor of T that is ≤ the requested chunk (default 128);
    one chunk of T when no usable divisor exists (as the JAX package)."""
    want = min(T, 128 if kv_chunk is None else kv_chunk)
    for c in range(want, 0, -1):
        if T % c == 0:
            return c if c >= max(2, want // 8) else T
    return T


def dequant_chunk(codes, scale, zero) -> torch.Tensor:
    """codes (..., H, D) int8, scale/zero (..., H, C) → fp32 (..., H, D):
    per-sub-channel-chunk (q - Z) / S."""
    *lead, H, D = codes.shape
    C = scale.shape[-1]
    qc = codes.float().reshape(*lead, H, C, D // C)
    return ((qc - zero[..., None]) / scale[..., None]).reshape(*lead, H, D)


def decode_attention_ref(q, k, v, kv_pos, q_pos, k_scale=None, k_zero=None,
                         v_scale=None, v_zero=None, *, kv_chunk=None
                         ) -> torch.Tensor:
    """Plain online-softmax sweep over T in chunks, with chunks that hold
    no valid entry skipped. Returns (N, Hq, D) in q.dtype."""
    int8 = k.dtype == torch.int8
    N, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    st = int8 and is_static(k_scale, N, T)
    G = Hq // Hkv
    Tc = pick_kv_chunk(T, kv_chunk)
    qs = (q.float() * (D ** -0.5)).reshape(N, Hkv, G, D)
    m = torch.full((N, Hkv, G), NEG_INF, device=q.device)
    l = torch.zeros((N, Hkv, G), device=q.device)
    acc = torch.zeros((N, Hkv, G, D), device=q.device)
    qp = q_pos.to(torch.int32)[:, None]
    for t0 in range(0, T, Tc):
        sl = slice(t0, t0 + Tc)
        pos_c = kv_pos[:, sl]
        valid = (pos_c >= 0) & (pos_c <= qp)                      # (N, Tc)
        if not bool(valid.any()):
            continue
        if int8:
            kc = dequant_chunk(k[:, sl], _rows(k_scale, sl, st),
                               _rows(k_zero, sl, st))
            vc = dequant_chunk(v[:, sl], _rows(v_scale, sl, st),
                               _rows(v_zero, sl, st))
        else:
            kc, vc = k[:, sl].float(), v[:, sl].float()
        # (N, Hkv, G, 1, D) · (N, Hkv, 1, Tc, D) summed over D
        s = (qs[:, :, :, None, :] * kc.permute(0, 2, 1, 3)[:, :, None]).sum(-1)
        msk = valid[:, None, None, :]
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = (p[..., None] * vc.permute(0, 2, 1, 3)[:, :, None]).sum(-2)
        acc = acc * corr[..., None] + pv
        m = m_new
    o = torch.where(l[..., None] > 0, acc / l.clamp(min=1e-30)[..., None], 0.0)
    return o.reshape(N, Hq, D).to(q.dtype)


def merge_partials(ms, ls, accs):
    """Log-sum-exp merge of partial states in list order, skipping the
    empty ones (sum 0): (max, sum, acc) of the whole."""
    m = torch.full_like(ms[0], NEG_INF)
    for mi, li in zip(ms, ls):
        m = torch.where(li > 0, torch.maximum(m, mi), m)
    l = torch.zeros_like(ls[0])
    acc = torch.zeros_like(accs[0])
    for mi, li, ai in zip(ms, ls, accs):
        e = torch.where(li > 0, torch.exp(mi - m), 0.0)
        l = l + li * e
        acc = acc + torch.where(li[..., None] > 0, ai * e[..., None], 0.0)
    return m, l, acc


def decode_attention_split_ref(q, k, v, kv_pos, q_pos, k_scale=None,
                               k_zero=None, v_scale=None, v_zero=None, *,
                               plan: DecodePlan) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: T cut into the plan's
    splits, each split's 32-row tiles dealt to its warps in turn, every
    warp an online softmax over its tiles (a tile with no valid row
    skipped), the warps merged in warp order and the splits in split
    order by log-sum-exp. Returns (N, Hq, D) in q.dtype."""
    int8 = k.dtype == torch.int8
    N, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    st = int8 and is_static(k_scale, N, T)
    G = Hq // Hkv
    qs = (q.float() * (D ** -0.5)).reshape(N, Hkv, G, D)
    qp = q_pos.to(torch.int32)[:, None]
    splits = []
    for lo in range(0, plan.splits * plan.rows, plan.rows):
        hi = min(T, lo + plan.rows)
        tiles = list(range(lo, hi, TILE_ROWS))
        warps = []
        for w in range(plan.warps):
            m = torch.full((N, Hkv, G), NEG_INF, device=q.device)
            l = torch.zeros((N, Hkv, G), device=q.device)
            acc = torch.zeros((N, Hkv, G, D), device=q.device)
            for t0 in tiles[w::plan.warps]:
                sl = slice(t0, min(hi, t0 + TILE_ROWS))
                pos_c = kv_pos[:, sl]
                valid = (pos_c >= 0) & (pos_c <= qp)
                if int8:
                    kc = dequant_chunk(k[:, sl], _rows(k_scale, sl, st),
                                       _rows(k_zero, sl, st))
                    vc = dequant_chunk(v[:, sl], _rows(v_scale, sl, st),
                                       _rows(v_zero, sl, st))
                else:
                    kc, vc = k[:, sl].float(), v[:, sl].float()
                s = (qs[:, :, :, None, :] *
                     kc.permute(0, 2, 1, 3)[:, :, None]).sum(-1)
                msk = valid[:, None, None, :]
                live = valid.any(-1)[:, None, None]     # per slot: the ballot
                s = torch.where(msk, s, NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
                corr = torch.exp(m - m_new)
                pv = (p[..., None] * vc.permute(0, 2, 1, 3)[:, :, None]).sum(-2)
                l = torch.where(live, l * corr + p.sum(-1), l)
                acc = torch.where(live[..., None],
                                  acc * corr[..., None] + pv, acc)
                m = torch.where(live, m_new, m)
            warps.append((m, l, acc))
        splits.append(merge_partials(*zip(*warps)))
    _, l, acc = merge_partials(*zip(*splits))
    o = torch.where(l[..., None] > 0, acc / l.clamp(min=1e-30)[..., None], 0.0)
    return o.reshape(N, Hq, D).to(q.dtype)


def _check_cuda(q, k, v, kv_pos, q_pos, scales):
    build.check_cuda_operands(q, k, v, kv_pos, q_pos, *scales)
    N, Hq, D = q.shape
    if k.dim() != 4 or k.shape[0] != N or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"k/v must be (N, T, Hkv, D), got {tuple(k.shape)}")
    T, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if kv_pos.shape != (N, T) or q_pos.shape != (N,):
        raise ValueError("kv_pos must be (N, T) and q_pos (N,)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype not in CACHE_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"the cache must be one of "
                        f"{', '.join(CACHE_DTYPES.values())}, got "
                        f"{k.dtype}, {v.dtype}")
    if k.dtype == torch.int8:
        if any(s is None for s in scales):
            raise ValueError("int8 mode requires all four scale arrays")
        C = scales[0].shape[-1]
        ok = ((Hkv, C), (1, 1, Hkv, C)) if is_static(scales[0], N, T) \
            else ((N, T, Hkv, C),)
        for s in scales:
            if tuple(s.shape) not in ok or s.dtype != torch.float32:
                raise ValueError("scales must be fp32 (N, T, Hkv, C) per "
                                 "entry, or (1, 1, Hkv, C) or (Hkv, C) static")
        check_chunks(D, C)
    check_head_dim(D)


def check_head_dim(D: int) -> None:
    """The head_dims the attention kernels take."""
    if D not in HEAD_DIMS:
        raise ValueError(f"the attention kernels take head_dim "
                         f"{', '.join(map(str, HEAD_DIMS))}, got {D}")


def check_chunks(D: int, C: int) -> None:
    """The sub-channel chunks the attention kernels take: C dividing D
    and 32, chunks of a whole number of 4-column groups (D = 112, C = 4:
    28)."""
    if D % C or 32 % C or (D // C) < 4 or (D // C) % 4:
        raise ValueError(f"the attention kernels take C dividing 32 and "
                         f"sub-channel chunks of a multiple of 4 columns, "
                         f"got D={D}, C={C}")


def decode_attention(q, k, v, kv_pos, q_pos, k_scale=None, k_zero=None,
                     v_scale=None, v_zero=None) -> torch.Tensor:
    """Decode attention over one layer's slot cache; (N, Hq, D) in
    q.dtype."""
    scales = (k_scale, k_zero, v_scale, v_zero)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_pos, q_pos, *scales)
    _check_cuda(q, k, v, kv_pos, q_pos, scales)
    N, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    int8 = k.dtype == torch.int8
    mode = decode_mode(k, k_scale)
    C = scales[0].shape[-1] if int8 else 0
    ts = [t.contiguous() for t in (q, k, v)]
    # .to() costs host time even when it has nothing to do
    if kv_pos.dtype != torch.int32:
        kv_pos = kv_pos.to(torch.int32)
    if q_pos.dtype != torch.int32:
        q_pos = q_pos.to(torch.int32)
    kv_pos, q_pos = kv_pos.contiguous(), q_pos.contiguous()
    sc = [s.contiguous() for s in scales] if int8 else [None] * 4
    G = Hq // Hkv
    p = decode_plan(N, T, Hkv, G, build.sm_count(q.device.index or 0), D)
    o = torch.empty_like(ts[0])
    part_o = part_ml = counter = None
    if p.splits > 1:
        # one fp32 workspace: the partial outputs (splits, N, Hq, D), then
        # the running max and sum (splits, N, Hq, 2)
        rows = p.splits * N * Hq
        ws = torch.empty(rows * (D + 2), dtype=torch.float32, device=q.device)
        part_o = ws.data_ptr()
        part_ml = part_o + 4 * rows * D
        counter = build.merge_counters("decode_attention", q.device,
                                       N * Hkv * (G // p.group)).data_ptr()
    lib = build.library()
    err = lib.decode_attention(
        *(t.data_ptr() for t in ts), kv_pos.data_ptr(), q_pos.data_ptr(),
        *(None if s is None else s.data_ptr() for s in sc), o.data_ptr(),
        part_o, part_ml, counter, N, T, Hq, Hkv, D, C, k.element_size(),
        int(k.dtype == torch.float16), int(mode == "static"),
        int(q.dtype == torch.bfloat16), p.group,
        p.rows, p.splits, p.warps, D ** -0.5, build.stream_of(q))
    build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    decode_attention.variant_launches[SPLIT if p.splits > 1 else WHOLE] += 1
    decode_attention.mode_launches[mode] += 1
    decode_attention.dtype_launches[CACHE_DTYPES[k.dtype]] += 1
    return o


def reset_counts() -> None:
    """Set the total, the per-variant, the per-mode and the per-dtype
    launch counts to 0."""
    decode_attention.launches = 0
    for counts in (decode_attention.variant_launches,
                   decode_attention.mode_launches,
                   decode_attention.dtype_launches):
        for v in counts:
            counts[v] = 0


decode_attention.launches = 0
decode_attention.variant_launches = {SPLIT: 0, WHOLE: 0}
decode_attention.mode_launches = dict.fromkeys(MODES, 0)
decode_attention.dtype_launches = dict.fromkeys(CACHE_DTYPES.values(), 0)
