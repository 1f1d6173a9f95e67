"""Fused decode attention over one layer's slot cache: the wrapper of the
CUDA kernel ``csrc/decode_attention.cu`` (which replaces the Pallas TPU
kernel ``repro/kernels/decode_attention.py:_fused_kernel``) and its plain
PyTorch version.

Shapes (one layer, one query token per slot):
  q       (N, Hq, D)     post-RoPE queries
  k, v    (N, T, Hkv, D) int8 codes (int8 mode) or fp32 (fp mode)
  kv_pos  (N, T) int32   absolute position per row, -1 = empty
  q_pos   (N,)   int32   per-slot current position
  scales  (N, T, Hkv, C) fp32 per-entry (int8 mode; static scales are
          not ported yet)

An entry is valid when 0 <= kv_pos <= q_pos; an empty slot returns exact
0. The mode follows k's dtype. On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.
``decode_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

NEG_INF = -1e30


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
            kc = dequant_chunk(k[:, sl], k_scale[:, sl], k_zero[:, sl])
            vc = dequant_chunk(v[:, sl], v_scale[:, sl], v_zero[:, sl])
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
    if k.dtype not in (torch.int8, torch.float32) or v.dtype != k.dtype:
        raise TypeError(f"the cache must be int8 or float32, got {k.dtype}")
    if k.dtype == torch.int8:
        if any(s is None for s in scales):
            raise ValueError("int8 mode requires all four scale arrays")
        C = scales[0].shape[-1]
        for s in scales:
            if s.shape != (N, T, Hkv, C) or s.dtype != torch.float32:
                raise ValueError("scales must be fp32 (N, T, Hkv, C)")
        if D % C:
            raise ValueError(f"head_dim {D} not divisible by qchunks {C}")


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
    C = scales[0].shape[-1] if int8 else 0
    ts = [t.contiguous() for t in (q, k, v)]
    kv_pos = kv_pos.to(torch.int32).contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    sc = [s.contiguous() for s in scales] if int8 else [None] * 4
    o = torch.empty_like(ts[0])
    lib = build.library()
    err = lib.decode_attention(
        *(t.data_ptr() for t in ts), kv_pos.data_ptr(), q_pos.data_ptr(),
        *(s.data_ptr() if s is not None else None for s in sc), o.data_ptr(),
        N, T, Hq, Hkv, D, C, int(int8), int(q.dtype == torch.bfloat16),
        D ** -0.5, build.stream_of(q))
    build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
