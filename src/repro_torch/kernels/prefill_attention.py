"""Fused chunked-prefill attention for one layer, one slot and one prompt
chunk: the wrapper of the CUDA kernels in ``csrc/prefill_attention.cu``
(which replace the Pallas TPU kernel
``repro/kernels/prefill_attention.py:_prefill_kernel``) and their plain
PyTorch versions.

Shapes:
  q             (Sq, Hq, D)   post-RoPE chunk queries (Sq = padded chunk)
  k_new, v_new  (Sq, Hkv, D)  post-RoPE chunk K/V, full precision
  cache_k/v     (T, Hkv, D)   the slot's rows: int8 codes or fp32
  kv_pos        (T,) int32    absolute position per row, -1 = empty
  pos_start     int           absolute position of chunk token 0
  length        int           valid tokens in the chunk
  scales        (T, Hkv, C)   fp32 per-entry (int8 mode)

Cache rows are valid iff 0 <= kv_pos < pos_start; the chunk's own K/V are
attended at full precision under key <= query and key < length. In int8
mode the chunk's K/V are quantized per (token, head, sub-channel chunk)
by :func:`quantize_kv`, bit-identical to ``engine.kvcache.quantize_kv``
of the JAX package. The fp and int8 per-entry modes are ported; the
static-scale and verify modes are not yet.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor
they launch the kernels or raise. ``prefill_attention.launches`` and
``quantize_kv.launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from ..core.quantize import QuantConfig, qparams, quantize, value_range
from . import build
from .decode_attention import NEG_INF, dequant_chunk, pick_kv_chunk

KV_QCFG = QuantConfig(bits=8, symmetric=False)


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
    CUDA kernel on the card, the plain version on the CPU."""
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
    groups = scale.numel()
    if groups:
        lib = build.library()
        err = lib.quantize_kv(x.data_ptr(), codes.data_ptr(),
                              scale.data_ptr(), zero.data_ptr(), groups,
                              D // qchunks, int(x.dtype == torch.bfloat16),
                              build.stream_of(x))
        build.check(lib, err, "quantize_kv")
        quantize_kv.launches += 1
    return codes, scale, zero


quantize_kv.launches = 0


# ----------------------------------------------------------- attention ---
def prefill_attention_ref(q, k_new, v_new, cache_k, cache_v, kv_pos,
                          pos_start: int, length: int, k_scale=None,
                          k_zero=None, v_scale=None, v_zero=None, *,
                          kv_chunk=None) -> torch.Tensor:
    """Plain online-softmax sweep: the cache rows in chunks (dead chunks
    skipped), then the chunk's own K/V. Returns (Sq, Hq, D) in q.dtype."""
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
            kc = dequant_chunk(cache_k[sl], k_scale[sl], k_zero[sl])
            vc = dequant_chunk(cache_v[sl], v_scale[sl], v_zero[sl])
        else:
            kc, vc = cache_k[sl].float(), cache_v[sl].float()
        m, l, acc = update(m, l, acc, kc, vc, valid[None])
    idx = torch.arange(Sq, device=dev)
    valid = (idx[None, :] <= idx[:, None]) & (idx[None, :] < length)
    m, l, acc = update(m, l, acc, k_new.float(), v_new.float(), valid)
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
    if cache_k.dtype not in (torch.int8, torch.float32) or \
            cache_v.dtype != cache_k.dtype:
        raise TypeError(f"the cache must be int8 or float32, got "
                        f"{cache_k.dtype}")
    if cache_k.dtype == torch.int8:
        if any(s is None for s in scales):
            raise ValueError("int8 mode requires all four scale arrays")
        C = scales[0].shape[-1]
        for s in scales:
            if s.shape != (cache_k.shape[0], Hkv, C) or \
                    s.dtype != torch.float32:
                raise ValueError("scales must be fp32 (T, Hkv, C)")
        if D % C:
            raise ValueError(f"head_dim {D} not divisible by qchunks {C}")


def prefill_attention(q, k_new, v_new, cache_k, cache_v, kv_pos,
                      pos_start: int, length: int, k_scale=None, k_zero=None,
                      v_scale=None, v_zero=None):
    """Chunked-prefill attention plus, in int8 mode, the chunk's codes.

    fp mode (fp32 cache): returns (o, ()).
    int8 mode: returns (o, (qk, qv, ks, kz, vs, vz)) — the chunk's codes
    and fresh per-entry scales, for the caller to write into the slot.
    """
    scales = (k_scale, k_zero, v_scale, v_zero)
    int8 = cache_k.dtype == torch.int8
    if q.device.type == "cpu":
        o = prefill_attention_ref(q, k_new, v_new, cache_k, cache_v, kv_pos,
                                  pos_start, length, *scales)
    else:
        _check_cuda(q, k_new, v_new, cache_k, cache_v, kv_pos, scales)
        Sq, Hq, D = q.shape
        T, Hkv = cache_k.shape[0], cache_k.shape[1]
        C = scales[0].shape[-1] if int8 else 0
        ts = [t.contiguous() for t in (q, k_new, v_new, cache_k, cache_v)]
        kv_pos = kv_pos.to(torch.int32).contiguous()
        sc = [s.contiguous() for s in scales] if int8 else [None] * 4
        o = torch.empty_like(ts[0])
        lib = build.library()
        err = lib.prefill_attention(
            *(t.data_ptr() for t in ts), kv_pos.data_ptr(),
            *(s.data_ptr() if s is not None else None for s in sc),
            o.data_ptr(), Sq, T, Hq, Hkv, D, C, int(pos_start), int(length),
            int(int8), int(q.dtype == torch.bfloat16), D ** -0.5,
            build.stream_of(q))
        build.check(lib, err, "prefill_attention")
        prefill_attention.launches += 1
    if not int8:
        return o, ()
    C = k_scale.shape[-1]
    qk, ks, kz = quantize_kv(k_new, C)
    qv, vs, vz = quantize_kv(v_new, C)
    return o, (qk, qv, ks, kz, vs, vz)


prefill_attention.launches = 0
