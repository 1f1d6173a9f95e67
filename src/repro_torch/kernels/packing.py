"""Bit-packing for low-bit codes and cluster ids (port of
``repro.kernels.packing``; packed bytes are bit-identical).

Codes are packed along axis 0 (the contraction axis K of a (K, N)
weight), ``8 // bits`` codes per byte:

    byte[i, n] = Σ_p  u[i*per + p, n] << (bits * p),   u = q - qmin

so byte i holds rows i·per + p, and a warp that reads one packed row
reads neighbouring n from neighbouring bytes. A stack of E such weights
(E, K, N), the experts of a MoE layer, is packed along its K axis
(axis -2), expert by expert: (E, K·bits/8, N) and (E, K/4, N).
"""
from __future__ import annotations

import torch


def _k_first(fn):
    """Apply a packer written for K on axis 0 along axis -2 of a stacked
    (…, K, N) tensor (axis 0 of a (K, N) or (K,) one)."""
    def wrapped(t, *args):
        ax = t.dim() - 2 if t.dim() > 2 else 0
        if ax == 0:
            return fn(t, *args)
        return fn(t.movedim(ax, 0), *args).movedim(0, ax).contiguous()
    wrapped.__doc__, wrapped.__name__ = fn.__doc__, fn.__name__
    return wrapped


@_k_first
def pack_codes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """(K, N) int8 signed codes → (K*bits/8, N) uint8 packed."""
    if bits == 8:
        return (q.to(torch.int16) + 128).to(torch.uint8)
    per = 8 // bits
    K = q.shape[0]
    if K % per:
        raise ValueError(f"K={K} not divisible by {per} (bits={bits})")
    u = (q.to(torch.int32) + 2 ** (bits - 1)).reshape(K // per, per,
                                                       *q.shape[1:])
    byte = torch.zeros_like(u[:, 0])
    for p in range(per):
        byte |= u[:, p] << (bits * p)
    return byte.to(torch.uint8)


@_k_first
def unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(K*bits/8, N) uint8 → (K, N) int8 signed codes."""
    if bits == 8:
        return (packed.to(torch.int16) - 128).to(torch.int8)
    per = 8 // bits
    mask = (1 << bits) - 1
    b = packed.to(torch.int32)
    u = torch.stack([(b >> (bits * p)) & mask for p in range(per)], dim=1)
    u = u.reshape(packed.shape[0] * per, *packed.shape[1:])
    return (u - 2 ** (bits - 1)).to(torch.int8)


@_k_first
def pack_cids(cid: torch.Tensor) -> torch.Tensor:
    """(K, N) uint8 cluster ids (< 4) → (K/4, N) uint8, 2 bits each."""
    K = cid.shape[0]
    if K % 4:
        raise ValueError(f"K={K} not divisible by 4")
    u = cid.to(torch.int32).reshape(K // 4, 4, *cid.shape[1:])
    byte = torch.zeros_like(u[:, 0])
    for p in range(4):
        byte |= u[:, p] << (2 * p)
    return byte.to(torch.uint8)


@_k_first
def unpack_cids(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_cids`."""
    b = packed.to(torch.int32)
    u = torch.stack([(b >> (2 * p)) & 3 for p in range(4)], dim=1)
    return u.reshape(packed.shape[0] * 4, *packed.shape[1:]).to(torch.uint8)
