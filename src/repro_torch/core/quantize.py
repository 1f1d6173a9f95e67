"""Uniform affine quantization (paper §3), PyTorch port of
``repro.core.quantize``.

Q(x)  = INT(S·x) + Z                      (eq. 1)
S     = (2^b - 1) / (α - β)               (eq. 2)
Z     = -2^(b-1) - INT(S·β)               (eq. 3)
x̂     = (Q(x) - Z) / S                    (eq. 4-6)

Codes are bit-identical to the JAX package: every step is the same fp32
operation in the same order, ``(levels-1)/span`` stays a true division,
and ``torch.round`` rounds half to even like ``jnp.rint``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of a uniform quantizer (min/max ranges; the
    percentile and per-channel options of the JAX package are not ported
    yet)."""

    bits: int = 8
    symmetric: bool = False

    def __post_init__(self):
        if not (2 <= self.bits <= 8):
            raise ValueError(f"bits must be in [2, 8], got {self.bits}")

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def levels(self) -> int:
        return 2 ** self.bits


def value_range(x: torch.Tensor, dim=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(β, α) = (min, max) of ``x`` in fp32, over ``dim`` (None = all)."""
    x = x.float()
    if dim is None:
        return x.min(), x.max()
    return torch.amin(x, dim=dim), torch.amax(x, dim=dim)


def qparams(beta, alpha, cfg: QuantConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Scale S and zero-point Z per eqs. (2)-(3).

    Degenerate ranges (α == β) get S = 1/|v| so the single value v maps to
    code ±1 and dequantizes exactly (S = 1 when v = 0)."""
    beta = torch.as_tensor(beta, dtype=torch.float32)
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    if cfg.symmetric:
        amax = torch.maximum(beta.abs(), alpha.abs())
        beta, alpha = -amax, amax
    span = alpha - beta
    amax = torch.maximum(beta.abs(), alpha.abs())
    one = torch.ones_like(amax)
    degenerate = torch.where(amax > 0, one / torch.where(amax > 0, amax, one),
                             one)
    levels = torch.full_like(span, float(cfg.levels - 1))
    scale = torch.where(span > 0, levels / torch.where(span > 0, span, one),
                        degenerate)
    if cfg.symmetric:
        zero = torch.zeros_like(scale)
    else:
        zero = -float(2 ** (cfg.bits - 1)) - torch.round(scale * beta)
    return scale, zero


def quantize(x: torch.Tensor, scale, zero, cfg: QuantConfig) -> torch.Tensor:
    """x → int8 codes in [qmin, qmax] (eq. 1, clipped to the code range)."""
    q = torch.round(scale * x.float()) + zero
    return torch.clamp(q, cfg.qmin, cfg.qmax).to(torch.int8)


def dequantize(q: torch.Tensor, scale, zero,
               dtype=torch.float32) -> torch.Tensor:
    """Codes → x̂ per eq. (4)."""
    return ((q.float() - zero) / scale).to(dtype)
