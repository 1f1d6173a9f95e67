"""Uniform affine quantization (paper §3), PyTorch port of
``repro.core.quantize``.

Q(x)  = INT(S·x) + Z                      (eq. 1)
S     = (2^b - 1) / (α - β)               (eq. 2)
Z     = -2^(b-1) - INT(S·β)               (eq. 3)
x̂     = (Q(x) - Z) / S                    (eq. 4-6)

Codes are bit-identical to the JAX package: every step is the same fp32
operation in the same order, ``(levels-1)/span`` stays a true division,
and ``torch.round`` rounds half to even like ``jnp.rint``.

Percentile ranges are written out as ``jnp.percentile`` computes them
(method "linear"), not with ``torch.quantile``, which refuses inputs
above 2^24 elements (an lm_head has 205 M): sort, the fractional rank
in fp32, and the two neighbours weighted in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of a uniform quantizer."""

    bits: int = 8
    symmetric: bool = False
    #: keep values within this percentile when computing the range
    #: (paper §1: "often 99% is used in practice"); None = min/max
    percentile: Optional[float] = None
    #: quantize per output channel instead of per tensor (beyond the
    #: paper, which uses per-tensor scales per split layer)
    per_channel: bool = False

    def __post_init__(self):
        if not (2 <= self.bits <= 8):
            raise ValueError(f"bits must be in [2, 8], got {self.bits}")
        if self.percentile is not None and not (0.5 < self.percentile <= 1.0):
            raise ValueError(f"percentile must be in (0.5, 1], got "
                             f"{self.percentile}")

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def levels(self) -> int:
        return 2 ** self.bits


def linear_percentile(x: torch.Tensor, q: float, dim=None) -> torch.Tensor:
    """The ``q``-th percentile (0-100) of ``x`` over ``dim`` (None = all;
    an int or a tuple) as ``jnp.percentile(method="linear")`` computes it
    in fp32: the fractional rank fp32(q) · (fp32(0.01) · (n - 1)) (JAX
    writes (q / 100) · (n - 1) with n in fp32; XLA compiles the division
    as a product with 0.01 and folds the two constants into one), its
    floor and ceil (clamped) pick two sorted values,
    weighted (1 - w) and w with w = rank - floor; two products and a sum,
    each rounded on its own (XLA's CPU code contracts one product and the
    sum into an FMA: an ulp apart at most)."""
    x = x.float()
    if dim is None:
        x = x.reshape(-1)
    else:
        dims = sorted(d % x.dim() for d in
                      ((dim,) if isinstance(dim, int) else dim))
        keep = [d for d in range(x.dim()) if d not in dims]
        x = x.permute(*keep, *dims).reshape(*(x.shape[d] for d in keep), -1)
    srt = torch.sort(x, dim=-1).values
    f32 = dict(dtype=torch.float32)
    n = torch.tensor(float(srt.shape[-1]), **f32)
    rank = torch.tensor(float(q), **f32) * \
        (torch.tensor(0.01, **f32) * (n - 1))
    low, high = torch.floor(rank), torch.ceil(rank)
    w_high = rank - low
    w_low = 1 - w_high
    top = n - 1
    lo_i = int(torch.clamp(low, min=0).minimum(top))
    hi_i = int(torch.clamp(high, min=0).minimum(top))
    return srt[..., lo_i] * w_low.to(x.device) + \
        srt[..., hi_i] * w_high.to(x.device)


def value_range(x: torch.Tensor, percentile: Optional[float] = None,
                dim=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(β, α) of ``x`` in fp32 over ``dim`` (None = all): its min and max,
    or, given ``percentile`` p in (0.5, 1], its (1 - p)·100-th and
    p·100-th percentiles (the JAX package's ``value_range(x, percentile,
    axis)``)."""
    x = x.float()
    if percentile is not None:
        return (linear_percentile(x, (1.0 - percentile) * 100.0, dim),
                linear_percentile(x, percentile * 100.0, dim))
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


def fake_quant(x: torch.Tensor, cfg: QuantConfig, dim=None) -> torch.Tensor:
    """Simulated quantization: dequantize(quantize(x)) with ranges from x,
    in x's dtype. ``dim``: the range's reduction dims (None = per
    tensor); ``cfg.per_channel`` on a matrix reduces all but dim 0, one
    range per row, as the JAX package's ``fake_quant``."""
    if dim is None and cfg.per_channel and x.dim() >= 2:
        dim = tuple(range(1, x.dim()))
    beta, alpha = value_range(x, cfg.percentile, dim)
    if dim is not None:
        for d in sorted(d % x.dim() for d in
                        ((dim,) if isinstance(dim, int) else dim)):
            beta, alpha = beta.unsqueeze(d), alpha.unsqueeze(d)
    scale, zero = qparams(beta, alpha, cfg)
    return dequantize(quantize(x, scale, zero, cfg), scale, zero, x.dtype)


def quant_error(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Mean squared error of the quantizer on x."""
    return torch.mean((x - fake_quant(x, cfg)) ** 2)
