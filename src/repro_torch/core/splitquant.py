"""SplitQuant (paper §4), PyTorch port of ``repro.core.splitquant``: split
each quantizable tensor into k=3 mathematically equivalent parts with
separate quantization parameters.

As in the JAX package the three mostly-zero split layers are never
materialized: a tensor keeps one low-bit code ``q`` and one cluster id
``cid`` per element plus per-cluster ``scale``/``zero``, and

    Ŵ = Σ_c  mask_c · dequant(q; scale_c, zero_c)

is exactly the paper's sum of split layers. Quantization is split in two
so that the tests can feed the JAX package's centroids and demand
identical codes: :func:`fit_centroids` (the port's own k-means on a
strided sample) and :func:`assign_and_quantize` (nearest centroid, first
index on ties, then per-cluster min/max → eqs. 1-3).

With ``cfg.per_channel`` the ranges are per (cluster, output column):
``scale``/``zero`` are (k, out) and each element takes its cluster's
value in its column. ``k=1`` with ``cfg.percentile`` is the percentile
clipping baseline the paper argues against: one range from the clipped
distribution (per tensor, or per column).

``stack_dims=1`` quantizes a stack of matrices (E, K, N), the experts of
a MoE layer, each on its own, as the JAX package's ``stack_dims`` (a
``vmap``) does: codes and ids (E, K, N), scales (E, k) or (E, k, N); the
k-means of the E matrices runs as one batched pass
(:func:`~repro_torch.core.kmeans.kmeans_1d_batched`).
"""
from __future__ import annotations

import dataclasses

import torch

from .kmeans import kmeans_1d, kmeans_1d_batched
from .quantize import (QuantConfig, dequantize, linear_percentile, qparams,
                       quantize)

_BIG = torch.finfo(torch.float32).max


@dataclasses.dataclass
class SplitQuantTensor:
    """One matrix or vector quantized with per-cluster scales, per tensor
    (k,) or per output column (k, out) (k=1 is plain PTQ)."""

    q: torch.Tensor        # int8 codes, orig shape
    cid: torch.Tensor      # uint8 cluster ids, orig shape
    scale: torch.Tensor    # (k,) or (k, out) fp32
    zero: torch.Tensor     # like scale
    bits: int
    k: int
    orig_dtype: torch.dtype
    stack_dims: int = 0    # leading axes of matrices quantized on their own

    @property
    def shape(self):
        return tuple(self.q.shape)

    def to(self, device) -> "SplitQuantTensor":
        mv = {f: getattr(self, f).to(device)
              for f in ("q", "cid", "scale", "zero")}
        return dataclasses.replace(self, **mv)

    @property
    def per_channel(self) -> bool:
        return self.scale.dim() - self.stack_dims == 2

    def _select(self, vals: torch.Tensor) -> torch.Tensor:
        """(*stack, k) or (*stack, k, out) → each element's value of its
        cluster (and column)."""
        return select_per_element(vals, self.cid, self.stack_dims)

    def dequantize(self) -> torch.Tensor:
        return dequantize(self.q, self._select(self.scale),
                          self._select(self.zero), self.orig_dtype)

    def split_layers(self) -> list[torch.Tensor]:
        """The paper's literal k split tensors: Ŵ_c = Ŵ ⊙ [cid == c]."""
        w_hat = self.dequantize()
        return [torch.where(self.cid == c, w_hat, 0).to(self.orig_dtype)
                for c in range(self.k)]

    def nbytes_deployed(self) -> int:
        """Deployed footprint, as the JAX package counts it: packed codes
        + 2-bit cids + scales."""
        return deployed_bytes(self.q.numel(), self.bits, self.k,
                              self.scale.numel() + self.zero.numel())


def deployed_bytes(n: int, bits: int, k: int, n_constants: int) -> int:
    """The JAX package's deployed count of n codes at ``bits`` with k
    clusters (2-bit ids when k > 1) and ``n_constants`` fp32 scales and
    zeros."""
    return (bits * n + (2 * n if k > 1 else 0)) // 8 + 4 * n_constants


def select_per_element(vals: torch.Tensor, cid: torch.Tensor,
                       stack: int = 0) -> torch.Tensor:
    """Per-cluster values (*stack, k), or per (cluster, last-axis column)
    (*stack, k, out), taken per element by its cluster id; ``cid`` is
    (*stack, *matrix)."""
    c = cid.long()
    lead = cid.shape[:stack]
    if vals.dim() - stack == 1:
        return torch.gather(vals, -1, c.reshape(*lead, -1)).reshape(
            cid.shape)
    return torch.gather(vals, -2, c.reshape(*lead, -1, cid.shape[-1])
                        ).reshape(cid.shape)


def strided_sample(flat: torch.Tensor, sample_size: int) -> torch.Tensor:
    """The ≤ ``sample_size`` strided sample the centroids are fit on (of
    each row of a 2-D ``flat``)."""
    n = flat.shape[-1]
    if n <= sample_size:
        return flat
    return flat[..., ::n // sample_size][..., :sample_size]


def fit_centroids(gen: torch.Generator, w: torch.Tensor, k: int = 3,
                  sample_size: int = 1 << 18, kmeans_iters: int = 25,
                  stack_dims: int = 0) -> torch.Tensor:
    """Sorted (k,) centroids of ``w``'s values (k-means on a sample), or
    with ``stack_dims=1`` the (E, k) centroids of each of its E matrices,
    fit together."""
    # the sample first: only its values are widened to fp32
    sample = strided_sample(w.reshape(*w.shape[:stack_dims], -1),
                            sample_size).float()
    if not stack_dims:
        return kmeans_1d(gen, sample, k=k, iters=kmeans_iters).centroids
    return kmeans_1d_batched(gen, sample, k=k, iters=kmeans_iters)


def assign_and_quantize(w: torch.Tensor, centroids: torch.Tensor,
                        cfg: QuantConfig, stack_dims: int = 0
                        ) -> SplitQuantTensor:
    """Assign every element to its nearest centroid (first index on ties,
    as ``argmin``) and quantize each cluster with its own min/max range.
    ``centroids``: (*stack, k)."""
    wf = w.float()
    cid = assign_clusters(wf, centroids, stack_dims)
    return quantize_clusters(wf, cid, centroids.shape[-1], cfg, w.dtype,
                             stack_dims)


def assign_clusters(wf: torch.Tensor, centroids: torch.Tensor,
                    stack_dims: int = 0) -> torch.Tensor:
    """uint8 id of each element's nearest centroid (first index on ties,
    as ``argmin``); ``centroids`` (*stack, k)."""
    k = centroids.shape[-1]
    cents = centroids.reshape(*wf.shape[:stack_dims],
                              *(1,) * (wf.dim() - stack_dims), k)
    # running argmin over the k centroids: no (…, k) distance tensor, and
    # the strict ``<`` keeps the first index on ties
    best = (wf - cents[..., 0]) ** 2
    cid = torch.zeros(wf.shape, dtype=torch.uint8, device=wf.device)
    for c in range(1, k):
        d = (wf - cents[..., c]) ** 2
        closer = d < best
        best = torch.where(closer, d, best)
        cid[closer] = c
    return cid


def masked_min_max(x: torch.Tensor, mask: torch.Tensor, dim):
    """(min, max, any) of x where mask over ``dim``; ±``_BIG`` where mask
    holds nothing. Slabs of x combine exactly (min, max, or)."""
    return (torch.where(mask, x, _BIG).amin(dim=dim),
            torch.where(mask, x, -_BIG).amax(dim=dim), mask.any(dim=dim))


def empty_to_zero(lo, hi, any_):
    """A degenerate [0, 0] range where the mask held nothing."""
    return torch.where(any_, lo, 0.0), torch.where(any_, hi, 0.0)


def _masked_range(x: torch.Tensor, mask: torch.Tensor, dim):
    """min/max of x where mask over ``dim``, a degenerate [0, 0] range
    where mask holds nothing."""
    return empty_to_zero(*masked_min_max(x, mask, dim))


def quantize_clusters(wf: torch.Tensor, cid: torch.Tensor, k: int,
                      cfg: QuantConfig, orig_dtype, stack_dims: int = 0
                      ) -> SplitQuantTensor:
    """Per-cluster min/max ranges of each matrix of the stack (per output
    column with ``cfg.per_channel``: over the rows of each (cluster,
    column)) → (scale, zero) → codes."""
    per_col = cfg.per_channel and wf.dim() - stack_dims >= 2
    red = tuple(range(stack_dims, wf.dim() - (1 if per_col else 0)))
    ranges = [_masked_range(wf, cid == c, red) for c in range(k)]
    scale, zero = qparams(torch.stack([r[0] for r in ranges], stack_dims),
                          torch.stack([r[1] for r in ranges], stack_dims),
                          cfg)
    q = quantize(wf, select_per_element(scale, cid, stack_dims),
                 select_per_element(zero, cid, stack_dims), cfg)
    return SplitQuantTensor(q=q, cid=cid, scale=scale, zero=zero,
                            bits=cfg.bits, k=k, orig_dtype=orig_dtype,
                            stack_dims=stack_dims)


def percentile_quant(w: torch.Tensor, cfg: QuantConfig) -> SplitQuantTensor:
    """k=1 with ``cfg.percentile``: the range from the clipped
    distribution, per tensor (scale (1,)) or, with ``cfg.per_channel``,
    per output column over the rows (scale (1, out)); codes clip to the
    code range."""
    wf = w.float()
    p = cfg.percentile
    if cfg.per_channel and w.dim() >= 2:
        red = tuple(range(w.dim() - 1))
        beta = linear_percentile(wf, (1 - p) * 100, red)[None]
        alpha = linear_percentile(wf, p * 100, red)[None]
    else:
        beta = linear_percentile(wf, (1 - p) * 100).reshape(1)
        alpha = linear_percentile(wf, p * 100).reshape(1)
    scale, zero = qparams(beta, alpha, cfg)
    cid = torch.zeros(w.shape, dtype=torch.uint8, device=w.device)
    q = quantize(wf, scale[0], zero[0], cfg)
    return SplitQuantTensor(q=q, cid=cid, scale=scale, zero=zero,
                            bits=cfg.bits, k=1, orig_dtype=w.dtype)


def splitquant_tensor(gen: torch.Generator, w: torch.Tensor,
                      cfg: QuantConfig, k: int = 3,
                      sample_size: int = 1 << 18,
                      kmeans_iters: int = 25,
                      stack_dims: int = 0) -> SplitQuantTensor:
    """Cluster ``w``'s values into k groups and quantize each with its own
    scale (paper §4.1). ``k=1`` degenerates to baseline per-tensor PTQ
    (percentile-clipped with ``cfg.percentile``). ``stack_dims=1``: each
    matrix of a (E, K, N) stack on its own."""
    if k == 1 and cfg.percentile is not None:
        if stack_dims:
            parts = [percentile_quant(m, cfg) for m in w]
            return dataclasses.replace(
                parts[0], stack_dims=1, **{
                    f: torch.stack([getattr(p, f) for p in parts])
                    for f in ("q", "cid", "scale", "zero")})
        return percentile_quant(w, cfg)
    if k == 1:
        cid = torch.zeros(w.shape, dtype=torch.uint8, device=w.device)
        return quantize_clusters(w.float(), cid, 1, cfg, w.dtype,
                                 stack_dims)
    cents = fit_centroids(gen, w, k, sample_size, kmeans_iters, stack_dims)
    return assign_and_quantize(w, cents, cfg, stack_dims)


def baseline_quant_tensor(w: torch.Tensor, cfg: QuantConfig,
                          stack_dims: int = 0) -> SplitQuantTensor:
    """Plain PTQ (one scale set; the percentile clip with
    ``cfg.percentile``) as k=1."""
    return splitquant_tensor(None, w, cfg, k=1, stack_dims=stack_dims)


def activation_chunk_bounds(n: int, n_chunks: int) -> list[int]:
    """§4.2 chunk boundaries along an axis of width ``n``: the
    ``array_split`` partition (the first ``n % n_chunks`` chunks one
    element wider), so indivisible widths still split into ``n_chunks``
    parts."""
    n_chunks = max(1, min(n_chunks, n))
    base, rem = divmod(n, n_chunks)
    bounds = [0]
    for c in range(n_chunks):
        bounds.append(bounds[-1] + base + (1 if c < rem else 0))
    return bounds


def split_activation_fake_quant(x: torch.Tensor, cfg: QuantConfig,
                                n_chunks: int = 3, dim: int = -1
                                ) -> torch.Tensor:
    """Paper §4.2, simulated: split an activation along ``dim`` into
    ``n_chunks`` chunks (the ``array_split`` partition, so indivisible
    widths still split), quantize each with its own dynamic min/max
    range, and concatenate, in x's dtype."""
    dim = dim % x.dim()
    outs = []
    for part in torch.tensor_split(x, max(1, min(n_chunks, x.shape[dim])),
                                   dim=dim):
        scale, zero = qparams(part.float().min(), part.float().max(), cfg)
        outs.append(dequantize(quantize(part, scale, zero, cfg), scale,
                               zero, x.dtype))
    return torch.cat(outs, dim=dim)


def effective_scales(sqt: SplitQuantTensor) -> torch.Tensor:
    """Per-cluster scale factors, the paper's resolution metric (§4:
    a larger S is a finer resolution)."""
    return sqt.scale
