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
"""
from __future__ import annotations

import dataclasses

import torch

from .kmeans import kmeans_1d
from .quantize import QuantConfig, dequantize, qparams, quantize

_BIG = torch.finfo(torch.float32).max


@dataclasses.dataclass
class SplitQuantTensor:
    """One matrix or vector quantized with per-tensor per-cluster scales
    (k=1 is plain per-tensor PTQ)."""

    q: torch.Tensor        # int8 codes, orig shape
    cid: torch.Tensor      # uint8 cluster ids, orig shape
    scale: torch.Tensor    # (k,) fp32
    zero: torch.Tensor     # (k,) fp32
    bits: int
    k: int
    orig_dtype: torch.dtype

    @property
    def shape(self):
        return tuple(self.q.shape)

    def dequantize(self) -> torch.Tensor:
        c = self.cid.long()
        return dequantize(self.q, self.scale[c], self.zero[c], self.orig_dtype)


def strided_sample(flat: torch.Tensor, sample_size: int) -> torch.Tensor:
    """The ≤ ``sample_size`` strided sample the centroids are fit on."""
    n = flat.shape[0]
    if n <= sample_size:
        return flat
    return flat[::n // sample_size][:sample_size]


def fit_centroids(gen: torch.Generator, w: torch.Tensor, k: int = 3,
                  sample_size: int = 1 << 18, kmeans_iters: int = 25
                  ) -> torch.Tensor:
    """Sorted (k,) centroids of ``w``'s values (k-means on a sample)."""
    sample = strided_sample(w.float().reshape(-1), sample_size)
    return kmeans_1d(gen, sample, k=k, iters=kmeans_iters).centroids


def assign_and_quantize(w: torch.Tensor, centroids: torch.Tensor,
                        cfg: QuantConfig) -> SplitQuantTensor:
    """Assign every element to its nearest centroid (first index on ties,
    as ``argmin``) and quantize each cluster with its own min/max range."""
    wf = w.float()
    k = centroids.shape[0]
    # running argmin over the k centroids: no (…, k) distance tensor, and
    # the strict ``<`` keeps the first index on ties
    best = (wf - centroids[0]) ** 2
    cid = torch.zeros(w.shape, dtype=torch.uint8, device=w.device)
    for c in range(1, k):
        d = (wf - centroids[c]) ** 2
        closer = d < best
        best = torch.where(closer, d, best)
        cid[closer] = c
    return quantize_clusters(wf, cid, k, cfg, w.dtype)


def quantize_clusters(wf: torch.Tensor, cid: torch.Tensor, k: int,
                      cfg: QuantConfig, orig_dtype) -> SplitQuantTensor:
    """Per-cluster min/max ranges → (scale, zero) → codes."""
    betas, alphas = [], []
    for c in range(k):
        mask = cid == c
        lo = torch.where(mask, wf, _BIG).min()
        hi = torch.where(mask, wf, -_BIG).max()
        empty = ~mask.any()
        betas.append(torch.where(empty, 0.0, lo))
        alphas.append(torch.where(empty, 0.0, hi))
    scale, zero = qparams(torch.stack(betas), torch.stack(alphas), cfg)
    c = cid.long()
    q = quantize(wf, scale[c], zero[c], cfg)
    return SplitQuantTensor(q=q, cid=cid, scale=scale, zero=zero,
                            bits=cfg.bits, k=k, orig_dtype=orig_dtype)


def splitquant_tensor(gen: torch.Generator, w: torch.Tensor,
                      cfg: QuantConfig, k: int = 3,
                      sample_size: int = 1 << 18,
                      kmeans_iters: int = 25) -> SplitQuantTensor:
    """Cluster ``w``'s values into k groups and quantize each with its own
    scale (paper §4.1). ``k=1`` degenerates to baseline per-tensor PTQ."""
    if k == 1:
        cid = torch.zeros(w.shape, dtype=torch.uint8, device=w.device)
        return quantize_clusters(w.float(), cid, 1, cfg, w.dtype)
    cents = fit_centroids(gen, w, k, sample_size, kmeans_iters)
    return assign_and_quantize(w, cents, cfg)


def baseline_quant_tensor(w: torch.Tensor, cfg: QuantConfig
                          ) -> SplitQuantTensor:
    """Plain per-tensor PTQ (one min/max scale set) as k=1."""
    return splitquant_tensor(None, w, cfg, k=1)


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
