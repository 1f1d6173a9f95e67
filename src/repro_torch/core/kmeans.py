"""1-D k-means with greedy k-means++ seeding (paper §4.1), the port's own.

The JAX package seeds from ``jax.random`` (``repro.core.kmeans``), which
torch cannot reproduce, so this is an independent implementation of the
same algorithm on a ``torch.Generator``: each new center is the best of
``num_candidates`` points drawn ∝ D²(x) (Grunau et al., greedy k-means++),
then ``iters`` Lloyd iterations (segment means; empty clusters keep their
centroid). Every step is deterministic on the card too, so the same seed
gives the same centroids in every run. Centroids come back sorted ascending, so for k=3 they are the
paper's lower / middle / upper clusters.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # (k,) sorted ascending
    cost: torch.Tensor         # scalar: sum of squared distances


def _dist2(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return (x[:, None] - centers[None, :]) ** 2


def _greedy_kmeanspp_init(gen: torch.Generator, x: torch.Tensor, k: int,
                          num_candidates: int) -> torch.Tensor:
    n = x.shape[0]
    first = x[torch.randint(0, n, (1,), generator=gen, device=x.device)]
    centers = first.repeat(k)
    d2 = (x - first) ** 2
    for i in range(1, k):
        total = d2.sum()
        # all points equal ⇒ every distance is 0: draw uniformly instead
        w = torch.where(total > 0, d2, torch.ones_like(d2))
        idx = torch.multinomial(w, num_candidates, replacement=True,
                                generator=gen)
        cand = x[idx]                                           # (ℓ,)
        new_cost = torch.minimum(d2[:, None], _dist2(x, cand)).sum(0)
        chosen = cand[torch.argmin(new_cost)]
        centers[i] = chosen
        d2 = torch.minimum(d2, (x - chosen) ** 2)
    return centers


def kmeans_1d(gen: torch.Generator, x: torch.Tensor, k: int = 3,
              iters: int = 25, num_candidates: int = 4) -> KMeansResult:
    """Lloyd's algorithm on 1-D data with greedy k-means++ seeding."""
    x = x.reshape(-1).float()
    centers = _greedy_kmeanspp_init(gen, x, k, num_candidates)
    for _ in range(iters):
        assign = torch.argmin(_dist2(x, centers), dim=1)
        counts = torch.bincount(assign, minlength=k).float()
        # a reduction, not index_add_: CUDA's float atomics sum in a
        # different order each run, and a rebuilt model (a recovering
        # process) must get the same centroids
        member = assign[:, None] == torch.arange(k, device=x.device)
        sums = torch.where(member, x[:, None], 0.0).sum(0)
        centers = torch.where(counts > 0, sums / counts.clamp(min=1), centers)
    centers = torch.sort(centers).values
    return KMeansResult(centers, _dist2(x, centers).min(1).values.sum())
