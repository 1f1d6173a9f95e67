"""1-D k-means with greedy k-means++ seeding (paper §4.1), the port's own.

The JAX package seeds from ``jax.random`` (``repro.core.kmeans``), which
torch cannot reproduce, so this is an independent implementation of the
same algorithm on a ``torch.Generator``: each new center is the best of
``num_candidates`` points drawn ∝ D²(x) (Grunau et al., greedy k-means++),
then ``iters`` Lloyd iterations (segment means; empty clusters keep their
centroid). Every step is deterministic on the card too, so the same seed
gives the same centroids in every run. Centroids come back sorted ascending, so for k=3 they are the
paper's lower / middle / upper clusters.

:func:`kmeans_1d_batched` runs it on B samples at once: the experts of
a MoE layer, E matrices clustered on their own, in one pass of launches
instead of E. Each row draws from a generator of its own
(:func:`row_generators`), so a stack quantized in slabs of rows gets the
same centroids whatever the slab; :func:`kmeans_1d` is the one-row case
on the generator it is given.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # (k,) sorted ascending
    cost: torch.Tensor         # scalar: sum of squared distances


def kmeans_1d(gen: torch.Generator, x: torch.Tensor, k: int = 3,
              iters: int = 25, num_candidates: int = 4) -> KMeansResult:
    """Lloyd's algorithm on 1-D data with greedy k-means++ seeding."""
    x = x.reshape(1, -1).float()
    centers = _kmeans([gen], x, k, iters, num_candidates)[0]
    return KMeansResult(centers,
                        ((x[0, :, None] - centers) ** 2).min(1).values.sum())


def row_generators(gen: torch.Generator, B: int) -> list:
    """B generators on ``gen``'s device, each seeded from one draw of
    ``gen``: a stack's rows each draw from their own, so a row's
    centroids do not depend on the rows it is computed beside."""
    seeds = torch.randint(0, 1 << 62, (B,), generator=gen,
                          device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(s)
            for s in seeds]


def kmeans_1d_batched(gen, x: torch.Tensor, k: int = 3, iters: int = 25,
                      num_candidates: int = 4) -> torch.Tensor:
    """:func:`kmeans_1d` of each row of ``x`` (B, n): greedy k-means++
    seeding and Lloyd's iterations, every row on its own. ``gen``: one
    generator per row (a list, as :func:`row_generators` gives), or a
    generator that seeds them, so the draws of a row are the same in any
    batch of rows. Returns the (B, k) centroids, each row sorted
    ascending."""
    if isinstance(gen, torch.Generator):
        gen = row_generators(gen, x.shape[0])
    return _kmeans(gen, x, k, iters, num_candidates)


def _kmeans(gens, x: torch.Tensor, k: int, iters: int,
            num_candidates: int) -> torch.Tensor:
    """The batched k-means of :func:`kmeans_1d_batched`, row b drawing
    from ``gens[b]``."""
    x = x.float()
    B, n = x.shape
    if n > 1 << 24:
        raise ValueError(f"k-means++ draws from torch.multinomial, which "
                         f"takes at most 2^24 categories; got {n} points a "
                         f"row (fit on a smaller sample)")

    def draw(fn, t):
        """fn(generator, row of t), each row from its own generator."""
        return torch.cat([fn(g, t[b:b + 1]) for b, g in enumerate(gens)])

    rows = torch.arange(B, device=x.device)
    first = x[rows, draw(lambda g, t: torch.randint(
        0, n, (t.shape[0],), generator=g, device=x.device), x)]     # (B,)
    centers = first[:, None].repeat(1, k)
    d2 = (x - first[:, None]) ** 2
    for i in range(1, k):
        total = d2.sum(1, keepdim=True)
        # all points equal ⇒ every distance is 0: draw uniformly instead
        w = torch.where(total > 0, d2, torch.ones_like(d2))
        idx = draw(lambda g, t: torch.multinomial(
            t, num_candidates, replacement=True, generator=g), w)   # (B, ℓ)
        cand = torch.gather(x, 1, idx)
        new_cost = torch.minimum(d2[:, :, None],
                                 (x[:, :, None] - cand[:, None, :]) ** 2
                                 ).sum(1)                           # (B, ℓ)
        chosen = torch.gather(cand, 1, torch.argmin(new_cost, 1,
                                                    keepdim=True))  # (B, 1)
        centers[:, i] = chosen[:, 0]
        d2 = torch.minimum(d2, (x - chosen) ** 2)
    ks = torch.arange(k, device=x.device)
    for _ in range(iters):
        assign = torch.argmin((x[:, :, None] - centers[:, None, :]) ** 2,
                              dim=2)                                # (B, n)
        # a reduction, not index_add_: CUDA's float atomics sum in a
        # different order each run, and a rebuilt model (a recovering
        # process) must get the same centroids
        member = assign[:, :, None] == ks
        counts = member.sum(1).float()                              # (B, k)
        sums = torch.where(member, x[:, :, None], 0.0).sum(1)
        centers = torch.where(counts > 0, sums / counts.clamp(min=1),
                              centers)
    return torch.sort(centers, dim=1).values
