"""Synthetic text-classification datasets of the paper's Table 1 (a copy
of ``repro.data.classification``: the port imports nothing from the JAX
package).

The paper uses DAIR.AI emotion (6-way) and UCI SMS spam (2-way). Neither
is available offline, so the tasks are token sequences of matched
structure: class-conditional keyword distributions over a WordPiece-sized
vocab amid a common background band, the problem bert-tiny solves (a few
discriminative tokens amid filler). Keyword rate and label noise put a
fine-tuned bert-tiny in the paper's accuracy regime (~90% for the 6-way
task, ~98% for the binary one).

The datasets are numpy, drawn from a numpy seed with the JAX package's
draws in the JAX package's order, so both packages train on bit-identical
arrays; :func:`batches` hands them out as torch tensors on a device (the
card unless ``device="cpu"``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


@dataclass(frozen=True)
class ClsDataset:
    name: str
    n_classes: int
    seq_len: int
    tokens: np.ndarray     # (N, S) int32
    labels: np.ndarray     # (N,)  int32
    mask: np.ndarray       # (N, S) int32


def _make(name: str, n_classes: int, n_samples: int, seq_len: int,
          vocab: int, keyword_rate: float, n_keywords: int,
          noise: float, seed: int) -> ClsDataset:
    rng = np.random.default_rng(seed)
    # per-class keyword vocab (disjoint), shared background band
    kw = rng.choice(np.arange(1000, vocab), size=(n_classes, n_keywords),
                    replace=False)
    N, S = n_samples, seq_len
    labels = rng.integers(0, n_classes, size=N)
    lengths = rng.integers(S // 4, S, size=N)
    toks = rng.integers(100, 1000, size=(N, S))            # background band
    for i in range(N):
        L = lengths[i]
        n_kw = max(1, int(keyword_rate * L))
        pos = rng.choice(np.arange(1, L), size=min(n_kw, L - 1),
                         replace=False)
        cls = labels[i]
        # label noise: sometimes plant another class's keywords
        eff = cls if rng.random() > noise else rng.integers(0, n_classes)
        toks[i, pos] = rng.choice(kw[eff], size=len(pos))
        toks[i, L:] = 0                                     # pad
    toks[:, 0] = 101                                        # [CLS]
    mask = (toks != 0).astype(np.int32)
    return ClsDataset(name, n_classes, S, toks.astype(np.int32),
                      labels.astype(np.int32), mask)


def emotion_like(n_samples=4000, seq_len=64, vocab=30522, seed=0):
    """6-way, harder task: FP32 accuracy ≈ 0.90 (paper: 90.2%)."""
    return _make("emotion", 6, n_samples, seq_len, vocab,
                 keyword_rate=0.12, n_keywords=24, noise=0.08, seed=seed)


def spam_like(n_samples=4000, seq_len=64, vocab=30522, seed=1):
    """Binary, easier task: FP32 accuracy ≈ 0.98 (paper: 98.4%)."""
    return _make("spam", 2, n_samples, seq_len, vocab,
                 keyword_rate=0.12, n_keywords=60, noise=0.035, seed=seed)


def split(ds: ClsDataset, n_train: int) -> tuple[ClsDataset, ClsDataset]:
    """The first ``n_train`` examples and the rest."""
    part = lambda sl: ClsDataset(ds.name, ds.n_classes, ds.seq_len,
                                 ds.tokens[sl], ds.labels[sl], ds.mask[sl])
    return part(slice(None, n_train)), part(slice(n_train, None))


def batches(ds: ClsDataset, batch_size: int, *, seed=0, train=True,
            epochs=1, device=None):
    """Batches {tokens, labels, mask} of ``batch_size`` examples (a
    partial last batch is dropped), shuffled each epoch from a numpy seed
    when ``train``, as int64 tensors on ``device`` (the card unless
    ``device="cpu"``)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    N = ds.tokens.shape[0]
    for _ in range(epochs):
        idx = rng.permutation(N) if train else np.arange(N)
        for i in range(0, N - batch_size + 1, batch_size):
            j = idx[i:i + batch_size]
            yield {k: torch.from_numpy(getattr(ds, k)[j].astype(np.int64))
                   .to(device) for k in ("tokens", "labels", "mask")}
