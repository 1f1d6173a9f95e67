"""Deterministic, restart-safe data pipeline (port of
``repro.data.pipeline``).

The pipeline is stateless: a batch is a pure function of (seed, step,
shard), so a restart needs only the step counter and re-sharding is
another (shard, n_shards) map over the same index space. The tokens are
drawn in numpy with the JAX package's draws, so both packages see the
same int32 tokens for each (seed, step, shard, n_shards); the port hands
them out as tensors on a device (the card unless ``device="cpu"``). A
background thread prefetches ahead of the training loop.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "lm"          # lm | classification


def synthetic_lm_batch(cfg: DataConfig, step: int, shard: int = 0,
                       n_shards: int = 1, device=None) -> dict:
    """{"tokens", "labels"} (global_batch / n_shards, seq_len) int32 on
    ``device``: a stream x_{t+1} = (31·x_t + drift) mod V, each token
    replaced by a uniform one with probability 0.1 (so the next token is
    learnable), and the same stream one step ahead."""
    device = resolve_device(device)
    per_shard = cfg.global_batch // n_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))
    B, S, V = per_shard, cfg.seq_len, cfg.vocab
    a = 31
    x0 = rng.integers(0, V, size=(B, 1))
    drift = rng.integers(0, 7, size=(B, 1))
    toks = np.empty((B, S + 1), np.int64)
    toks[:, :1] = x0
    for t in range(S):
        nxt = (a * toks[:, t:t + 1] + drift) % V
        noise = rng.random((B, 1)) < 0.1
        rand = rng.integers(0, V, size=(B, 1))
        toks[:, t + 1:t + 2] = np.where(noise, rand, nxt)
    toks = toks.astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(device)}


class Prefetcher:
    """Runs ``make_batch(step)`` in a background thread, ``depth`` batches
    ahead. ``get(step)`` returns the batch of ``step``. After a restart
    from an earlier checkpoint (a step behind the thread's), the batch is
    made in the caller, since it is a pure function of its step, and the
    thread's batches ahead are kept until their steps come again (the JAX
    package's ``get`` waits forever there)."""

    def __init__(self, make_batch, start_step: int, depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next_to_produce = start_step
        self._ahead: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            step = self._next_to_produce
            batch = self._make(step)
            self._q.put((step, batch))
            self._next_to_produce = step + 1

    def get(self, step: int):
        for s in [s for s in self._ahead if s < step]:
            del self._ahead[s]
        if step in self._ahead:
            return self._ahead.pop(step)
        while True:
            s, b = self._q.get()
            if s == step:
                return b
            if s > step:                  # rewound by a restart
                self._ahead[s] = b
                return self._make(step)
            # a stale batch: drop it

    def stop(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
