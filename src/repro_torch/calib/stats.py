"""Range statistics and the static scales derived from them (port of
``repro.calib.stats``).

:func:`collect_act_stats` runs calibration batches through an encoder's
instrumented forward (``bert_tiny.forward(collect_stats=)``: one forward
a batch emits every layer's statistics at the §4.2 tap sites) and merges
them. :func:`collect_kv_stats` measures per-(layer, kv-head, sub-channel chunk)
min/max of the K/V that the engine's slot cache stores, over seeded
calibration prompts; :func:`kv_static_scales` turns them into the
(S, Z) constants that ``Engine(kv_scales=)`` quantizes with instead of a
runtime min/max reduce. The JAX package reduces the cache of a one-shot
``prefill``; the port has no one-shot forward yet, so it runs the prompts
through ``prefill_chunk_slots`` into an fp32 slot cache and reduces the
rows written: the same K/V, summed in another order (equal to the JAX
function's at fp32 rounding).

:class:`ActStats`, :func:`_merge` and :func:`act_static_scales` are the
numpy half of the activation statistics: they merge per-batch stats and
turn them into the recipe's ``act_scales`` payload, whoever collected
them.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from ..engine.kvcache import init_slot_cache
from ..models import get_model, transformer


@dataclasses.dataclass
class ActStats:
    """Merged activation statistics. ``sites[name]`` maps each stat
    (min/max/p_lo/p_hi one per layer (L,), chunk_min/chunk_max (L, C)) to
    a numpy array."""

    sites: dict
    n_chunks: int
    percentile: float
    n_batches: int = 0


def _merge(acc: Optional[dict], new: dict, n_seen: int) -> dict:
    """Merge one batch's stats into the accumulator: exact running
    min/max, and a running mean of the per-batch percentiles (one batch
    cannot see the global quantiles)."""
    new = {k: {s: np.asarray(v) for s, v in d.items()}
           for k, d in new.items()}
    if acc is None:
        return new
    out = {}
    for site, d in new.items():
        a = acc[site]
        out[site] = {
            "min": np.minimum(a["min"], d["min"]),
            "max": np.maximum(a["max"], d["max"]),
            "chunk_min": np.minimum(a["chunk_min"], d["chunk_min"]),
            "chunk_max": np.maximum(a["chunk_max"], d["chunk_max"]),
            "p_lo": a["p_lo"] + (d["p_lo"] - a["p_lo"]) / (n_seen + 1),
            "p_hi": a["p_hi"] + (d["p_hi"] - a["p_hi"]) / (n_seen + 1),
        }
    return out


@torch.no_grad()
def collect_act_stats(cfg, params, batches: Iterable[dict], *,
                      n_chunks: int = 3, percentile: float = 0.99
                      ) -> ActStats:
    """Per-layer activation ranges at the §4.2 tap sites of an encoder
    (bert-tiny) over an iterable of calibration batches ({tokens, mask},
    arrays or tensors), run on the device ``params`` live on."""
    model = get_model(cfg)
    opts = {"n_chunks": n_chunks, "percentile": percentile}
    device = params["embed"].device
    acc, n = None, 0
    for b in batches:
        tb = {k: (v if isinstance(v, torch.Tensor)
                  else torch.from_numpy(np.asarray(v))).to(device)
              for k, v in b.items() if k in ("tokens", "mask")}
        _, stats = model.forward(params, cfg, tb, collect_stats=opts)
        acc = _merge(acc, {site: {s: v.cpu().numpy() for s, v in d.items()}
                           for site, d in stats.items()}, n)
        n += 1
    if acc is None:
        raise ValueError("no calibration batches")
    return ActStats(sites=acc, n_chunks=n_chunks, percentile=percentile,
                    n_batches=n)


def collect_kv_stats(cfg, params, batches: Iterable[np.ndarray], *,
                     qchunks: int = 4, chunk: int = 96) -> dict:
    """Per-(layer, head, chunk) K/V ranges of a dense model.

    ``batches``: iterable of (B, S) integer token arrays. Each prompt is
    prefilled in chunks of at most ``chunk`` tokens into its own slot of
    an fp32 cache on the device ``params`` live on, and the K/V written
    (L, B, S, Hkv, D) are reduced over batch, position and the channels
    of each sub-channel chunk → min/max (L, Hkv, C), merged across
    batches. Returns {"k_min", "k_max", "v_min", "v_max"} as fp32 numpy
    arrays."""
    D = cfg.head_dim
    if D % qchunks:
        raise ValueError(f"head_dim {D} not divisible by qchunks {qchunks}")
    device = params["embed"].device
    acc = None
    for toks in batches:
        toks = np.asarray(toks, np.int64)
        B, S = toks.shape
        cache = init_slot_cache(cfg, B, S, mode="fp", device=device)
        for b in range(B):
            for done in range(0, S, chunk):
                n = min(chunk, S - done)
                transformer.prefill_chunk_slots(
                    params, cfg, cache,
                    torch.from_numpy(toks[b:b + 1, done:done + n]).to(device),
                    b, done, n)
        r = {}
        for name in ("k", "v"):
            buf = getattr(cache, name)                       # (L, B, S, H, D)
            L, _, _, H, _ = buf.shape
            xc = buf.reshape(L, B, S, H, qchunks, D // qchunks)
            r[f"{name}_min"] = xc.amin(dim=(1, 2, 5)).cpu().numpy()
            r[f"{name}_max"] = xc.amax(dim=(1, 2, 5)).cpu().numpy()
        if acc is None:
            acc = r
        else:
            for kk in ("k_min", "v_min"):
                acc[kk] = np.minimum(acc[kk], r[kk])
            for kk in ("k_max", "v_max"):
                acc[kk] = np.maximum(acc[kk], r[kk])
    if acc is None:
        raise ValueError("no calibration batches")
    return acc


def static_qparams(beta: np.ndarray, alpha: np.ndarray, *, bits: int = 8
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Offline (β, α) → (S, Z) with an exact fractional zero-point: the
    static quantizer folds Z into the rounding, q = rint(S·x + Z), so
    unlike the runtime eq. (3) the zero is not rounded. A constant chunk
    gets S = 1/|v|, which maps v to code ±1 exactly."""
    beta = np.asarray(beta, np.float32)
    alpha = np.asarray(alpha, np.float32)
    qmin = -(2 ** (bits - 1))
    levels = 2 ** bits - 1
    span = alpha - beta
    amax = np.maximum(np.abs(beta), np.abs(alpha))
    degenerate = np.where(amax > 0, 1.0 / np.where(amax > 0, amax, 1.0), 1.0)
    scale = np.where(span > 0, levels / np.where(span > 0, span, 1.0),
                     degenerate).astype(np.float32)
    zero = np.where(span > 0, qmin - scale * beta, 0.0).astype(np.float32)
    return scale, zero


def kv_static_scales(kv_stats: dict, *, bits: int = 8,
                     margin: float = 1.0) -> dict:
    """(β, α) per (L, Hkv, C) → static (S, Z) for the engine slot cache:
    {"k_scale", "k_zero", "v_scale", "v_zero"}. ``margin`` > 1 widens the
    calibrated range symmetrically around its midpoint (headroom against
    values the calibration prompts never produced)."""
    out = {}
    for name in ("k", "v"):
        beta = np.asarray(kv_stats[f"{name}_min"], np.float32)
        alpha = np.asarray(kv_stats[f"{name}_max"], np.float32)
        if margin != 1.0:
            mid = (alpha + beta) / 2
            half = (alpha - beta) / 2 * margin
            beta, alpha = mid - half, mid + half
        scale, zero = static_qparams(beta, alpha, bits=bits)
        out[f"{name}_scale"] = scale
        out[f"{name}_zero"] = zero
    return out


def act_static_scales(stats: ActStats, *, bits: int = 8,
                      use_percentile: bool = False) -> dict:
    """Per-site static activation (S, Z) from merged stats, per layer and
    chunk: {site: {"scale": (L, C), "zero": (L, C)}}, with exact
    fractional zero-points by :func:`static_qparams`. ``use_percentile``
    clips to the calibrated percentile range instead of min/max."""
    out = {}
    for site, d in stats.sites.items():
        beta = np.asarray(d["chunk_min"], np.float32)
        alpha = np.asarray(d["chunk_max"], np.float32)
        if use_percentile:
            beta = np.maximum(beta, d["p_lo"][..., None])
            alpha = np.minimum(alpha, d["p_hi"][..., None])
        scale, zero = static_qparams(beta, alpha, bits=bits)
        out[site] = {"scale": scale, "zero": zero}
    return out
