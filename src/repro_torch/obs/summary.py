"""Shared empty-guarded summary math (port of ``repro.obs.summary``):
the percentile and mean ``Engine.metrics()`` reports, and the token
agreement of two finished-request lists. Everything returns ``None`` on
empty input — metrics dicts serialize ``None``, never NaN.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def pct(values, q: float) -> Optional[float]:
    """Percentile with empty guard: ``None`` when there are no samples."""
    a = np.asarray(values, np.float64)
    return float(np.percentile(a, q)) if a.size else None


def mean(values) -> Optional[float]:
    a = np.asarray(values, np.float64)
    return float(a.mean()) if a.size else None


def summarize(values, percentiles: Sequence[float] = (50, 95)) -> dict:
    """``{"count", "mean", "p50", "p95", ...}`` with None-on-empty values
    (``p50``/``p95`` keys follow the requested ``percentiles``)."""
    a = np.asarray(values, np.float64)
    out = {"count": int(a.size), "mean": mean(a)}
    for q in percentiles:
        out[f"p{q:g}"] = pct(a, q)
    return out


def token_agreement(a, b) -> Optional[float]:
    """Mean per-request fraction of position-wise equal tokens between two
    finished-request lists (objects with ``.out`` token lists). The
    greedy-equivalence metric every benchmark tracks."""
    per = [mean([x == y for x, y in zip(ra.out, rb.out)]) or 0.0
           for ra, rb in zip(a, b)]
    return mean(per)
