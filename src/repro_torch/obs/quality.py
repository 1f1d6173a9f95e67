"""Quantization-quality counters (port of ``repro.obs.quality``;
host-side, numpy).

SplitQuant keeps low-bit error down by giving every sub-channel chunk its
own range — so the runtime questions that matter are the ones the
calibration pass answers offline (``calib/stats.py``): how often do codes
saturate, how much of the code range does a chunk actually occupy (a
static scale that leaves half the levels unused has drifted), and which
chunks are range outliers (OCS/OverQ's motivating measurement, taken live
instead of on a calibration set). These helpers compute those three
counters from quantizer OUTPUTS — int8 codes and (scale, zero) arrays on
the host — so the kernels stay untouched;
``engine.kvcache.kv_quality_counters`` feeds them, and the engine samples
it into the trace as a ``counter`` record every ``trace_kv_every`` steps
and into the registry's gauges every ``metrics_kv_every`` steps.
:class:`ActQuantProbe` folds activation-quantizer outputs the same way.
"""
from __future__ import annotations

import numpy as np

#: log2(chunk span / per-layer median span) bucket edges for the
#: outlier-chunk histogram: [<¼×, ¼–½×, ½–1×, 1–2×, 2–4×, 4–8×, >8×]
OUTLIER_LOG2_EDGES = (-2.0, -1.0, 0.0, 1.0, 2.0, 3.0)


def code_stats(q, bits: int = 8) -> dict:
    """Saturation + occupancy from int8 codes alone.

    ``clip_frac``: fraction of codes pinned at qmin/qmax (values at the
    endpoint are *possibly* clipped — an upper bound on true clipping,
    and the quantity that trends up when a static scale drifts narrow).
    ``occupancy``: (max − min code) / (levels) — how much of the code
    range the data spans (trends DOWN when a static scale drifts wide).
    """
    q = np.asarray(q)
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    n = q.size
    if n == 0:
        return {"n": 0, "clip_frac": None, "lo_clip_frac": None,
                "hi_clip_frac": None, "occupancy": None}
    lo = float(np.count_nonzero(q == qmin)) / n
    hi = float(np.count_nonzero(q == qmax)) / n
    occ = float(int(q.max()) - int(q.min())) / float(2 ** bits - 1)
    return {"n": int(n), "clip_frac": lo + hi, "lo_clip_frac": lo,
            "hi_clip_frac": hi, "occupancy": occ}


def span_stats(spans, ref_spans=None) -> dict:
    """Chunk-range statistics from per-chunk spans (α − β, any shape).

    ``occupancy_vs_ref``: mean(span / ref_span) — dynamic ranges measured
    against the static calibrated ranges they would be replaced by (> 1
    means live data exceeds the recipe: clipping; ≪ 1 means the recipe
    wastes levels). ``outlier_hist``: counts of log2(span / median span)
    in `OUTLIER_LOG2_EDGES` buckets — the "which chunks are hot" OCS
    histogram.
    """
    raw = np.asarray(spans, np.float64).ravel()
    mask = np.isfinite(raw) & (raw > 0)
    spans = raw[mask]
    out: dict = {"chunks": int(spans.size)}
    if spans.size == 0:
        out.update(span_median=None, span_max=None, outlier_hist=None,
                   occupancy_vs_ref=None)
        return out
    med = float(np.median(spans))
    out["span_median"] = med
    out["span_max"] = float(spans.max())
    ratio = np.log2(spans / med) if med > 0 else np.zeros_like(spans)
    edges = (-np.inf,) + OUTLIER_LOG2_EDGES + (np.inf,)
    hist, _ = np.histogram(ratio, bins=np.asarray(edges))
    out["outlier_hist"] = [int(c) for c in hist]
    out["occupancy_vs_ref"] = None
    if ref_spans is not None:
        ref = np.asarray(ref_spans, np.float64).ravel()
        if ref.size == 1:
            ref = np.broadcast_to(ref, raw.shape)
        if ref.size == raw.size:                # same pre-filter layout
            ref = ref[mask]
            ok = np.isfinite(ref) & (ref > 0)
            if ok.any():
                out["occupancy_vs_ref"] = float(
                    np.mean(spans[ok] / ref[ok]))
    return out


def scale_to_span(scale, bits: int = 8):
    """Invert eq. (2): S = levels / span ⇒ span = levels / S."""
    scale = np.asarray(scale, np.float64)
    levels = float(2 ** bits - 1)
    return np.where(scale > 0, levels / np.where(scale > 0, scale, 1.0),
                    0.0)


class ActQuantProbe:
    """Accumulates activation-quantizer quality across kernel calls.

    A caller feeds every call's codes (and dynamic scales, when present)
    here with `observe`; `summary()` folds them into
    one counter dict, and ``tracer`` (optional) gets a live ``counter``
    record per observation. Weighted by element count so big calls
    dominate, as they do in error terms.
    """

    def __init__(self, tracer=None, name: str = "act_quant",
                 bits: int = 8):
        self.tracer = tracer if tracer else None
        self.name = name
        self.bits = bits
        self.calls = 0
        self._elems = 0
        self._clip_w = 0.0          # clip_frac weighted by elements
        self._occ_w = 0.0           # occupancy weighted by elements
        self._spans: list[np.ndarray] = []

    def observe(self, q, scale=None, *, layer=None) -> dict:
        cs = code_stats(q, self.bits)
        self.calls += 1
        n = cs["n"]
        if n:
            self._elems += n
            self._clip_w += cs["clip_frac"] * n
            self._occ_w += cs["occupancy"] * n
        if scale is not None:
            self._spans.append(
                scale_to_span(scale, self.bits).ravel())
        if self.tracer:
            self.tracer.counter(
                self.name,
                {"clip_frac": cs["clip_frac"],
                 "occupancy": cs["occupancy"]},
                layer=layer)
        return cs

    def summary(self) -> dict:
        out = {"calls": self.calls, "elements": self._elems,
               "clip_frac": (self._clip_w / self._elems
                             if self._elems else None),
               "occupancy": (self._occ_w / self._elems
                             if self._elems else None)}
        if self._spans:
            out.update(span_stats(np.concatenate(self._spans)))
        return out
