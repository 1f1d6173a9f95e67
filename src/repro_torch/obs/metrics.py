"""Always-on metrics registry of the port (port of the registry half of
``repro.obs.metrics``, DESIGN.md §11): monotonic counters, gauges and
fixed-bucket histograms cheap enough to leave on for every request
served. The engine, the scheduler and the speculative decoder resolve
their instruments once against one registry, under the JAX package's
names, so both packages export the same series.

* **Bounded memory.** Counters and gauges hold one float, histograms a
  fixed bucket-count vector plus exact ``count`` and ``sum``.
* **Cheap increments.** An instrument's hot path is a couple of Python
  attribute operations: no locks, no allocation, no formatting.
* **Two export surfaces.** ``to_prometheus()`` renders the text
  exposition format (``*_total`` counters, cumulative
  ``*_bucket{le=...}`` histograms); ``snapshot()`` returns the plain dict
  ``Engine.metrics()`` embeds.

Instruments are get-or-create by name — asking twice returns the same
object. :class:`RegistryQuantProbe` mirrors the act-quant kernels'
observed calls into gauges, and :class:`SnapshotWriter` streams the
registry as JSONL (:func:`load_snapshots` reads it back), in the JAX
package's record format: each package reads the other's files.
"""
from __future__ import annotations

import bisect
import json
import math
import time
from typing import Optional, Sequence

from .atomic import atomic_write_text

#: Default histogram buckets for latency-in-seconds instruments:
#: log-spaced from 100 µs to 10 s (an engine step takes milliseconds to
#: tens of milliseconds; TTFT under load reaches seconds). Upper bounds;
#: +Inf is implicit.
LATENCY_BUCKETS_S = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                     1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0)

#: Default buckets for queue-depth-like counts.
DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)

#: Buckets for crash-recovery durations (engine_restore_duration_s):
#: coarser and wider than step latencies — a restore pays npz decompress
#: + checksum verification + journal replay, and on a cold box can reach
#: tens of seconds.
RESTORE_BUCKETS_S = (1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers render bare, +Inf as the
    literal the exposition format specifies."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonic counter. `inc` only — a decreasing counter is a bug
    (Prometheus rate() would interpret it as a process restart)."""

    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        self.value += n


class Gauge:
    """Point-in-time value (queue depth, slot occupancy, EWMA)."""

    __slots__ = ("name", "help", "value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Optional[float] = None      # unset until first set()

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value = (self.value or 0.0) + n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)


class Histogram:
    """Fixed-bucket histogram with exact count/sum.

    ``buckets`` are upper bounds (ascending); an implicit +Inf bucket
    catches the tail, so `observe` never loses a sample. Memory is the
    bucket vector — independent of observation count. ``percentile``
    interpolates within the winning bucket (the standard
    histogram_quantile estimate): exact enough for dashboards, while the
    engine keeps exact percentiles for its own metrics dict via
    `obs.summary` over raw lists where those already exist.
    """

    __slots__ = ("name", "help", "buckets", "counts", "count", "sum")
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"histogram {name}: buckets must be "
                             f"strictly ascending, got {buckets}")
        self.counts = [0] * (len(self.buckets) + 1)   # + the +Inf bucket
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-th percentile (0–100); None when empty. Linear
        interpolation inside the winning bucket; the +Inf bucket clamps
        to the last finite bound (an under-estimate, loudly coarse)."""
        if not self.count:
            return None
        rank = q / 100.0 * self.count
        acc = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            hi = self.buckets[i] if i < len(self.buckets) else \
                self.buckets[-1]
            if acc + c >= rank and c:
                frac = (rank - acc) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            acc += c
            lo = hi
        return self.buckets[-1]


class MetricsRegistry:
    """Named instrument store. Get-or-create semantics: the same name
    always returns the same instrument (kind mismatches raise — two
    layers silently sharing a name across kinds is always a bug)."""

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) \
            -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def names(self) -> tuple:
        """Registered instrument names (un-namespaced, registration
        order) — the instrument-presence assertion surface (the chaos
        smoke checks the fault-tolerance counters exist by name here
        and in the rendered Prometheus text)."""
        return tuple(self._metrics)

    # ------------------------------------------------------- exporting --
    def snapshot(self) -> dict:
        """Plain-dict view: counters/gauges map to their value,
        histograms to ``{count, sum, buckets: {le: cumulative_count}}``
        — the shape `Engine.metrics()` embeds."""
        out = {}
        for m in self._metrics.values():
            if m.kind == "histogram":
                cum, cum_counts = 0, {}
                for i, c in enumerate(m.counts):
                    cum += c
                    le = m.buckets[i] if i < len(m.buckets) else math.inf
                    cum_counts[_fmt(le)] = cum
                out[m.name] = {"count": m.count, "sum": m.sum,
                               "buckets": cum_counts}
            else:
                out[m.name] = m.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, one block per instrument.
        Counters get the ``_total`` suffix convention; histograms emit
        cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``.
        Unset gauges are omitted (absent ≠ zero)."""
        lines = []
        ns = self.namespace
        for m in self._metrics.values():
            if m.kind == "gauge" and m.value is None:
                continue            # whole block: absent series, no TYPE
            full = f"{ns}_{m.name}" if ns else m.name
            if m.kind == "counter" and not full.endswith("_total"):
                full += "_total"
            if m.help:
                lines.append(f"# HELP {full} {m.help}")
            lines.append(f"# TYPE {full} {m.kind}")
            if m.kind == "histogram":
                cum = 0
                for i, c in enumerate(m.counts):
                    cum += c
                    le = m.buckets[i] if i < len(m.buckets) else math.inf
                    lines.append(f'{full}_bucket{{le="{_fmt(le)}"}} {cum}')
                lines.append(f"{full}_sum {_fmt(m.sum)}")
                lines.append(f"{full}_count {m.count}")
            elif m.value is not None:
                lines.append(f"{full} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"


#: Process-default registry for callers without an engine (scripts,
#: notebooks). Engines mint their OWN registry by default so concurrent
#: engines/tests never cross-count; pass one explicitly to share.
_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT


class RegistryQuantProbe:
    """The ``kernels.act_quant.set_quality_probe`` adapter that mirrors
    each observed activation-quantizer call's saturation and occupancy
    into registry instruments, so the clip fraction is a live gauge and
    not only a trace counter. Duck-types ``quality.ActQuantProbe``'s
    ``observe``."""

    def __init__(self, registry: MetricsRegistry, prefix: str = "act"):
        from .quality import code_stats
        self._code_stats = code_stats
        self.calls = registry.counter(
            f"{prefix}_quant_observations_total",
            "observed activation-quantizer kernel calls")
        self.clip = registry.gauge(
            f"{prefix}_quant_clip_frac",
            "fraction of codes pinned at qmin/qmax in the last "
            "observed call (upper bound on true clipping)")
        self.occ = registry.gauge(
            f"{prefix}_quant_occupancy",
            "code-range occupancy of the last observed call")

    def __bool__(self) -> bool:        # set_quality_probe keeps truthy
        return True

    def observe(self, q, scale=None, *, layer=None) -> dict:
        cs = self._code_stats(q)
        self.calls.inc()
        if cs["clip_frac"] is not None:
            self.clip.set(cs["clip_frac"])
            self.occ.set(cs["occupancy"])
        return cs


class SnapshotWriter:
    """Periodic JSONL metrics snapshots.

    Line 1 is a header record with the provenance dict
    (``obs.provenance.provenance``); each further line is
    ``{"kind": "snapshot", "seq", "ts", "metrics": ...}``.
    ``maybe_write`` is rate-limited by ``interval_s`` so the serve loop
    can call it every step; ``write`` forces one (the final flush). The
    lines are buffered and the whole file is rewritten through the atomic
    tmp + fsync + rename helper on every write, so a crash mid-write
    leaves the previous complete log, never a torn tail."""

    def __init__(self, path: str, registry: MetricsRegistry,
                 interval_s: float = 1.0, clock=time.perf_counter,
                 provenance: Optional[dict] = None):
        self.path = path
        self.registry = registry
        self.interval_s = interval_s
        self.clock = clock
        self.t0 = clock()
        self._last: Optional[float] = None
        self.seq = 0
        if provenance is None:
            from .provenance import provenance as _prov
            provenance = _prov()
        self._lines = [json.dumps({"kind": "header", "schema": 1,
                                   "provenance": provenance})]
        self._flush()

    def _flush(self) -> None:
        atomic_write_text(self.path, "\n".join(self._lines) + "\n")

    def write(self) -> int:
        """Append one snapshot now; returns its seq number."""
        rec = {"kind": "snapshot", "seq": self.seq,
               "ts": self.clock() - self.t0,
               "metrics": self.registry.snapshot()}
        self._lines.append(json.dumps(rec, default=float))
        self._flush()
        self._last = self.clock()
        self.seq += 1
        return rec["seq"]

    def maybe_write(self) -> bool:
        """Snapshot if ``interval_s`` has passed since the last one (the
        first call always writes). Returns whether it wrote."""
        now = self.clock()
        if self._last is not None and now - self._last < self.interval_s:
            return False
        self.write()
        return True


def load_snapshots(path: str) -> tuple[dict, list[dict]]:
    """Read a :class:`SnapshotWriter` file (either package's): (header,
    the snapshot records in write order)."""
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    if not recs or recs[0].get("kind") != "header":
        raise ValueError(f"{path}: not a metrics snapshot log "
                         f"(missing header record)")
    return recs[0], [r for r in recs[1:] if r.get("kind") == "snapshot"]
