"""Monotonic-clock tracer with a bounded ring buffer (port of
``repro.obs.tracer``, DESIGN.md §10), in the JAX package's record format.

The serving stack is instrumented with three record kinds:

* ``span``    — a timed phase (``name`` ∈ `schema.PHASES`) with ``ts``
  (seconds since the tracer epoch), ``dur``, and optional attribution
  fields: ``dispatch_s`` (host time until the entry point returned —
  kernel launches on the card are asynchronous) and ``wait_s`` (the
  ``torch.cuda.synchronize`` / host-copy wait for the device result).
  ``dur - wait_s`` is therefore host time, of which ``dispatch_s`` is
  the launch share — the split that decides "dispatch-bound or
  compute-bound" per phase.
* ``event``   — an instantaneous per-request lifecycle point
  (``name`` ∈ `schema.LIFECYCLE`: submit → admit → first_token →
  retire, plus rollback), carrying ``uid`` and usually ``slot``.
* ``counter`` — a sampled value series (e.g. the KV quantization-quality
  counters of `engine.kvcache.kv_quality_counters`).

The buffer is a fixed-capacity deque: once full, the OLDEST records drop
(``dropped`` counts them), so a long soak keeps the most recent window.
A disabled tracer is falsy — callers hold ``None`` (or a falsy tracer)
and guard every instrumentation site with one branch, which is the whole
disabled-mode cost.

Exporters: `to_jsonl` (one header record + one record per line — the
format `schema.validate_events` and the JAX package's ``trace_report``
read; the request journal is written in it too) and `to_chrome` (Chrome
``trace.json``, loadable in Perfetto / chrome://tracing: one track per
slot, one per engine phase). Each package reads the other's traces.
"""
from __future__ import annotations

import collections
import contextlib
import json
import time

from .atomic import atomic_write_text

SCHEMA_VERSION = 1

#: Chrome-trace thread ids: slots get 1 + slot, un-slotted lifecycle
#: events a "requests" track, un-slotted phase spans one track per phase
#: name (in order of first appearance), counters their own track. These
#: are *minimum* tids — `chrome_trace` shifts them above the highest slot
#: tid, so engines with >= 59 slots don't alias the slot tracks.
_TID_REQUESTS = 60
_TID_COUNTERS = 61
_TID_PHASE0 = 64


class Tracer:
    """Span/event/counter recorder. All timestamps come from ``clock``
    (host-monotonic; the engine passes its own clock so trace time and
    engine metrics share one axis).

    ``enabled=False`` makes the tracer falsy and every record call a
    no-op — engines normalize a falsy tracer to ``None`` so the serving
    hot path pays one predictable branch per site.
    """

    def __init__(self, capacity: int = 1 << 16, clock=time.perf_counter,
                 enabled: bool = True, meta: dict | None = None):
        self.clock = clock
        self.enabled = enabled
        self.capacity = int(capacity)
        self.t0 = clock()
        self.events: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.dropped = 0
        self.meta = dict(meta or {})

    def __bool__(self) -> bool:
        return self.enabled

    # ------------------------------------------------------- recording --
    def _push(self, rec: dict) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1                  # deque drops the oldest
        self.events.append(rec)

    def now(self) -> float:
        return self.clock()

    def begin(self) -> float:
        """Timestamp helper for the begin/`span_end` pair — records
        nothing (so a span abandoned on an exception costs nothing)."""
        return self.clock()

    def span_end(self, name: str, t_begin: float, **fields) -> None:
        """Record a span from ``t_begin`` (a `begin`/clock timestamp) to
        now. Extra ``fields`` ride along (slot/uid/step/dispatch_s/...)."""
        if not self.enabled:
            return
        self._push({"kind": "span", "name": name,
                    "ts": t_begin - self.t0,
                    "dur": self.clock() - t_begin, **fields})

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        t_begin = self.clock()
        try:
            yield
        finally:
            self.span_end(name, t_begin, **fields)

    def event(self, name: str, **fields) -> None:
        if not self.enabled:
            return
        self._push({"kind": "event", "name": name,
                    "ts": self.clock() - self.t0, **fields})

    def counter(self, name: str, value, **fields) -> None:
        """``value``: a number or a flat dict of numbers (one series per
        key in the Chrome export)."""
        if not self.enabled:
            return
        self._push({"kind": "counter", "name": name,
                    "ts": self.clock() - self.t0, "value": value, **fields})

    # ------------------------------------------------------- exporting --
    def header(self) -> dict:
        return {"kind": "header", "schema": SCHEMA_VERSION,
                "capacity": self.capacity, "dropped": self.dropped,
                **self.meta}

    def records(self):
        """Header + buffered records, oldest first."""
        yield self.header()
        yield from self.events

    def to_jsonl(self, path: str) -> int:
        """Write the JSONL event log atomically (tmp + fsync + rename);
        returns the record count (header included)."""
        lines = [json.dumps(rec, default=float) for rec in self.records()]
        atomic_write_text(path, "\n".join(lines) + "\n" if lines else "")
        return len(lines)

    def to_chrome(self, path: str) -> None:
        atomic_write_text(
            path, json.dumps(chrome_trace(list(self.records()))))


def load_jsonl(path: str) -> list[dict]:
    """Load a JSONL event log (header record first)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _chrome_tid(rec: dict, phase_tids: dict, tid_requests: int,
                tid_phase0: int) -> int:
    if rec.get("slot") is not None:
        return 1 + int(rec["slot"])
    if rec["kind"] == "span":
        return phase_tids.setdefault(rec["name"],
                                     tid_phase0 + len(phase_tids))
    return tid_requests


def chrome_trace(records: list[dict]) -> dict:
    """Chrome trace-event JSON (Perfetto-loadable) from trace records:
    one track per slot (slot-attributed spans + lifecycle instants), one
    track per un-slotted engine phase, one counter track. Times in µs.

    Slot tids are ``1 + slot``, so the fixed requests/counters/phase tids
    would alias slot tracks at >= 59 slots; the non-slot tids are shifted
    above the highest slot seen in ``records``."""
    max_slot = -1
    for rec in records:
        if (rec.get("kind") in ("span", "event", "counter")
                and rec.get("slot") is not None):
            max_slot = max(max_slot, int(rec["slot"]))
    tid_requests = max(_TID_REQUESTS, max_slot + 2)
    tid_counters = tid_requests + (_TID_COUNTERS - _TID_REQUESTS)
    tid_phase0 = tid_requests + (_TID_PHASE0 - _TID_REQUESTS)
    out = []
    phase_tids: dict[str, int] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind not in ("span", "event", "counter"):
            continue
        ts_us = rec["ts"] * 1e6
        args = {k: v for k, v in rec.items()
                if k not in ("kind", "name", "ts", "dur", "value")}
        if kind == "span":
            out.append({"ph": "X", "pid": 0,
                        "tid": _chrome_tid(rec, phase_tids, tid_requests,
                                           tid_phase0),
                        "name": rec["name"], "ts": ts_us,
                        "dur": rec["dur"] * 1e6, "args": args})
        elif kind == "event":
            out.append({"ph": "i", "s": "t", "pid": 0,
                        "tid": _chrome_tid(rec, phase_tids, tid_requests,
                                           tid_phase0),
                        "name": rec["name"], "ts": ts_us, "args": args})
        else:                                   # counter
            val = rec.get("value")
            series = (val if isinstance(val, dict) else {"value": val})
            series = {k: v for k, v in series.items()
                      if isinstance(v, (int, float))}
            if series:
                out.append({"ph": "C", "pid": 0, "tid": tid_counters,
                            "name": rec["name"], "ts": ts_us,
                            "args": series})
    names = [(1 + s, f"slot {s}") for s in range(max_slot + 1)]
    names += [(tid_requests, "requests"), (tid_counters, "counters")]
    names += [(tid, f"phase:{name}") for name, tid in phase_tids.items()]
    meta = [{"ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
             "args": {"name": label}} for tid, label in names]
    meta.append({"ph": "M", "pid": 0, "name": "process_name",
                 "args": {"name": "repro-engine"}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}
