"""Anomaly detectors over live engine signals (port of
``repro.obs.detect``, DESIGN.md §14): the same catalog, thresholds and
cooldown, so both packages fire the same detectors on the same records.

A sweep runs once per step boundary over the flight record just written
(``AnomalyDetector.sweep``); event-shaped anomalies that happen *inside*
a step (retry, quarantine, ``IntegrityError``, ``InjectedCrash``) are
posted with ``note`` and drained by the same sweep so every firing is
step-stamped. Each detector fires at most once per ``cooldown_steps`` —
a fault storm produces one incident, not one per step.

Catalog (name → signal → default threshold):

  step_latency_spike  step_s vs rolling EWMA baseline; fires when
                      step_s > latency_factor × baseline after
                      warmup_steps baseline samples. The EWMA is fed
                      from the start, so first-call spikes (kernel
                      builds, allocator growth) during warmup inflate
                      the baseline instead of firing.
  accept_collapse     scheduler acceptance EWMA drops below
                      accept_floor after having been >= 2×floor —
                      speculation is burning draft passes for nothing.
  kv_clip_spike       KV clip-fraction sample exceeds clip_abs or jumps
                      by > clip_jump over the previous sample — the
                      paper's eq. 1–3 outlier pathology getting worse
                      at runtime.
  queue_runaway       admission queue depth exceeds the configured set
                      point (engine max_queue) — overload is outrunning
                      admission control.
  rung_ascent         degradation rung increased this step.
  step_retry          a step failed and was retried (posted by the
                      engine with the faulted uid when attributable).
  quarantine          a request was retired as "failed" after
                      exhausting retries (posted with the uid).
  integrity_error     artifact validation failed during restore/load
                      (posted with the reason).
  injected_crash      the chaos injector killed the step loop (posted
                      by the supervisor on restart).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["DETECTORS", "Firing", "AnomalyDetector"]

#: Every detector name this module can emit (incident_report validates
#: triggers against this catalog).
DETECTORS = (
    "step_latency_spike",
    "accept_collapse",
    "kv_clip_spike",
    "queue_runaway",
    "rung_ascent",
    "step_retry",
    "quarantine",
    "integrity_error",
    "injected_crash",
)

#: Detectors posted via note() rather than derived from the sweep.
EVENT_DETECTORS = ("step_retry", "quarantine", "integrity_error",
                   "injected_crash")


@dataclass
class Firing:
    detector: str
    step: int
    reason: str
    uid: Optional[int] = None
    value: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"detector": self.detector, "step": self.step,
                "reason": self.reason, "uid": self.uid,
                "value": self.value}


class AnomalyDetector:
    """Stateful sweep over per-step flight records + posted events."""

    def __init__(self, cooldown_steps: int = 50, *,
                 latency_factor: float = 6.0,
                 warmup_steps: int = 8,
                 baseline_alpha: float = 0.2,
                 accept_floor: float = 0.2,
                 clip_abs: float = 0.5,
                 clip_jump: float = 0.25,
                 queue_set_point: Optional[int] = None):
        if cooldown_steps < 1:
            raise ValueError(
                f"cooldown_steps must be >= 1, got {cooldown_steps}")
        self.cooldown_steps = int(cooldown_steps)
        self.latency_factor = float(latency_factor)
        self.warmup_steps = int(warmup_steps)
        self.baseline_alpha = float(baseline_alpha)
        self.accept_floor = float(accept_floor)
        self.clip_abs = float(clip_abs)
        self.clip_jump = float(clip_jump)
        self.queue_set_point = queue_set_point
        # Rolling state.
        self._lat_ewma: Optional[float] = None
        self._lat_n = 0
        self._accept_armed = False
        self._prev_clip: Optional[float] = None
        self._prev_rung = 0
        self._step = -1
        self._last_fired: Dict[str, int] = {}
        self._pending: List[Firing] = []
        self.n_fired = 0

    # ---------------------------------------------------------- events
    def note(self, detector: str, *, reason: str = "",
             uid: Optional[int] = None,
             value: Optional[float] = None,
             step: Optional[int] = None) -> None:
        """Post an event-shaped anomaly; drained by the next sweep (or
        immediately via drain() for out-of-step events like crashes)."""
        if detector not in DETECTORS:
            raise ValueError(f"unknown detector {detector!r}")
        at = self._step + 1 if step is None else int(step)
        self._pending.append(Firing(detector, at, reason, uid=uid,
                                    value=value))

    # ----------------------------------------------------------- sweep
    def sweep(self, rec: Dict[str, Any]) -> List[Firing]:
        """Evaluate one flight record; returns cooldown-filtered firings
        (posted events first — they are the precise signal, the derived
        detectors are the echo)."""
        self._step = step = int(rec.get("step", self._step + 1))
        raw: List[Firing] = list(self._pending)
        self._pending.clear()

        step_s = rec.get("step_s")
        if step_s is not None:
            if (self._lat_n >= self.warmup_steps
                    and self._lat_ewma is not None and self._lat_ewma > 0
                    and step_s > self.latency_factor * self._lat_ewma):
                raw.append(Firing(
                    "step_latency_spike", step,
                    f"step wall {step_s:.4f}s > {self.latency_factor:g}x "
                    f"rolling baseline {self._lat_ewma:.4f}s",
                    value=float(step_s)))
            a = self.baseline_alpha
            self._lat_ewma = (float(step_s) if self._lat_ewma is None
                              else (1 - a) * self._lat_ewma + a * float(step_s))
            self._lat_n += 1

        accept = rec.get("accept")
        if accept is not None:
            if accept >= 2.0 * self.accept_floor:
                self._accept_armed = True
            elif self._accept_armed and accept < self.accept_floor:
                self._accept_armed = False
                raw.append(Firing(
                    "accept_collapse", step,
                    f"spec acceptance EWMA {accept:.3f} fell below "
                    f"{self.accept_floor:g}", value=float(accept)))

        clip = rec.get("clip_frac")
        if clip is not None:
            jumped = (self._prev_clip is not None
                      and clip - self._prev_clip > self.clip_jump)
            if clip > self.clip_abs or jumped:
                base = (f" (was {self._prev_clip:.3f})"
                        if self._prev_clip is not None else "")
                raw.append(Firing(
                    "kv_clip_spike", step,
                    f"KV clip fraction {clip:.3f}{base}",
                    value=float(clip)))
            self._prev_clip = float(clip)

        queue = rec.get("queue")
        if (queue is not None and self.queue_set_point is not None
                and self.queue_set_point > 0
                and queue > self.queue_set_point):
            raw.append(Firing(
                "queue_runaway", step,
                f"queue depth {queue} > admission set point "
                f"{self.queue_set_point}", value=float(queue)))

        rung = rec.get("rung")
        if rung is not None:
            if rung > self._prev_rung:
                raw.append(Firing(
                    "rung_ascent", step,
                    f"degradation rung {self._prev_rung} -> {rung}",
                    value=float(rung)))
            self._prev_rung = int(rung)

        return self._admit(raw)

    def drain(self) -> List[Firing]:
        """Cooldown-filter pending posted events without a step record —
        for anomalies outside the step loop (crash on restart,
        IntegrityError during restore)."""
        raw = list(self._pending)
        self._pending.clear()
        return self._admit(raw)

    def _admit(self, raw: List[Firing]) -> List[Firing]:
        out: List[Firing] = []
        for f in raw:
            last = self._last_fired.get(f.detector)
            if last is not None and f.step - last < self.cooldown_steps:
                continue
            self._last_fired[f.detector] = f.step
            self.n_fired += 1
            out.append(f)
        return out
