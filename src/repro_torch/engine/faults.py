"""Seeded fault injection + the graceful-degradation ladder (port of
``repro.engine.faults``, DESIGN.md §12).

* :class:`FaultInjector` — a deterministic, seeded source of synthetic
  faults the engine enables via ``EngineConfig(fault_spec=...)``. Every
  draw comes from ONE ``numpy.random.default_rng(seed)``, in the JAX
  package's order, so the same spec gives the same storm in both
  packages, and a chaos run is exactly reproducible: its SURVIVORS are
  token-identical to an unfaulted run. Injection points:

  - ``step_exception_rate``  — the decode dispatch raises (transient;
    retry-with-rollback absorbs it);
  - ``nan_logits_rate``      — one decoding slot's sampled token is
    corrupted out-of-vocab: the observable symptom of NaN logits, caught
    by the engine's host-side in-vocab check, and per-slot ATTRIBUTABLE,
    which is what makes quarantine possible;
  - ``slow_step_rate``       — a straggler step (sleeps
    ``slow_step_s``); exercises deadline enforcement, not retry;
  - ``poison_rate``          — a submission is marked poisoned and its
    slot's token corrupts EVERY step: the deterministic failure retry
    can never fix, which must end in quarantine (``failed``) rather
    than wedging the batch;
  - ``crash_rate``           — process death at a step boundary
    (:class:`InjectedCrash`, or SIGKILL), for crash recovery.

  A CUDA launch or illegal-address error is none of these: it is not a
  :class:`StepFailure`, so the engine's retry loop lets it propagate.

* :class:`DegradationLadder` — hysteresis state machine mapping
  sustained backlog pressure onto escalating sheds of cheap-to-lose
  work: first speculation (rung 1 — output-identical by the lossless
  accept rule, so it is free), then batch-class admissions (rung 2),
  then load itself (rung 3).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional

import numpy as np

#: Sentinel written over a corrupted slot's sampled token: far outside
#: any vocab, so the engine's in-vocab check always trips on it.
POISON_TOKEN = -(1 << 30)


class StepFailure(RuntimeError):
    """A decode step produced unusable output. ``slots`` carries the
    attributable victims (empty = the whole dispatch failed with no
    per-slot signal — retry treats the two cases differently)."""

    def __init__(self, msg: str, slots=()):
        super().__init__(msg)
        self.slots = tuple(slots)


class InjectedFault(StepFailure):
    """A synthetic transient raised by the injector (never attributable
    to a slot — it models the dispatch itself failing)."""


class InjectedCrash(BaseException):
    """Injected PROCESS DEATH at a step boundary (engine/recovery.py).

    Deliberately a ``BaseException``: unlike :class:`StepFailure` this
    models the whole process dying, so the engine's retry machinery (and
    any stray ``except Exception``) must not be able to absorb it — only
    a supervisor that restarts + recovers may catch it. With
    ``crash_kill=1`` the injector SIGKILLs the process instead, the
    real thing for cross-process recovery smoke tests."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Injection configuration; all rates are per-step (or per-submit
    for ``poison_rate``) Bernoulli probabilities in [0, 1]."""

    seed: int = 0
    step_exception_rate: float = 0.0
    nan_logits_rate: float = 0.0
    slow_step_rate: float = 0.0
    slow_step_s: float = 0.005
    poison_rate: float = 0.0
    #: per-step-boundary probability of process death (raises
    #: :class:`InjectedCrash`, or SIGKILLs when ``crash_kill``) — drawn
    #: BEFORE any step work, right after the previous step's journal
    #: fsync, so the crash always lands exactly on the WAL's durability
    #: horizon
    crash_rate: float = 0.0
    #: crash via ``os.kill(getpid(), SIGKILL)`` instead of raising —
    #: real process death for cross-process recovery tests
    crash_kill: bool = False
    #: stop injecting step-level faults after this many total events
    #: (None = unbounded) — lets a storm settle so drains terminate
    #: even at extreme rates
    max_faults: Optional[int] = None

    #: CLI-string key → dataclass field (launch.serve --faults)
    _KEYS = {"seed": "seed", "exception": "step_exception_rate",
             "nan": "nan_logits_rate", "slow": "slow_step_rate",
             "slow_s": "slow_step_s", "poison": "poison_rate",
             "crash": "crash_rate", "crash_kill": "crash_kill",
             "max": "max_faults"}

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        """Build from a ``k=v,k=v`` CLI string, e.g.
        ``"exception=0.05,nan=0.05,poison=0.1,seed=3"``. Keys:
        exception / nan / slow / slow_s / poison / crash / crash_kill /
        seed / max."""
        kw = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"fault spec item {part!r} is not k=v "
                                 f"(known keys: {sorted(cls._KEYS)})")
            k, v = part.split("=", 1)
            field = cls._KEYS.get(k.strip())
            if field is None:
                raise ValueError(f"unknown fault spec key {k.strip()!r} "
                                 f"(known: {sorted(cls._KEYS)})")
            if field in ("seed", "max_faults"):
                kw[field] = int(v)
            elif field == "crash_kill":
                kw[field] = bool(int(v))
            else:
                kw[field] = float(v)
        return cls(**kw)


class FaultInjector:
    """Deterministic fault source: one seeded rng drives every draw, so
    identical configs replay identical storms. The engine asks three
    questions: ``note_submit`` (is this request poisoned?), ``draw_step``
    (does this decode attempt raise / straggle?), and ``corrupt_tokens``
    (which sampled tokens come back garbage?)."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        self.poison_uids: set[int] = set()
        self.last_corrupted_uids: list[int] = []
        self.n_step_exceptions = 0
        self.n_token_corruptions = 0
        self.n_slow_steps = 0
        self.n_crashes = 0

    def injected_total(self) -> int:
        """Step-level fault events so far (poisoned submissions are
        request marks, not events — quarantine bounds their damage)."""
        return (self.n_step_exceptions + self.n_token_corruptions
                + self.n_slow_steps + self.n_crashes)

    def _budget_left(self) -> bool:
        return (self.spec.max_faults is None
                or self.injected_total() < self.spec.max_faults)

    def note_submit(self, uid: int) -> bool:
        """Draw the poison mark for a new submission."""
        if self.spec.poison_rate > 0 \
                and self.rng.uniform() < self.spec.poison_rate:
            self.poison_uids.add(uid)
            return True
        return False

    def draw_step(self) -> Optional[str]:
        """At most one step-level fault per decode attempt:
        "exception" | "slow" | None."""
        s = self.spec
        if (s.step_exception_rate or s.slow_step_rate) \
                and self._budget_left():
            u = self.rng.uniform()
            if u < s.step_exception_rate:
                self.n_step_exceptions += 1
                return "exception"
            if u < s.step_exception_rate + s.slow_step_rate:
                self.n_slow_steps += 1
                return "slow"
        return None

    def draw_crash(self) -> bool:
        """Draw process death for the step boundary about to start.

        Consumes rng only when ``crash_rate`` is set, so enabling other
        fault classes alone leaves their seeded streams untouched."""
        s = self.spec
        if s.crash_rate <= 0 or not self._budget_left():
            return False
        if self.rng.uniform() < s.crash_rate:
            self.n_crashes += 1
            return True
        return False

    def crash(self) -> None:
        """Die. SIGKILL under ``crash_kill`` (no cleanup, no atexit —
        the genuine article), else raise :class:`InjectedCrash` for an
        in-process supervisor to field."""
        if self.spec.crash_kill:
            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedCrash(
            f"injected process crash at step boundary "
            f"(crash #{self.n_crashes})")

    def sleep(self) -> None:
        time.sleep(self.spec.slow_step_s)

    def corrupt_tokens(self, toks: np.ndarray, active: list,
                       uid_of: dict) -> np.ndarray:
        """Apply token-level corruption to one decode attempt's sampled
        tokens: a transient NaN-logits victim (random decoding slot) plus
        every slot currently holding a poisoned request.

        ``last_corrupted_uids`` records this attempt's victims — the
        ground truth an incident bundle's trigger attribution is checked
        against in tests (the engine independently attributes via the
        out-of-vocab slots on the StepFailure)."""
        toks = np.array(toks, copy=True)
        self.last_corrupted_uids = []
        if self.spec.nan_logits_rate > 0 and active \
                and self._budget_left() \
                and self.rng.uniform() < self.spec.nan_logits_rate:
            victim = active[int(self.rng.integers(len(active)))]
            toks[victim] = POISON_TOKEN
            self.n_token_corruptions += 1
            self.last_corrupted_uids.append(uid_of[victim])
        for s in active:
            if uid_of[s] in self.poison_uids:
                toks[s] = POISON_TOKEN
                if uid_of[s] not in self.last_corrupted_uids:
                    self.last_corrupted_uids.append(uid_of[s])
        return toks

    def counts(self) -> dict:
        return {"step_exceptions": self.n_step_exceptions,
                "token_corruptions": self.n_token_corruptions,
                "slow_steps": self.n_slow_steps,
                "crashes": self.n_crashes,
                "poisoned_submissions": len(self.poison_uids)}


class DegradationLadder:
    """Backlog-pressure → degradation-rung state machine with
    hysteresis.

    ``pressure`` (queue depth + prefill backlog chunks, the engine's
    existing queueing signals) is compared against three ascending
    ``thresholds``; the TARGET rung is the number of thresholds the
    pressure exceeds. The ladder only MOVES to the target after
    ``patience`` consecutive steps agree (and takes twice that to step
    back down), so a one-step burst never flaps speculation off/on —
    flapping costs draft-cache holes and acceptance, and admission
    churn.

    Rungs: 0 normal · 1 speculation off (output-identical, free) ·
    2 defer batch-class admissions · 3 shed queued load.
    """

    RUNGS = ("normal", "spec_off", "defer_batch", "shed")

    def __init__(self, thresholds, patience: int = 2):
        thresholds = tuple(float(t) for t in thresholds)
        if len(thresholds) != 3 or list(thresholds) != \
                sorted(set(thresholds)):
            raise ValueError(f"degrade thresholds must be 3 strictly "
                             f"ascending pressures, got {thresholds}")
        self.thresholds = thresholds
        self.patience = max(1, int(patience))
        self.rung = 0
        self.n_transitions = 0
        self._above = 0
        self._below = 0

    def target(self, pressure: float) -> int:
        return sum(pressure > t for t in self.thresholds)

    def update(self, pressure: float) -> int:
        """Feed one step's pressure; returns the (possibly new) rung."""
        tgt = self.target(pressure)
        if tgt > self.rung:
            self._above += 1
            self._below = 0
            if self._above >= self.patience:
                self.rung = tgt
                self.n_transitions += 1
                self._above = 0
        elif tgt < self.rung:
            self._below += 1
            self._above = 0
            if self._below >= 2 * self.patience:    # slower descent
                self.rung = tgt
                self.n_transitions += 1
                self._below = 0
        else:
            self._above = self._below = 0
        return self.rung
