"""Token-level continuous-batching scheduler (port of
``repro.engine.scheduler``): FCFS admission into a fixed pool of N slots,
per-step retire and refill, and the chunked-prefill slot states.

Pure-Python bookkeeping; it never touches device tensors. It owns the
submit / admit / retire transitions, so it writes their request-journal
records (``engine/recovery.RequestJournal``) and keeps the queueing
signals and instruments of the metrics registry, under the JAX package's
names, and emits their lifecycle events (``submit``, ``admit``,
``retire``) into the engine's tracer. It also keeps the speculative
decoder's draft-proposed and draft-accepted counts and the acceptance
EWMA.

Admission control (DESIGN.md §12): with ``max_queue > 0`` the submit
queue is bounded and an arrival into a full queue invokes the
``overload_policy`` — "reject-new" sheds the arrival itself,
"shed-oldest" sheds the queue head (the request that has already waited
longest), "shed-by-class" sheds the oldest queued batch-class request
first and falls back to the arrival. Shed requests finish immediately
with reason "shed": every submission still retires exactly once, just
without ever holding a slot. :func:`admission_set_point` derives the
bound from a measured open-loop saturation knee.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Optional

#: Bounded-queue overload policies (Scheduler(max_queue=...)).
OVERLOAD_POLICIES = ("reject-new", "shed-oldest", "shed-by-class")

#: Classes shed first under "shed-by-class" and deferred by the
#: degradation ladder — the batch class (loose SLO, long prompts):
#: dropping one frees the most work for the least SLO damage.
SHED_CLASSES = ("batch",)


class SubmitError(ValueError):
    """Structured rejection at ``Engine.submit``; ``code`` is one of
    "empty_prompt", "too_long", "bad_budget"."""

    def __init__(self, code: str, msg: str):
        super().__init__(msg)
        self.code = code


@dataclasses.dataclass
class EngineRequest:
    """One generation request and its lifecycle timestamps."""

    uid: int
    prompt: "object"                    # (S,) int array
    max_new_tokens: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    # why the request retired: one of obs.schema.RETIRE_REASONS (normal:
    # "eos" | "budget" | "max_len" | "zero_budget"; lifecycle policy:
    # "cancelled" | "deadline_exceeded" | "shed" | "failed"); None while
    # running
    finish_reason: Optional[str] = None
    # request class ("interactive" | "batch" | None): the shed-by-class
    # victim key and the ladder's admission-defer key
    cls: Optional[str] = None
    # deadlines in seconds from t_submit (None = none), enforced by the
    # engine at step boundaries: ttft for requests still awaiting their
    # first token, total for everyone
    ttft_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.t_submit is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tokens_per_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_done is None or not self.out:
            return None
        dt = self.t_done - self.t_submit
        return len(self.out) / dt if dt > 0 else None


class Scheduler:
    """FCFS queue + fixed slot pool. ``registry``: the metrics registry
    its instruments live in (None: none); ``journal``: the request
    journal its transitions are written to (None: none); ``tracer``: the
    ``obs.Tracer`` its lifecycle events go to (falsy: none, one branch a
    site)."""

    def __init__(self, n_slots: int, clock=time.perf_counter, registry=None,
                 max_queue: int = 0, overload_policy: str = "reject-new",
                 journal=None, tracer=None):
        if overload_policy not in OVERLOAD_POLICIES:
            raise ValueError(f"overload_policy {overload_policy!r} not in "
                             f"{OVERLOAD_POLICIES}")
        self.n_slots = n_slots
        self.clock = clock
        self.max_queue = int(max_queue or 0)     # 0 = unbounded
        self.tracer = tracer if tracer else None
        self.overload_policy = overload_policy
        self.journal = journal if journal else None
        self.queue: collections.deque[EngineRequest] = collections.deque()
        self.slots: list[Optional[EngineRequest]] = [None] * n_slots
        self.finished: list[EngineRequest] = []
        # always-on queueing signals: O(1) appends at submit / admit time
        self.admit_latency_s: list[float] = []   # submit -> slot placement
        self.queue_depth_submit: list[int] = []  # depth seen by each submit
        self._mx = None
        if registry is not None:
            from ..obs.metrics import DEPTH_BUCKETS
            self._mx = {
                "submitted": registry.counter(
                    "sched_requests_submitted",
                    "requests entering the FCFS queue"),
                "admitted": registry.counter(
                    "sched_requests_admitted",
                    "requests placed into a slot"),
                "retired": registry.counter(
                    "sched_requests_retired", "requests finished"),
                "depth": registry.gauge(
                    "sched_queue_depth",
                    "requests waiting for a slot"),
                "depth_hist": registry.histogram(
                    "sched_queue_depth_at_submit",
                    "queue depth seen by each arriving request",
                    buckets=DEPTH_BUCKETS),
                "admit_latency": registry.histogram(
                    "sched_admit_latency_seconds",
                    "submit -> slot placement wait"),
                "shed": registry.counter(
                    "sched_requests_shed",
                    "requests shed by admission control or the "
                    "degradation ladder (retire reason \"shed\")"),
                "cancelled": registry.counter(
                    "sched_requests_cancelled",
                    "requests cancelled mid-flight or while queued"),
            }
        # admitted but not fully prefilled: occupied, not decoding
        self._prefilling: list[int] = []        # FCFS begin order
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_shed = 0
        self.n_cancelled = 0
        self.queue_depth_hist: list[int] = []
        self._active_hist: list[int] = []       # decoding slots a step
        # speculative decoding: draft tokens proposed and accepted, in all
        # and per slot, the accepted count of each verify call, and the
        # EWMA of the per-verify acceptance fraction (None until a verify
        # proposes a draft)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.accept_hist: list[int] = []
        self.spec_by_slot: list[list[int]] = [[0, 0] for _ in range(n_slots)]
        self.accept_ewma: Optional[float] = None
        self.accept_ewma_alpha = 0.1

    # ------------------------------------------------------------ intake --
    def submit(self, req: EngineRequest) -> EngineRequest:
        req.t_submit = self.clock()
        self.n_submitted += 1
        victim = None
        if self.max_queue and len(self.queue) >= self.max_queue:
            victim = self._overload_victim(req)
        if victim is not req:
            self.queue.append(req)
        self.queue_depth_submit.append(len(self.queue))
        if self._mx:
            self._mx["submitted"].inc()
            self._mx["depth"].set(len(self.queue))
            self._mx["depth_hist"].observe(len(self.queue))
        if self.tracer:
            self.tracer.event("submit", uid=int(req.uid),
                              prompt_len=int(len(req.prompt)),
                              budget=int(req.max_new_tokens),
                              queue_depth=len(self.queue))
        if self.journal:
            # the one place the full prompt is persisted: replay
            # re-enqueues the request from this record
            self.journal.event("submit", uid=int(req.uid),
                               prompt=[int(t) for t in req.prompt],
                               budget=int(req.max_new_tokens), cls=req.cls,
                               ttft_deadline_s=req.ttft_deadline_s,
                               deadline_s=req.deadline_s)
        if victim is not None:
            if victim is not req:
                self.queue.remove(victim)
                if self._mx:
                    self._mx["depth"].set(len(self.queue))
            self._finish(victim, "shed")
        return req

    def _overload_victim(self, incoming: EngineRequest) -> EngineRequest:
        """The request to shed when ``incoming`` finds the queue full
        (OVERLOAD_POLICIES, module docstring)."""
        if self.overload_policy == "shed-oldest" and self.queue:
            return self.queue[0]
        if self.overload_policy == "shed-by-class":
            for r in self.queue:                      # oldest batch first
                if r.cls in SHED_CLASSES:
                    return r
        return incoming                               # reject-new

    # ---------------------------------------------------------- stepping --
    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def active_slots(self) -> list[int]:
        """Slots decoding this step: occupied and not mid-prefill."""
        return [i for i, r in enumerate(self.slots)
                if r is not None and i not in self._prefilling]

    def occupied_uids(self) -> list[int]:
        """uids holding a slot right now, in slot order."""
        return [r.uid for r in self.slots if r is not None]

    def begin_prefill(self, slot: int) -> None:
        if self.slots[slot] is None:
            raise ValueError(f"prefill of empty slot {slot}")
        if slot not in self._prefilling:
            self._prefilling.append(slot)

    def finish_prefill(self, slot: int) -> None:
        self._prefilling.remove(slot)

    def prefill_slots(self) -> list[int]:
        """Mid-prefill slots in FCFS begin order (the chunk-budget order)."""
        return list(self._prefilling)

    def admit(self, defer=()) -> list[tuple[int, EngineRequest]]:
        """Move queued requests into free slots (FCFS). ``defer`` names
        request classes to skip over this step (the degradation ladder's
        rung 2): deferred requests keep their queue position."""
        placed = []
        for slot in self.free_slots():
            if defer:
                req = next((r for r in self.queue if r.cls not in defer),
                           None)
                if req is None:
                    break
                self.queue.remove(req)
            elif self.queue:
                req = self.queue.popleft()
            else:
                break
            self.slots[slot] = req
            self.n_admitted += 1
            placed.append((slot, req))
            queued_s = self.clock() - req.t_submit
            self.admit_latency_s.append(queued_s)
            if self._mx:
                self._mx["admitted"].inc()
                self._mx["admit_latency"].observe(queued_s)
            if self.tracer:
                self.tracer.event("admit", uid=int(req.uid), slot=int(slot),
                                  queued_s=queued_s)
            if self.journal:
                self.journal.event("admit", uid=int(req.uid), slot=int(slot))
        self.queue_depth_hist.append(len(self.queue))
        if self._mx:
            self._mx["depth"].set(len(self.queue))
        return placed

    def retire(self, slot: int, reason: str = "eos") -> EngineRequest:
        """Free a slot whose request finished; ``reason`` is one of
        obs.schema.RETIRE_REASONS."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"retire of empty slot {slot}")
        self.slots[slot] = None
        if slot in self._prefilling:            # retired mid-prefill
            self._prefilling.remove(slot)
        self._finish(req, reason, slot=slot)
        return req

    def _finish(self, req: EngineRequest, reason: str,
                slot: Optional[int] = None) -> None:
        """The one terminal transition: slotted retires, queue drops and
        shed-at-submit all end here, so every request finishes exactly
        once with exactly one reason. ``slot=None``: it never held one
        (journaled as slot -1)."""
        if req.done:
            raise RuntimeError(f"double finish of uid {req.uid}")
        req.done = True
        req.t_done = self.clock()
        req.finish_reason = reason
        self.finished.append(req)
        if reason == "shed":
            self.n_shed += 1
        elif reason == "cancelled":
            self.n_cancelled += 1
        if self._mx:
            self._mx["retired"].inc()
            if reason in ("shed", "cancelled"):
                self._mx[reason].inc()
        if self.tracer:
            self.tracer.event("retire", uid=int(req.uid),
                              slot=-1 if slot is None else int(slot),
                              reason=reason, n_out=len(req.out))
        if self.journal:
            # the output rides along: after compaction it is the only
            # trace of a finished request, and a recovering supervisor
            # reports pre-crash finishers from it
            self.journal.event("retire", uid=int(req.uid),
                               slot=-1 if slot is None else int(slot),
                               reason=reason, n_out=len(req.out),
                               out=[int(t) for t in req.out])

    def drop_queued(self, req: EngineRequest, reason: str) -> None:
        """Finish a request still waiting in the queue (cancel, deadline
        sweep, forced drain) without it ever holding a slot."""
        self.queue.remove(req)
        if self._mx:
            self._mx["depth"].set(len(self.queue))
        self._finish(req, reason)

    def shed_queued_to(self, target_depth: int,
                       prefer=SHED_CLASSES) -> int:
        """Shed queued requests (oldest ``prefer``-class first, then the
        FCFS head) until the queue is at ``target_depth`` — the ladder's
        rung 3. Returns how many were shed."""
        n = 0
        while len(self.queue) > max(0, int(target_depth)):
            victim = next((r for r in self.queue if r.cls in prefer),
                          self.queue[0])
            self.drop_queued(victim, "shed")
            n += 1
        return n

    # ------------------------------------------------------------- state --
    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)

    def utilization(self) -> float:
        """Mean fraction of slots decoding over the steps recorded by
        :meth:`note_step`."""
        if not self._active_hist:
            return 0.0
        return sum(self._active_hist) / (len(self._active_hist)
                                         * self.n_slots)

    def note_step(self, n_active: int) -> None:
        self._active_hist.append(n_active)

    # ------------------------------------------- speculative decoding --
    def note_spec(self, slot: int, proposed: int, accepted: int) -> None:
        """Record one verify call's outcome: ``proposed`` draft tokens
        were scored for ``slot``, the first ``accepted`` matched the
        target."""
        assert 0 <= accepted <= proposed, (slot, proposed, accepted)
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self.accept_hist.append(accepted)
        self.spec_by_slot[slot][0] += proposed
        self.spec_by_slot[slot][1] += accepted
        if proposed:                            # a 1-row window proposes
            rate = accepted / proposed          # nothing: no signal
            a = self.accept_ewma_alpha
            self.accept_ewma = rate if self.accept_ewma is None else \
                (1 - a) * self.accept_ewma + a * rate

    def acceptance_rate(self) -> Optional[float]:
        """Fraction of proposed draft tokens the target accepted."""
        if not self.spec_proposed:
            return None
        return self.spec_accepted / self.spec_proposed


# ----------------------------------------------- admission set point ----
def admission_set_point(open_loop: Optional[dict], slack: float = 2.0,
                        floor: int = 2) -> Optional[int]:
    """The bounded-queue set point from a measured open-loop section
    (``knee`` and ``points``, as the JAX package's serving benchmark
    writes it; DESIGN.md §12): ``slack`` times the p95 queue depth that
    arrivals saw at the knee's last SLO-attaining offered rate, at least
    ``floor``. None when the section is missing, the sweep never
    saturated, or the knee point lacks the depth signal."""
    if not open_loop:
        return None
    knee = open_loop.get("knee") or {}
    last_ok = knee.get("last_ok_offered_rps")
    if last_ok is None:
        return None
    pt = next((p for p in open_loop.get("points") or []
               if p.get("offered_rps") == last_ok), None)
    depth = (pt or {}).get("queue_depth_at_submit_p95")
    if depth is None:
        return None
    return max(int(floor), int(math.ceil(float(depth) * slack)))
