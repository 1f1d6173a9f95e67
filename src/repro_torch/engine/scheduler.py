"""Token-level continuous-batching scheduler (port of
``repro.engine.scheduler``): FCFS admission into a fixed pool of N slots,
per-step retire and refill, and the chunked-prefill slot states.

Pure-Python bookkeeping; it never touches device tensors. It also keeps
the speculative decoder's draft-proposed and draft-accepted counts.
Admission control, shedding, deadlines, the journal, the acceptance
EWMA and the metrics hooks of the JAX scheduler are not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional


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
    finish_reason: Optional[str] = None   # "eos" | "budget" | "max_len" |
                                          # "zero_budget"

    @property
    def ttft(self) -> Optional[float]:
        if self.t_submit is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit


class Scheduler:
    """FCFS queue + fixed slot pool."""

    def __init__(self, n_slots: int, clock=time.perf_counter):
        self.n_slots = n_slots
        self.clock = clock
        self.queue: collections.deque[EngineRequest] = collections.deque()
        self.slots: list[Optional[EngineRequest]] = [None] * n_slots
        self.finished: list[EngineRequest] = []
        # admitted but not fully prefilled: occupied, not decoding
        self._prefilling: list[int] = []
        # speculative decoding: draft tokens proposed and accepted, in all
        # and per slot, and the accepted count of each verify call
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.accept_hist: list[int] = []
        self.spec_by_slot: list[list[int]] = [[0, 0] for _ in range(n_slots)]

    def submit(self, req: EngineRequest) -> EngineRequest:
        req.t_submit = self.clock()
        self.queue.append(req)
        return req

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def active_slots(self) -> list[int]:
        """Slots decoding this step: occupied and not mid-prefill."""
        return [i for i, r in enumerate(self.slots)
                if r is not None and i not in self._prefilling]

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

    def admit(self) -> list[tuple[int, EngineRequest]]:
        """Move queued requests into free slots (FCFS)."""
        placed = []
        for slot in self.free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            self.slots[slot] = req
            placed.append((slot, req))
        return placed

    def retire(self, slot: int, reason: str = "eos") -> EngineRequest:
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"retire of empty slot {slot}")
        self.slots[slot] = None
        if slot in self._prefilling:
            self._prefilling.remove(slot)
        req.done = True
        req.finish_reason = reason
        self.finished.append(req)
        return req

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

    def acceptance_rate(self) -> Optional[float]:
        """Fraction of proposed draft tokens the target accepted."""
        if not self.spec_proposed:
            return None
        return self.spec_accepted / self.spec_proposed

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)
