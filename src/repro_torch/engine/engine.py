"""Continuous-batching inference engine (port of the core of
``repro.engine.engine``).

``Engine`` owns a :class:`Scheduler`, a preallocated
:class:`~repro_torch.engine.kvcache.SlotKVCache` (optionally INT8) and
the model's slot entry points. Each :meth:`Engine.step`

1. admits queued requests into free slots — with ``prefill_chunk=0``
   each is prefilled at once (ONE-SHOT: a dense ``transformer.prefill``
   of the right-padded prompt, written into its slot by
   ``kvcache.write_prefill``, one K/V write launch a layer);
2. otherwise spends at most ``prefill_chunk`` prompt tokens on
   mid-prefill slots (FCFS), streaming whole chunks through
   ``transformer.prefill_chunk_slots`` — and, while no slot is decoding,
   keeps prefilling until one joins the decode batch;
3. runs ONE batched decode step over all N slots at their own
   positions, sampling on the device (greedy argmax, or with
   ``temperature > 0`` a draw from softmax(logits / T) with the engine's
   ``torch.Generator``) and copying the (N,) tokens to the host — or,
   with ``spec_k > 0``, one speculative step
   (:meth:`Engine._spec_step`: the draft proposes, the target verifies
   each slot's window in one pass, 1..spec_k+1 tokens commit per slot);
4. retires finished slots (``clear_slot``) so the next step refills them.

Idle slots ride along in the fixed-shape decode batch at position 0 with
token 0, and mid-prefill slots are parked at their next-unwritten
position: the garbage row a parked write marks valid is exactly the row
the slot's next chunk overwrites, and the chunk kernel masks cache rows
at >= pos_start, so it is never attended.

Chunk sizes are ``bucket_len(n, prefill_bucket, prefill_chunk)``, as in
the JAX engine, so both fill the cache with the same rows. An int8 cache
takes static per-layer scales from a calibration recipe with
``kv_scales=`` (or hot-swapped into a live dynamic cache by
:meth:`Engine.load_kv_scales`); an fp cache is stored in ``kv_dtype``
(fp32, bf16 or float16). ``fused_attn=False`` decodes through the materialize read
path (each layer's cache copied to full precision and attended in plain
PyTorch), the JAX package's oracle. Torch cannot reproduce
``jax.random.categorical``: temperature sampling draws other tokens than
the JAX engine from the same distribution. A speculative engine takes its
draft as ``draft_params=`` or mints it from a calibration recipe
(``draft_recipe``, :func:`~repro_torch.engine.spec.load_draft_params`).

Fault tolerance (DESIGN.md §12, ``engine/faults.py``): ``submit`` takes a
request class and TTFT / total deadlines, swept at step boundaries;
``cancel`` retires a request wherever it is; a bounded queue
(``max_queue``) sheds by ``overload_policy``; the degradation ladder
(``degrade``) suspends speculation, defers batch-class admissions and
sheds queued load under sustained backlog; a failed decode step (an
injected fault of ``fault_spec``, or a sampled token outside the vocab)
rolls every decoding slot back and runs again, and a slot that keeps
failing is quarantined as "failed". A CUDA error is not such a failure:
it propagates. ``drain`` has a watchdog. Crash safety (DESIGN.md §13,
``engine/recovery.py``): a request journal (``journal_path``) fsync'd at
every step boundary, periodic snapshots (``snapshot_path``,
``snapshot_every``), an injected crash at the step boundary, and
``snapshot`` / ``restore`` / ``recover``. An always-on metrics registry
(``metrics``, ``registry=``) counts all of it under the JAX package's
instrument names, and :meth:`Engine.metrics` summarizes a run.

Observability (DESIGN.md §10, §14), in the JAX package's names and record
formats: a default-off tracer (``trace``, ``tracer=``) records the
lifecycle events and a span for every phase of a step, each launch phase
split into ``dispatch_s`` (host time until its launches returned) and
``wait_s`` (the device wait: the host copy of the tokens, or in traced
mode only a ``torch.cuda.synchronize`` after a prefill chunk), and
``metrics()["phase_attribution"]`` sums them; ``trace_kv_every`` and
``metrics_kv_every`` sample ``kvcache.kv_quality_counters`` from the
live int8 cache into the trace and into gauges. An always-on
flight recorder (``flight``) keeps one coarse record a step, and with
``incident_dir`` the anomaly detectors (``obs/detect.py``) sweep each
record and write an incident bundle (``obs/flight.py``) when one fires;
:meth:`Engine.dump_incident` writes one on demand. An untraced engine
pays one branch a site.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import transformer
from ..models.common import dtype_of
from .faults import DegradationLadder, FaultInjector, StepFailure
from .kvcache import (clear_slot, hotswap_static_scales, init_slot_cache,
                      kv_quality_counters, rollback_slot, write_prefill)
from .scheduler import EngineRequest, Scheduler, SubmitError
from .spec import (SpecDecoder, accept_length, load_draft_params,
                   verify_window)

#: families the engine serves (as the JAX engine: a VLM's requests are
#: text; its patch prefix enters through ``transformer.prefill``)
ENGINE_FAMILIES = ("dense", "moe", "vlm")

#: One-shot prefills so far in this process: each dispatch materializes a
#: dense full-precision (L, S, Hkv, D) cache that ``write_prefill`` then
#: writes into the slot (a speculative engine's draft mirror counts
#: once more). The chunked path never bumps it.
FP_PREFILL_MATERIALIZATIONS = 0


def sample_tokens(logits, temperature: float, generator=None
                  ) -> torch.Tensor:
    """logits (..., V) → token ids (...) on their device: the argmax when
    ``temperature <= 0``, else one draw a row from softmax(logits / T)
    (fp32) with ``generator`` (the JAX package's
    ``jax.random.categorical``, whose bits torch cannot reproduce)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    toks = torch.multinomial(flat, 1, generator=generator)
    return toks.reshape(probs.shape[:-1])


def bucket_len(n: int, bucket: int, max_len: int) -> int:
    """Round a length up to its bucket, capped at ``max_len``."""
    return min(max_len, -(-n // bucket) * bucket)


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 8
    max_len: int = 256
    max_new_tokens: int = 32            # default per-request token budget
    eos_id: int = -1                    # -1 ⇒ never stop early
    kv_mode: str = "fp"                 # "fp" | "int8" (SplitQuant §4.2)
    kv_qchunks: int = 4                 # ranges per head vector (int8)
    kv_dtype: str = "float32"           # fp-mode storage: float32 |
                                        # bfloat16 | float16
    prefill_bucket: int = 16            # chunk and one-shot prompt lengths
                                        # round up to this
    fused_attn: bool = True             # decode reads the cache through the
                                        # fused kernel; False = materialize
                                        # then attend (the oracle path)
    prefill_chunk: int = 96             # prompt tokens per step; 0 =
                                        # one-shot prefill at admission
    temperature: float = 0.0            # 0 ⇒ greedy
    spec_k: int = 0                     # >0: self-speculative decoding, up
                                        # to spec_k draft tokens per slot
                                        # and step; token-identical to
                                        # spec_k=0 greedy
    draft_recipe: Optional[str] = None  # calibration recipe dir the draft
                                        # is minted from when no
                                        # draft_params are given
    draft_dequantize: bool = True       # expand the draft's packed low-bit
                                        # weights once at engine start
    metrics: bool = True                # always-on metrics registry
                                        # (obs.metrics); False leaves the
                                        # engine without one (registry=
                                        # still wins)
    metrics_kv_every: int = 0           # >0: sample KV clip-fraction /
                                        # occupancy gauges from live int8
                                        # cache rows every N steps (a
                                        # bounded copy to the host, so
                                        # not free)
    trace: bool = False                 # default-off tracer (obs.tracer):
                                        # lifecycle events + per-step
                                        # phase spans with dispatch vs
                                        # device-wait attribution; adds a
                                        # device sync after each prefill
                                        # chunk — a profiling mode
    trace_capacity: int = 1 << 16       # tracer ring records; the oldest
                                        # drop first on overflow
    trace_kv_every: int = 0             # >0 (traced, int8): a KV quality
                                        # counter record every N steps
    # --- fault tolerance (engine/faults.py, DESIGN.md §12) --------------
    max_queue: int = 0                  # >0: bounded submit queue; an
                                        # arrival into a full queue
                                        # triggers overload_policy
    overload_policy: str = "reject-new" # "reject-new" | "shed-oldest" |
                                        # "shed-by-class"
    degrade: bool = False               # graceful-degradation ladder:
                                        # spec off (rung 1), defer batch
                                        # admissions (2), shed queued (3)
    degrade_thresholds: tuple = ()      # 3 ascending pressure bounds
                                        # (queue depth + prefill backlog
                                        # chunks); () → (N, 2N, 4N)
    degrade_patience: int = 2           # steps a crossing must persist
                                        # before the rung moves (descent
                                        # takes 2x)
    max_retries: int = 2                # per-slot consecutive-failure
                                        # budget of step retry; one more
                                        # quarantines the request
    retry_backoff_s: float = 0.0005     # base of the bounded exponential
                                        # backoff between attempts
    fault_spec: Optional[object] = None # faults.FaultSpec: seeded
                                        # synthetic fault injection; None =
                                        # none (retry is always on)
    # --- crash safety (engine/recovery.py, DESIGN.md §13) ---------------
    journal_path: Optional[str] = None  # append-only JSONL WAL of request
                                        # transitions, fsync'd each step
    journal_resume: bool = False        # append to an existing journal
                                        # (recovery) instead of a new one
    snapshot_path: Optional[str] = None # directory Engine.snapshot()
                                        # writes (atomic tmp + rename)
    snapshot_every: int = 0             # >0: snapshot every N steps at the
                                        # end-of-step boundary, after the
                                        # journal's fsync
    # --- flight recorder + incident capture (obs/flight.py, §14) --------
    flight: bool = True                 # always-on bounded ring of coarse
                                        # per-step records (the black box)
    flight_capacity: int = 512          # ring size in steps
    incident_dir: Optional[str] = None  # arm the anomaly-detector sweep
                                        # and write incident bundles here
                                        # (atomic tmp + fsync + rename);
                                        # None = sweep off, recorder on
    incident_cooldown: int = 50         # steps: per-detector refire
                                        # cooldown AND the least gap
                                        # between bundles


class Engine:
    """submit()/step()/drain() continuous-batching server on ``device``
    (the card unless ``device="cpu"``). ``params`` must already live on
    that device.

    ``kv_scales``: static KV quantization constants of a calibration
    recipe, ``k_scale / k_zero / v_scale / v_zero`` (L, Hkv, C) arrays;
    requires ``kv_mode="int8"``. ``draft_params``: the draft's weights for
    ``spec_k > 0`` (the same architecture, typically a low-bit SplitQuant
    copy, on the same device); without them the draft is minted from
    ``ecfg.draft_recipe``, and without that the target drafts for itself.
    ``generator``: the ``torch.Generator`` temperature sampling draws
    from, on ``device`` (the counterpart of the JAX engine's ``rng=``);
    by default one seeded 0. ``registry``: a metrics registry to count
    into (shared across engines, e.g. carried over a supervised restart);
    by default, with ``ecfg.metrics``, a private one. ``tracer``: an
    ``obs.Tracer`` to record into; by default, with ``ecfg.trace``, one
    on the engine's clock.
    """

    def __init__(self, cfg, params, ecfg: EngineConfig, device=None,
                 clock=time.perf_counter, *, kv_scales=None,
                 draft_params=None, generator=None, registry=None,
                 tracer=None):
        if cfg.family not in ENGINE_FAMILIES:
            raise NotImplementedError(
                f"the port's engine serves {', '.join(ENGINE_FAMILIES)} "
                f"decoders, got {cfg.family!r}"
                + (" — and spec_k > 0 additionally needs positional KV "
                   "rollback, which recurrent state cannot provide"
                   if ecfg.spec_k else ""))
        if ecfg.spec_k and ecfg.temperature > 0:
            raise NotImplementedError(
                "spec_k > 0 requires greedy decoding (temperature <= "
                "0): the lossless accept rule compares argmax tokens; "
                "temperature sampling needs speculative rejection "
                "sampling, which is not wired up")
        if ecfg.fault_spec and ecfg.spec_k:
            raise NotImplementedError(
                "fault injection targets the plain decode path; the "
                "speculative path's verify/rollback already exercises "
                "mid-step recovery and injecting there would need "
                "draft-cache-aware retry bookkeeping that is not wired "
                "up — run chaos with spec_k=0 (the ladder's rung-1 "
                "configuration)")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.clock = clock
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(0))
        # --- observability: an explicit tracer wins; else ecfg.trace mints
        # one on the engine's clock. Falsy tracers normalize to None, so
        # every hot-path site guards with one `if tr:` ---------------------
        if tracer is None and ecfg.trace:
            from ..obs.tracer import Tracer
            tracer = Tracer(capacity=ecfg.trace_capacity, clock=clock,
                            meta={"arch": cfg.name, "n_slots": ecfg.n_slots,
                                  "spec_k": ecfg.spec_k,
                                  "kv_mode": ecfg.kv_mode,
                                  "prefill_chunk": ecfg.prefill_chunk})
        self.tracer = tracer if tracer else None
        # --- always-on metrics registry (obs.metrics) -------------------
        # instruments resolve ONCE here, so the hot path is attribute
        # operations behind one `if mx:`
        self.registry = None
        self._mx = None
        if registry is not None or ecfg.metrics:
            from ..obs.metrics import RESTORE_BUCKETS_S, MetricsRegistry
            self.registry = r = (registry if registry is not None
                                 else MetricsRegistry())
            self._mx = {
                "steps": r.counter("engine_steps", "Engine.step() calls"),
                "decode_steps": r.counter(
                    "engine_decode_steps", "batched plain-decode steps"),
                "spec_steps": r.counter(
                    "engine_spec_steps", "speculative decode steps"),
                "tokens": r.counter(
                    "engine_tokens_generated", "committed output tokens"),
                "prefill_tokens": r.counter(
                    "engine_prefill_tokens", "prompt tokens prefilled"),
                "prefill_chunks": r.counter(
                    "engine_prefill_chunks", "fused prefill chunks run"),
                "step_s": r.histogram(
                    "engine_step_seconds", "full Engine.step() wall"),
                "decode_s": r.histogram(
                    "engine_decode_step_seconds",
                    "batched decode dispatch + device + sample"),
                "occupancy": r.gauge(
                    "engine_slot_occupancy",
                    "occupied slots (decoding + mid-prefill) / n_slots"),
                "decoding": r.gauge(
                    "engine_slots_decoding", "slots in the decode batch"),
                "backlog": r.gauge(
                    "engine_prefill_backlog_chunks",
                    "prompt chunks still to stream for mid-prefill slots"),
                "in_flight": r.gauge(
                    "engine_tokens_in_flight",
                    "unexhausted generation budget across occupied slots"),
                "deadline": r.counter(
                    "engine_deadline_exceeded",
                    "requests retired by the step-boundary deadline "
                    "sweep (TTFT or total-wall)"),
                "retries": r.counter(
                    "engine_step_retries",
                    "decode step re-executions after rollback (injected "
                    "or detected failures)"),
                "rung": r.gauge(
                    "engine_degradation_rung",
                    "current degradation-ladder rung (0 normal, 1 spec "
                    "off, 2 defer batch, 3 shed)"),
                "degr_transitions": r.counter(
                    "engine_degradation_transitions",
                    "degradation-ladder rung changes"),
                # registered unconditionally: a box that never crashes
                # still exports the zeros an alert can sit on
                "snapshots": r.counter(
                    "engine_snapshots",
                    "engine state snapshots written (atomic tmp+rename)"),
                "restores": r.counter(
                    "engine_restore",
                    "engine state restores from a snapshot"),
                "replayed": r.counter(
                    "engine_journal_replayed_requests",
                    "un-retired requests resumed or re-enqueued by "
                    "journal replay after a restore"),
                "restore_s": r.histogram(
                    "engine_restore_duration_s",
                    "snapshot restore + journal replay wall time",
                    buckets=RESTORE_BUCKETS_S),
            }
            # rung 0 is a real state, not "unset"
            self._mx["rung"].set(0)
            if ecfg.spec_k:
                self._mx["accept_ewma"] = r.gauge(
                    "spec_accept_ewma",
                    "EWMA of per-verify draft-token acceptance fraction")
            if ecfg.metrics_kv_every:
                for side in ("k", "v"):
                    self._mx[f"kv_{side}_clip"] = r.gauge(
                        f"kv_{side}_clip_frac",
                        f"sampled {side.upper()}-cache code saturation "
                        f"(static scale drifted narrow when trending up)")
                    self._mx[f"kv_{side}_occ"] = r.gauge(
                        f"kv_{side}_occupancy",
                        f"sampled {side.upper()}-cache code-range use "
                        f"(scale drifted wide when trending down)")
        # --- crash safety: the journal is a WAL, written when configured
        # and fsync'd once per step boundary ------------------------------
        self.journal = None
        if ecfg.journal_path:
            from .recovery import RequestJournal
            self.journal = RequestJournal(
                ecfg.journal_path, clock=clock,
                meta={"arch": cfg.name, "n_slots": ecfg.n_slots,
                      "kv_mode": ecfg.kv_mode, "spec_k": ecfg.spec_k},
                resume=ecfg.journal_resume)
        self.sched = Scheduler(ecfg.n_slots, clock=clock,
                               registry=self.registry,
                               max_queue=ecfg.max_queue,
                               overload_policy=ecfg.overload_policy,
                               journal=self.journal, tracer=self.tracer)
        # --- fault tolerance -------------------------------------------
        self._faults = (FaultInjector(ecfg.fault_spec)
                        if ecfg.fault_spec else None)
        self._ladder = None
        self._rung = 0
        if ecfg.degrade:
            N_ = ecfg.n_slots
            self._ladder = DegradationLadder(
                ecfg.degrade_thresholds or (N_, 2 * N_, 4 * N_),
                patience=ecfg.degrade_patience)
        # --- flight recorder + incident capture (obs/flight.py, §14): the
        # recorder is always on unless disabled; the detector sweep runs
        # only with an incident_dir, so a plain run pays one ring append
        self._flight = None
        if ecfg.flight:
            from ..obs.flight import FlightRecorder
            self._flight = FlightRecorder(
                capacity=ecfg.flight_capacity, clock=clock,
                meta={"arch": cfg.name, "n_slots": ecfg.n_slots,
                      "kv_mode": ecfg.kv_mode, "spec_k": ecfg.spec_k})
        self._detect = None
        if ecfg.incident_dir:
            from ..obs.detect import AnomalyDetector
            self._detect = AnomalyDetector(
                cooldown_steps=ecfg.incident_cooldown,
                queue_set_point=(ecfg.max_queue or None))
        self.incidents: list = []        # bundle paths written this run
        self._last_bundle_step = None
        # the latest KV quality samples (the metrics_kv_every pull); None
        # until the first
        self._last_clip_frac = None
        self._last_span_frac = None
        self.cache = init_slot_cache(
            cfg, ecfg.n_slots, ecfg.max_len, mode=ecfg.kv_mode,
            dtype=dtype_of(ecfg.kv_dtype), qchunks=ecfg.kv_qchunks,
            kv_scales=kv_scales, device=self.device)
        self._spec = None
        if ecfg.spec_k:
            if draft_params is None:
                draft_params = (load_draft_params(ecfg.draft_recipe, params,
                                                  cfg)
                                if ecfg.draft_recipe else params)
            self._spec = SpecDecoder(cfg, ecfg, draft_params, self.device,
                                     registry=self.registry,
                                     tracer=self.tracer)
        N = ecfg.n_slots
        self._last_tok = np.zeros(N, np.int64)
        self._pos = np.zeros(N, np.int64)
        self._prefill_prog = np.zeros(N, np.int64)
        # consecutive corrupt-output attempts per slot (step retry)
        self._fail_streak = np.zeros(N, np.int64)
        self._uid = 0
        self._any_deadlines = False     # skip the sweep until a submit
                                        # carries a deadline
        self.n_step_retries = 0
        self.n_quarantined = 0
        self.n_decode_steps = 0         # decode dispatches (retried
                                        # attempts included)
        self.n_prefills = 0             # one-shot admissions
        self.n_prefill_chunks = 0
        self.decode_step_s: list[float] = []
        self.prefill_s: list[float] = []
        self.prefill_chunk_s: list[float] = []
        self.n_spec_steps = 0
        self.n_verify_calls = 0
        self.n_verify_tokens = 0
        self.n_spec_commit_tokens = 0   # tokens appended by spec steps
        self.n_rollbacks = 0            # verify calls that rejected rows
        self.spec_step_s: list[float] = []
        # full step() wall, prompt tokens prefilled and slots already
        # decoding at step start, a step each
        self.step_s: list[float] = []
        self.step_prefill_tokens: list[int] = []
        self.step_decode_slots: list[int] = []
        self._t_start: Optional[float] = None

    def load_kv_scales(self, kv_scales: dict) -> None:
        """Hot-swap a recipe's static KV scales into the live dynamic int8
        cache without draining slots: the codes are requantized once, and
        every later write skips the min/max reduce and the scale arrays.
        (The draft's twin cache keeps its dynamic scales.)"""
        self.cache = hotswap_static_scales(self.cache, kv_scales)

    # ------------------------------------------------------------ intake --
    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               cls: Optional[str] = None,
               ttft_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue a request; returns its uid. Work happens in step().

        A malformed request raises :class:`SubmitError` here, before it
        takes queue space. ``cls`` is the request class (the overload and
        ladder key); the deadlines are seconds from submit, enforced at
        step boundaries. A bounded queue may shed on submit: the uid is
        still returned and the request finishes as "shed"."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) == 0:
            raise SubmitError("empty_prompt",
                              "empty prompt (no tokens to prefill)")
        budget = int(self.ecfg.max_new_tokens if max_new_tokens is None
                     else max_new_tokens)
        if budget < 0:
            raise SubmitError("bad_budget",
                              f"max_new_tokens must be >= 0, got {budget}")
        if len(prompt) + budget > self.ecfg.max_len:
            raise SubmitError(
                "too_long", f"prompt ({len(prompt)}) + max_new_tokens "
                            f"({budget}) exceeds max_len {self.ecfg.max_len}")
        req = EngineRequest(uid=self._uid, prompt=prompt,
                            max_new_tokens=budget, cls=cls,
                            ttft_deadline_s=ttft_deadline_s,
                            deadline_s=deadline_s)
        self._uid += 1
        if ttft_deadline_s is not None or deadline_s is not None:
            self._any_deadlines = True
        if self._faults is not None:
            self._faults.note_submit(req.uid)
        self.sched.submit(req)
        return req.uid

    def cancel(self, uid: int) -> bool:
        """Cancel a request: a queued one finishes at once ("cancelled",
        never held a slot); a slotted one — mid-chunked-prefill included —
        retires through the full slot release, so its cache rows, draft
        twin and prefill bookkeeping free together. False when the uid is
        unknown or already finished (cancel is idempotent)."""
        for req in self.sched.queue:
            if req.uid == uid:
                if self.tracer:
                    self.tracer.event("cancel", uid=int(uid), slot=-1)
                self.sched.drop_queued(req, "cancelled")
                return True
        for slot, req in enumerate(self.sched.slots):
            if req is not None and req.uid == uid:
                if self.tracer:
                    self.tracer.event("cancel", uid=int(uid), slot=slot)
                self._retire(slot, "cancelled")
                return True
        return False

    def _deadline_expired(self, req: EngineRequest, now: float) -> bool:
        if req.t_submit is None:
            return False
        waited = now - req.t_submit
        if req.deadline_s is not None and waited > req.deadline_s:
            return True
        return (req.ttft_deadline_s is not None
                and req.t_first_token is None
                and waited > req.ttft_deadline_s)

    def _enforce_deadlines(self) -> None:
        """Step-boundary deadline sweep: queued requests past their TTFT
        or total deadline retire as "deadline_exceeded" without taking a
        slot, and slotted ones (mid-prefill included) free theirs."""
        now = self.clock()
        for req in [r for r in self.sched.queue
                    if self._deadline_expired(r, now)]:
            self.sched.drop_queued(req, "deadline_exceeded")
            if self._mx:
                self._mx["deadline"].inc()
        for slot, req in enumerate(self.sched.slots):
            if req is not None and self._deadline_expired(req, now):
                self._retire(slot, "deadline_exceeded")
                if self._mx:
                    self._mx["deadline"].inc()

    # ----------------------------------------------------------- serving --
    def _retire(self, slot: int, reason: str) -> None:
        """Free the slot everywhere: scheduler, cache rows, host state."""
        self.sched.retire(slot, reason=reason)
        clear_slot(self.cache, slot)
        if self._spec is not None:
            self._spec.clear(slot)
        self._pos[slot] = 0
        self._last_tok[slot] = 0

    def _evict_slot(self, slot: int) -> None:
        """Recovery only: drop a restored slot whose request the journal
        proves already retired after the snapshot — clear its cache rows
        and host state WITHOUT a second retire (exactly once across the
        crash)."""
        if slot in self.sched._prefilling:
            self.sched._prefilling.remove(slot)
        self.sched.slots[slot] = None
        clear_slot(self.cache, slot)
        if self._spec is not None:
            self._spec.clear(slot)
        self._pos[slot] = 0
        self._last_tok[slot] = 0
        self._prefill_prog[slot] = 0
        self._fail_streak[slot] = 0

    def _sample(self, logits) -> torch.Tensor:
        """logits (..., V) → token ids (...) on the device, greedy or
        drawn with the engine's generator (:func:`sample_tokens`)."""
        return sample_tokens(logits, self.ecfg.temperature, self.generator)

    def _start_decoding(self, slot: int, req: EngineRequest, logits_row,
                        S: int) -> None:
        """The prompt is written: sample the first generated token from
        the prompt's last logits row (V,) and move the slot into decode
        (or retire it on eos / exhausted budget)."""
        first = int(self._sample(logits_row))
        req.t_first_token = self.clock()
        if self.tracer:
            self.tracer.event("first_token", uid=int(req.uid),
                              slot=int(slot))
        if self.journal:
            self.journal.event("first_token", uid=int(req.uid),
                               slot=int(slot))
        if first == self.ecfg.eos_id:
            self._retire(slot, "eos")
            return
        req.out.append(first)
        if self._mx:
            self._mx["tokens"].inc()
        self._last_tok[slot] = first
        self._pos[slot] = S
        if len(req.out) >= req.max_new_tokens:
            self._retire(slot, "budget")
        elif S >= self.ecfg.max_len:
            self._retire(slot, "max_len")

    def _admit_one(self, slot: int, req: EngineRequest) -> int:
        """One-shot admission (``prefill_chunk=0``): a dense prefill of
        the prompt right-padded to its bucket (the full-precision
        (L, S, Hkv, D) materialization), written into the slot by
        ``write_prefill``, then the first token from the logits row of
        the prompt's last token. Returns prompt tokens prefilled."""
        global FP_PREFILL_MATERIALIZATIONS
        if req.max_new_tokens <= 0:
            req.t_first_token = req.t_submit
            self.sched.retire(slot, reason="zero_budget")
            return 0
        tr = self.tracer
        t_span = tr.begin() if tr else 0.0
        t0 = self.clock()
        S = len(req.prompt)
        Sp = bucket_len(S, self.ecfg.prefill_bucket, self.ecfg.max_len)
        toks = np.zeros((1, Sp), np.int64)
        toks[0, :S] = req.prompt                      # right-pad
        toks = torch.from_numpy(toks).to(self.device)
        t_d = tr.now() if tr else 0.0
        logits, pcache = transformer.prefill(self.params, self.cfg,
                                             {"tokens": toks})
        dispatch_s = (tr.now() - t_d) if tr else 0.0
        self.n_prefills += 1
        FP_PREFILL_MATERIALIZATIONS += 1
        # only [0, S) becomes visible; the bucket's padding stays masked
        write_prefill(self.cache, slot, pcache, S)
        del pcache
        if self._spec is not None:    # the draft's own materialization
            self._spec.prefill_oneshot(toks, slot, S)
            FP_PREFILL_MATERIALIZATIONS += 1
        # the first token's copy waits for the prefill, so the span's tail
        # (dur - dispatch_s) is device wait + first-token work
        self._start_decoding(slot, req, logits[0, S - 1], S)
        self.prefill_s.append(self.clock() - t0)
        if tr:
            tr.span_end("prefill_oneshot", t_span, slot=slot, uid=int(req.uid),
                        tokens=S, dispatch_s=dispatch_s)
        return S

    def _admit_chunked(self, slot: int, req: EngineRequest) -> None:
        if req.max_new_tokens <= 0:
            req.t_first_token = req.t_submit
            self.sched.retire(slot, reason="zero_budget")
            return
        self.sched.begin_prefill(slot)
        self._prefill_prog[slot] = 0
        self._pos[slot] = 0                           # parked
        self._last_tok[slot] = 0

    def _prefill_work(self) -> int:
        """Spend one step's ``prefill_chunk`` budget on mid-prefill slots,
        FCFS. A slot's next chunk is always min(prefill_chunk, remaining
        prompt) and is never split to fit a leftover budget, so chunk
        boundaries depend only on the prompt length (an int8 cache makes
        them visible in the tokens). Returns prompt tokens processed."""
        ecfg = self.ecfg
        budget = ecfg.prefill_chunk
        spent = 0
        tr = self.tracer
        for slot in self.sched.prefill_slots():
            req = self.sched.slots[slot]
            S = len(req.prompt)
            done = int(self._prefill_prog[slot])
            n = min(ecfg.prefill_chunk, S - done)
            if n > budget:
                break
            t_span = tr.begin() if tr else 0.0
            Sc = bucket_len(n, ecfg.prefill_bucket, ecfg.prefill_chunk)
            toks = np.zeros((1, Sc), np.int64)
            toks[0, :n] = req.prompt[done:done + n]   # right-pad the chunk
            t0 = self.clock()
            pos_start = done
            toks = torch.from_numpy(toks).to(self.device)
            t_d = tr.now() if tr else 0.0
            logits = transformer.prefill_chunk_slots(
                self.params, self.cfg, self.cache, toks, slot, done, n)
            dispatch_s = (tr.now() - t_d) if tr else 0.0
            if self._spec is not None:        # mirror the chunk to the draft
                self._spec.prefill_chunk(toks, slot, done, n)
            wait_s = 0.0
            if tr:
                # traced-mode sync: launches are asynchronous, so without
                # it the chunk's device time would surface as somebody
                # else's wait. A deliberate profiling cost.
                t_w = tr.now()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                wait_s = tr.now() - t_w
            budget -= n
            spent += n
            done += n
            self._prefill_prog[slot] = done
            self._pos[slot] = done                    # parked position
            self.n_prefill_chunks += 1
            if self._mx:
                self._mx["prefill_chunks"].inc()
            if done >= S:                             # prompt complete
                self.sched.finish_prefill(slot)
                self._start_decoding(slot, req, logits[0], S)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)   # the chunk's device time
            self.prefill_chunk_s.append(self.clock() - t0)
            if tr:
                tr.span_end("prefill_chunk", t_span, slot=slot,
                            uid=int(req.uid), pos_start=pos_start, n=n,
                            dispatch_s=dispatch_s, wait_s=wait_s)
        return spent

    def _dispatch_decode(self, n_active: int) -> np.ndarray:
        """One batched decode step over all N slots, sampled on the
        device; returns the per-slot tokens on the host (one (N,) copy,
        the device wait of the traced ``decode`` span)."""
        tr = self.tracer
        t_span = tr.begin() if tr else 0.0
        t0 = self.clock()
        tokens = torch.from_numpy(self._last_tok[:, None]).to(self.device)
        pos = torch.from_numpy(self._pos).to(self.device)
        t_d = tr.now() if tr else 0.0
        logits = transformer.decode_step_slots(
            self.params, self.cfg, self.cache, tokens, pos,
            fused=self.ecfg.fused_attn)
        toks = self._sample(logits[:, -1])
        t_w = tr.now() if tr else 0.0
        toks = toks.cpu().numpy()
        self.n_decode_steps += 1
        dt = self.clock() - t0
        self.decode_step_s.append(dt)
        if self._mx:
            self._mx["decode_steps"].inc()
            self._mx["decode_s"].observe(dt)
        if tr:
            tr.span_end("decode", t_span, slots=n_active,
                        dispatch_s=t_w - t_d, wait_s=tr.now() - t_w)
        return toks

    def _decode_with_retry(self, active: list) \
            -> tuple[Optional[np.ndarray], list]:
        """Plain decode step with bounded retry on failure (§12).

        Failures: injected faults (``fault_spec``) and the always-on check
        that every sampled token is in the vocab — the host's detector of
        corrupted logits, attributable to a slot. A CUDA error is no
        :class:`StepFailure` and propagates: no path re-runs a step on a
        plain version or on the CPU.

        A failed attempt may already have written this step's K/V row of
        every decoding slot, so ALL active slots roll back to their
        pre-step positions (``rollback_slot``: kv_pos → -1, the primitive
        speculative decoding rolls rejected windows back with) and the
        step runs again, from the unchanged committed prefix: greedy
        decoding and the kernels give the same tokens and the same bytes.
        A slot whose token stays corrupt for ``max_retries + 1``
        consecutive attempts is quarantined — retired as "failed" and
        dropped from the batch — so one poison request never wedges the
        others. Unattributable failures (raised exceptions) share the
        attempt budget and fail the WHOLE batch when it runs out.

        Returns (tokens, surviving active slots); tokens is None when
        every slot was quarantined."""
        pos0 = self._pos.copy()
        attempt = 0
        while active:
            inj = self._faults
            kind = inj.draw_step() if inj else None
            try:
                if kind == "exception":
                    raise StepFailure("injected transient step exception")
                if kind == "slow":
                    inj.sleep()
                toks = self._dispatch_decode(len(active))
                if inj is not None:
                    toks = inj.corrupt_tokens(
                        toks, active,
                        {s: self.sched.slots[s].uid for s in active})
                bad = [s for s in active
                       if not 0 <= int(toks[s]) < self.cfg.vocab]
                if bad:
                    raise StepFailure(
                        f"out-of-vocab decode token(s): "
                        f"{[(s, int(toks[s])) for s in bad]}", slots=bad)
                self._fail_streak[active] = 0
                return toks, active
            except StepFailure as e:
                attempt += 1
                self.n_step_retries += 1
                if self._mx:
                    self._mx["retries"].inc()
                if self._detect is not None:
                    # attributable failures name their first victim's uid
                    # in the incident trigger
                    uid = (self.sched.slots[e.slots[0]].uid
                           if e.slots and self.sched.slots[e.slots[0]]
                           is not None else None)
                    self._detect.note("step_retry", reason=str(e), uid=uid)
                # undo any K/V the failed dispatch wrote: every active
                # slot back to its pre-step position
                for s in active:
                    rollback_slot(self.cache, s, int(pos0[s]))
                if e.slots:
                    for s in e.slots:
                        self._fail_streak[s] += 1
                        if self._fail_streak[s] > self.ecfg.max_retries:
                            print(f"[engine] quarantining slot {s} (uid "
                                  f"{self.sched.slots[s].uid}): corrupt "
                                  f"decode output {self._fail_streak[s]} "
                                  f"attempts running", file=sys.stderr)
                            self.n_quarantined += 1
                            if self._detect is not None:
                                self._detect.note(
                                    "quarantine",
                                    uid=self.sched.slots[s].uid,
                                    reason=f"slot {s}: corrupt output "
                                           f"{int(self._fail_streak[s])} "
                                           f"attempts running")
                            self._retire(s, "failed")
                            self._fail_streak[s] = 0
                            active = [a for a in active if a != s]
                elif attempt > self.ecfg.max_retries:
                    print(f"[engine] decode failed {attempt} attempts "
                          f"with no attributable slot — failing the "
                          f"whole batch: {e}", file=sys.stderr)
                    for s in list(active):
                        self._fail_streak[s] = 0
                        self.n_quarantined += 1
                        if self._detect is not None:
                            self._detect.note(
                                "quarantine",
                                uid=self.sched.slots[s].uid,
                                reason=f"slot {s}: whole-batch failure "
                                       f"after {attempt} attempts")
                        self._retire(s, "failed")
                    active = []
                if active and self.ecfg.retry_backoff_s > 0:
                    time.sleep(min(0.05, self.ecfg.retry_backoff_s
                                   * (2.0 ** (attempt - 1))))
        return None, []

    def _prefill_backlog(self) -> int:
        """Prompt chunks still to stream for mid-prefill slots: half of
        the ladder's pressure and the end-of-step backlog gauge."""
        if not self.ecfg.prefill_chunk:
            return 0
        backlog = 0
        for s in self.sched.prefill_slots():
            rem = len(self.sched.slots[s].prompt) \
                - int(self._prefill_prog[s])
            backlog += -(-rem // self.ecfg.prefill_chunk)
        return backlog

    def _commit(self, slot: int, t: int) -> bool:
        """Append one decoded token with the eos / budget / max_len rules
        (eos is never emitted); False once the slot has retired."""
        req = self.sched.slots[slot]
        if t == self.ecfg.eos_id:
            self._retire(slot, "eos")
            return False
        req.out.append(t)
        self._last_tok[slot] = t
        if len(req.out) >= req.max_new_tokens:
            self._retire(slot, "budget")
            return False
        if self._pos[slot] >= self.ecfg.max_len:
            self._retire(slot, "max_len")
            return False
        return True

    def _verify(self, toks, slot: int, pos_start: int, length: int):
        """One verify pass over a slot's window (tokens (1, Sq) on the
        device): (the rows' argmax on the host, the tracer's clock when
        the launches returned — 0.0 untraced). The host copy is the
        pass's device wait."""
        garg = verify_window(self.params, self.cfg, self.cache, toks, slot,
                             pos_start, length)
        t_w = self.tracer.now() if self.tracer else 0.0
        return garg.cpu().numpy(), t_w

    def _spec_step(self, active: list[int]) -> None:
        """One speculative decode step: the draft proposes up to spec_k
        greedy tokens per active slot in batched decode steps over its own
        cache, then the target scores each slot's window in one verify
        pass and commits the longest matching draft prefix plus its own
        correction token — 1 to spec_k+1 tokens per slot, exactly those
        plain greedy decoding would produce. Windows are per slot,
        w = max(1, min(spec_k+1, max_len - pos, remaining budget)), so a
        slot near its budget decodes one token through the verify path.
        The rejected rows are rolled back in both caches."""
        Sq = self.ecfg.spec_k + 1
        N = self.ecfg.n_slots
        pos0 = self._pos.copy()
        commit0 = self.n_spec_commit_tokens
        t0 = self.clock()
        w = np.zeros(N, np.int64)       # 0 parks the slot in the draft pass
        for s in active:
            req = self.sched.slots[s]
            rem = req.max_new_tokens - len(req.out)
            w[s] = max(1, min(Sq, self.ecfg.max_len - int(pos0[s]), rem))
        drafts = self._spec.draft(self._last_tok, pos0, w)      # (k, N)
        tr = self.tracer
        for s in active:
            uid = int(self.sched.slots[s].uid)
            ws = int(w[s])
            t_span = tr.begin() if tr else 0.0
            toks = np.zeros((1, Sq), np.int64)
            toks[0, 0] = self._last_tok[s]
            toks[0, 1:ws] = drafts[:ws - 1, s]
            t_d = tr.now() if tr else 0.0
            garg, t_w = self._verify(torch.from_numpy(toks).to(self.device),
                                     s, int(pos0[s]), ws)
            wait_s = (tr.now() - t_w) if tr else 0.0
            self.n_verify_calls += 1
            self.n_verify_tokens += ws
            a = accept_length(drafts[:, s], garg, ws)
            self.sched.note_spec(s, proposed=ws - 1, accepted=a)
            if tr:
                tr.span_end("verify", t_span, slot=s, uid=uid, tokens=ws,
                            accepted=a, dispatch_s=t_w - t_d, wait_s=wait_s)
            new_pos = int(pos0[s]) + a + 1
            if a + 1 < ws:                   # rejected rows to undo
                self.n_rollbacks += 1
                t_rb = tr.begin() if tr else 0.0
                rollback_slot(self.cache, s, new_pos)
                self._spec.rollback(s, new_pos)
                if tr:
                    tr.span_end("rollback", t_rb, slot=s, uid=uid,
                                accept_len=new_pos)
                    tr.event("rollback", uid=uid, slot=s,
                             accept_len=new_pos, rejected=ws - (a + 1))
            t_c = tr.begin() if tr else 0.0
            for t in garg[:a + 1]:
                self._pos[s] += 1
                if t != self.ecfg.eos_id:
                    self.n_spec_commit_tokens += 1
                if not self._commit(s, int(t)):
                    break
            if tr:
                tr.span_end("accept_commit", t_c, slot=s, uid=uid,
                            committed=a + 1)
        self.n_spec_steps += 1
        self.spec_step_s.append(self.clock() - t0)
        self.sched.note_step(len(active))
        if self._mx:
            self._mx["spec_steps"].inc()
            self._mx["tokens"].inc(self.n_spec_commit_tokens - commit0)
            if self.sched.accept_ewma is not None:
                self._mx["accept_ewma"].set(self.sched.accept_ewma)

    def step(self) -> list[EngineRequest]:
        """Injected crash, deadline sweep, degradation ladder, admission,
        chunk-budgeted prefill, one batched decode step (with retry), the
        traced KV sample, the end-of-step gauges, the journal's fsync, the
        periodic snapshot and the flight record with its detector sweep,
        in that order. Returns the requests that finished in this
        step."""
        if self._t_start is None:
            self._t_start = self.clock()
        t_step0 = self.clock()
        tr = self.tracer
        t_span = tr.begin() if tr else 0.0
        # --- injected process death (faults.crash_rate): drawn before
        # any step work; the journal's durability horizon is the step
        # boundary, so flush what arrived since the last fsync and die —
        # recovery then sees exactly the pre-step state
        if self._faults is not None and self._faults.draw_crash():
            if self.journal:
                self.journal.sync()
            self._faults.crash()
        n_done_before = len(self.sched.finished)
        n_decoding_before = len(self.sched.active_slots())
        # whichever wall list grows this step holds its decode / verify
        # pass (the flight record's coarse split)
        n_dec0, n_spec0 = len(self.decode_step_s), len(self.spec_step_s)
        if self._any_deadlines:
            self._enforce_deadlines()
        # --- degradation ladder: pressure = queue depth + prefill backlog
        # chunks, fed before admission
        defer = ()
        if self._ladder is not None:
            pressure = len(self.sched.queue) + self._prefill_backlog()
            rung = self._ladder.update(pressure)
            if rung != self._rung:
                if self._mx:
                    self._mx["degr_transitions"].inc()
                if tr:
                    tr.event("degrade", rung=rung, prev=self._rung,
                             pressure=pressure)
                self._rung = rung
            if self._mx:
                self._mx["rung"].set(rung)
            if rung >= 3:
                # shed queued load (batch class first) back down to the
                # rung-2 threshold
                self.sched.shed_queued_to(int(self._ladder.thresholds[1]))
            if rung >= 2:
                defer = ("batch",)
        prefill_tokens = 0
        for slot, req in self.sched.admit(defer=defer):
            if self.ecfg.prefill_chunk:
                self._admit_chunked(slot, req)
            else:
                prefill_tokens += self._admit_one(slot, req)
        if self.ecfg.prefill_chunk:
            prefill_tokens = self._prefill_work()
            # nobody is decoding ⇒ nobody can be stalled: keep prefilling
            # until a slot joins the decode batch
            while not self.sched.active_slots() and \
                    self.sched.prefill_slots():
                prefill_tokens += self._prefill_work()
        active = self.sched.active_slots()
        if active and self._spec is not None and self._rung < 1:
            self._spec_step(active)
        elif active:
            if self._spec is not None:
                # ladder rung >= 1: the spec engine through plain decode,
                # output-identical by the lossless accept rule
                self._spec.note_suspended()
            toks, active = self._decode_with_retry(active)
            t_c = tr.begin() if tr else 0.0
            emitted = 0
            for slot in active:
                self._pos[slot] += 1
                t = int(toks[slot])
                emitted += t != self.ecfg.eos_id      # eos is not emitted
                self._commit(slot, t)
            self.sched.note_step(len(active))
            if self._mx:
                self._mx["tokens"].inc(emitted)
            if tr:
                tr.span_end("accept_commit", t_c, slots=len(active))
        if tr and self.ecfg.trace_kv_every and self.cache.mode == "int8" \
                and len(self.step_s) % self.ecfg.trace_kv_every == 0:
            # periodic KV quality sample: a bounded copy of live cache
            # rows to the host — a traced-mode cost, span-attributed
            t_q = tr.begin()
            tr.counter("kv_quality", kv_quality_counters(self.cache))
            tr.span_end("kv_sample", t_q)
        self.step_s.append(self.clock() - t_step0)
        self.step_prefill_tokens.append(prefill_tokens)
        self.step_decode_slots.append(n_decoding_before)
        mx = self._mx
        if mx:
            # end-of-step queueing gauges: O(n_slots) host bookkeeping
            mx["steps"].inc()
            mx["step_s"].observe(self.step_s[-1])
            if prefill_tokens:
                mx["prefill_tokens"].inc(prefill_tokens)
            occupied = in_flight = 0
            for r in self.sched.slots:
                if r is not None:
                    occupied += 1
                    in_flight += max(0, r.max_new_tokens - len(r.out))
            mx["occupancy"].set(occupied / self.ecfg.n_slots)
            mx["decoding"].set(len(self.sched.active_slots()))
            mx["backlog"].set(self._prefill_backlog())
            mx["in_flight"].set(in_flight)
            if self.ecfg.metrics_kv_every and self.cache.mode == "int8" \
                    and len(self.step_s) % self.ecfg.metrics_kv_every == 0:
                self._sample_kv_gauges()
        if tr:
            tr.span_end("step", t_span, prefill_tokens=prefill_tokens,
                        decode_slots=n_decoding_before)
        # --- crash safety: the journal's fsync FIRST, then the periodic
        # snapshot, so a snapshot never holds state the journal has not
        # seen
        if self.journal is not None:
            self.journal.sync()
        if self.ecfg.snapshot_every and self.ecfg.snapshot_path \
                and len(self.step_s) % self.ecfg.snapshot_every == 0:
            self.snapshot()
        # --- flight record + anomaly sweep (§14): after the journal's
        # fsync, so a bundle's journal tail holds this step
        if self._flight is not None or self._detect is not None:
            self._record_step(n_dec0, n_spec0, n_decoding_before)
        return self.sched.finished[n_done_before:]

    def _sample_kv_gauges(self) -> None:
        """The ``metrics_kv_every`` pull: KV clip / occupancy gauges from
        live cache rows (a bounded copy to the host), and the worse side's
        clip fraction and outlier-span share stashed for the flight record
        and the ``kv_clip_spike`` detector (no second copy)."""
        mx = self._mx
        kc = kv_quality_counters(self.cache)
        clips = []
        for side in ("k", "v"):
            if kc.get(f"{side}_clip_frac") is not None:
                mx[f"kv_{side}_clip"].set(kc[f"{side}_clip_frac"])
                mx[f"kv_{side}_occ"].set(kc[f"{side}_occupancy"])
                clips.append(kc[f"{side}_clip_frac"])
        if clips:
            self._last_clip_frac = max(clips)
        spans = []
        for side in ("k", "v"):
            hist = kc.get(f"{side}_span_outlier_hist")
            if hist and sum(hist) > 0:
                # buckets past 4x the median chunk span — the OCS outlier
                # tail (quality.OUTLIER_LOG2_EDGES)
                spans.append(sum(hist[5:]) / sum(hist))
        if spans:
            self._last_span_frac = max(spans)

    def _record_step(self, n_dec0: int, n_spec0: int,
                     n_decoding_before: int) -> None:
        """One flight record of the step just ended (the JAX package's
        fields), swept by the detectors when an incident_dir is armed."""
        uids = self.sched.occupied_uids()
        spec_on = self._spec is not None and self._rung < 1
        rec = {
            "step": len(self.step_s) - 1,
            "step_s": round(self.step_s[-1], 6),
            "decode_s": round(
                self.decode_step_s[-1]
                if len(self.decode_step_s) > n_dec0 else
                (self.spec_step_s[-1]
                 if len(self.spec_step_s) > n_spec0 else 0.0), 6),
            "draft_s": round(self._spec.last_draft_s, 6) if spec_on else 0.0,
            "queue": len(self.sched.queue),
            "backlog": self._prefill_backlog(),
            "occupied": len(uids),
            "decoding": n_decoding_before,
            "rung": self._rung,
            "retries": self.n_step_retries,
            "quarantined": self.n_quarantined,
            "accept": (round(self.sched.accept_ewma, 4)
                       if self._spec is not None
                       and self.sched.accept_ewma is not None else None),
            "spec_off": bool(self._spec is not None and self._rung >= 1),
            "clip_frac": self._last_clip_frac,
            "span_frac": self._last_span_frac,
            "uids": [int(u) for u in uids],
        }
        if self._flight is not None:
            rec = self._flight.record(**rec)
        if self._detect is not None:
            firings = self._detect.sweep(rec)
            if firings:
                self._capture_incident(firings)

    # -------------------------------------------- incident capture (§14) --
    def _capture_incident(self, firings, force: bool = False):
        """Write one incident bundle for a batch of detector firings, the
        first firing its named trigger. A global cooldown
        (``incident_cooldown`` steps) gates bundles, so a fault storm
        yields one incident, not one per step; ``force`` bypasses it
        (explicit dumps: supervisor restart, IntegrityError). Returns the
        bundle's path, or None."""
        if not self.ecfg.incident_dir or not firings:
            return None
        step = len(self.step_s)
        if not force and self._last_bundle_step is not None \
                and step - self._last_bundle_step \
                < self.ecfg.incident_cooldown:
            return None
        from ..obs.flight import tail_lines, write_incident_bundle
        from ..obs.provenance import provenance
        from .recovery import _engine_fingerprint, _req_doc
        trigger = firings[0]
        docs: dict = {
            "trigger.json": {
                "schema": 1, "step": step,
                "trigger": trigger.to_dict(),
                "firings": [f.to_dict() for f in firings],
                "faults_injected": (self._faults.counts()
                                    if self._faults is not None else None),
            },
            "flight.json": {
                "header": (self._flight.header()
                           if self._flight is not None else None),
                "records": (self._flight.window()
                            if self._flight is not None else []),
            },
            "metrics.json": (self.registry.snapshot()
                             if self.registry is not None else None),
            "fingerprint.json": _engine_fingerprint(self),
            "provenance.json": provenance(),
            "requests.json": {
                "active": [dict(_req_doc(r), slot=s)
                           for s, r in enumerate(self.sched.slots)
                           if r is not None],
                "queued": [_req_doc(r) for r in self.sched.queue],
                "poison_uids": (sorted(int(u) for u in
                                       self._faults.poison_uids)
                                if self._faults is not None else []),
            },
        }
        if self.ecfg.journal_path:
            if self.journal is not None:
                self.journal.sync()
            docs["journal_tail.jsonl"] = tail_lines(
                self.ecfg.journal_path, 200)
        # the sequence number comes from what is on disk, not from this
        # object: a supervised restart replaces the engine, the bundles
        # persist, and an overwritten bundle would eat an incident
        try:
            seq = len([d for d in os.listdir(self.ecfg.incident_dir)
                       if d.startswith("incident-")
                       and not d.endswith(".tmp")])
        except OSError:
            seq = 0
        name = f"incident-{seq:03d}-{trigger.detector}"
        path = write_incident_bundle(self.ecfg.incident_dir, name, docs)
        self.incidents.append(path)
        self._last_bundle_step = step
        print(f"[engine] incident bundle: {path} "
              f"(trigger {trigger.detector}: {trigger.reason})",
              file=sys.stderr)
        return path

    def dump_incident(self, detector: str, reason: str = "",
                      uid: Optional[int] = None):
        """Capture an incident bundle now (bypasses the cooldown): the
        serve supervisor after an ``InjectedCrash`` and the restore path
        on ``IntegrityError`` — anomalies outside the step loop, where no
        sweep runs. Returns the bundle's path (None without an
        incident_dir)."""
        from ..obs.detect import Firing
        return self._capture_incident(
            [Firing(detector, len(self.step_s), reason, uid=uid)],
            force=True)

    # ------------------------------------------------- crash safety ------
    def snapshot(self, path: Optional[str] = None) -> str:
        """Write the full serving state (quantized slot cache, draft
        twin, scheduler queue + slot table, host decode state, sampler
        state) to ``path`` atomically (engine/recovery.py)."""
        from .recovery import snapshot_engine
        path = path if path is not None else self.ecfg.snapshot_path
        if not path:
            raise ValueError("snapshot needs a path (argument or "
                             "EngineConfig.snapshot_path)")
        out = snapshot_engine(self, path)
        if self._mx:
            self._mx["snapshots"].inc()
        if self.journal:
            self.journal.event("snapshot", step=len(self.step_s))
        return out

    def restore(self, path: str) -> dict:
        """Restore serving state from a snapshot into this (freshly
        constructed, idle) engine. Integrity-validated — checksums, code
        ranges, kv_pos invariants, geometry — raising ``IntegrityError``
        rather than serve a corrupt artifact. Returns the manifest."""
        from .recovery import IntegrityError, restore_engine
        t0 = self.clock()
        try:
            manifest = restore_engine(self, path)
        except IntegrityError as e:
            # capture the refused artifact's context before failing loud
            self.dump_incident("integrity_error", reason=str(e))
            raise
        if self._mx:
            self._mx["restores"].inc()
            self._mx["restore_s"].observe(self.clock() - t0)
        return manifest

    def recover(self, snapshot_path: Optional[str] = None,
                journal_path: Optional[str] = None) -> dict:
        """Snapshot restore + journal replay (recovery.recover_engine):
        resume what the snapshot holds, re-enqueue journal submissions
        past its horizon, evict what the journal proves already retired.
        Either source may be absent (journal-only recovery re-prefills
        everything). Returns recover_engine's summary dict."""
        from .recovery import IntegrityError, recover_engine
        t0 = self.clock()
        try:
            info = recover_engine(
                self,
                snapshot_path if snapshot_path is not None
                else self.ecfg.snapshot_path,
                journal_path if journal_path is not None
                else self.ecfg.journal_path)
        except IntegrityError as e:
            self.dump_incident("integrity_error", reason=str(e))
            raise
        if self._mx:
            if info["manifest"] is not None:
                self._mx["restores"].inc()
            self._mx["replayed"].inc(info["n_restored"]
                                     + info["n_requeued"])
            self._mx["restore_s"].observe(self.clock() - t0)
        return info

    def drain(self, timeout_s: Optional[float] = None,
              stall_steps: int = 10_000) -> list[EngineRequest]:
        """Run until queue and slots are empty; returns every finished
        request in uid order.

        Watchdog (§12): bounded by wall clock (``timeout_s``, None =
        unbounded) and by ``stall_steps`` consecutive steps in which
        nothing moved (no finish, no admission, no token, no prefill
        progress). Tripping either force-fails every outstanding request
        ("failed") with a loud log instead of hanging the caller."""
        t0 = self.clock()
        stalled = 0
        sig = None
        while not self.sched.idle:
            self.step()
            cur = (len(self.sched.finished), self.sched.n_admitted,
                   sum(len(r.out) for r in self.sched.slots
                       if r is not None),
                   int(self._prefill_prog.sum()))
            if cur == sig:
                stalled += 1
            else:
                stalled = 0
                sig = cur
            if stalled >= stall_steps:
                self._force_fail_outstanding(
                    f"no progress across {stalled} consecutive steps")
                break
            if timeout_s is not None and self.clock() - t0 > timeout_s:
                self._force_fail_outstanding(
                    f"drain exceeded timeout_s={timeout_s}")
                break
        self.sweep_idle_rows()
        return sorted(self.sched.finished, key=lambda r: r.uid)

    def sweep_idle_rows(self) -> None:
        """Clear the ride-along position marks idle slots accumulate: an
        idle slot of the fixed-shape decode batch re-marks its own row 0
        each step, so after a drain's last decode step the slots that
        retired before it still carry one. Restores the "drained engine ⇒
        empty slot pool" invariant ``kvcache.occupied_slots`` checks
        (target and draft caches). Once a drain, not hot path."""
        for s, r in enumerate(self.sched.slots):
            if r is None:
                clear_slot(self.cache, s)
                if self._spec is not None:
                    self._spec.clear(s)

    def _force_fail_outstanding(self, why: str) -> None:
        """Watchdog action: fail every queued and slotted request, so the
        drain ends with every request retired exactly once."""
        n_q = len(self.sched.queue)
        n_s = sum(r is not None for r in self.sched.slots)
        print(f"[engine] drain watchdog tripped ({why}): force-failing "
              f"{n_q} queued + {n_s} slotted request(s)", file=sys.stderr)
        for slot, req in enumerate(self.sched.slots):
            if req is not None:
                self._retire(slot, "failed")
        while self.sched.queue:
            self.sched.drop_queued(self.sched.queue[0], "failed")

    # ----------------------------------------------------------- metrics --
    def metrics(self) -> dict:
        """The run's summary: throughput, latencies, queueing signals, the
        retire-reason partition and the fault-tolerance counters, the
        flight recorder's and detectors' counts, the speculative counts,
        the injected faults, the registry's snapshot and, traced, the
        phase attribution."""
        from ..obs.report import phase_breakdown
        from ..obs.summary import mean, pct as p
        fin = self.sched.finished
        reasons: dict = {}
        for r in fin:
            reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
        ttfts = [r.ttft for r in fin if r.ttft is not None]
        tps = [r.tokens_per_s for r in fin if r.tokens_per_s is not None]
        total_tokens = sum(len(r.out) for r in fin)
        wall = (self.clock() - self._t_start) if self._t_start else 0.0
        steps = np.asarray(self.decode_step_s, np.float64)
        full = np.asarray(self.step_s, np.float64)
        pmask = (np.asarray(self.step_prefill_tokens, np.int64) > 0) \
            & (np.asarray(self.step_decode_slots, np.int64) > 0)
        withp = full[pmask[:full.size]] if full.size else full
        spec = {}
        if self.ecfg.spec_k:
            hist = np.bincount(np.asarray(self.sched.accept_hist,
                                          np.int64),
                               minlength=self.ecfg.spec_k + 1) \
                if self.sched.accept_hist else np.zeros(0, np.int64)
            sstep = np.asarray(self.spec_step_s, np.float64)
            spec = {
                "spec_k": self.ecfg.spec_k,
                "spec_steps": self.n_spec_steps,
                "verify_calls": self.n_verify_calls,
                "verify_tokens": self.n_verify_tokens,
                "draft_steps": self._spec.n_draft_steps,
                "draft_proposed": self.sched.spec_proposed,
                "draft_accepted": self.sched.spec_accepted,
                "acceptance_rate": self.sched.acceptance_rate(),
                "accept_hist": hist.tolist(),
                "tokens_per_verify_mean": (
                    self.n_spec_commit_tokens / self.n_verify_calls
                    if self.n_verify_calls else None),
                "spec_step_p50_s": p(sstep, 50),
                "spec_step_p95_s": p(sstep, 95),
                "spec_by_slot": [list(x) for x in self.sched.spec_by_slot],
                "acceptance_ewma": self.sched.accept_ewma,
                "spec_suspended_steps": self._spec.n_suspended_steps,
            }
        out = {
            "n_finished": len(fin),
            "total_tokens": total_tokens,
            "wall_s": wall,
            "tokens_per_s": total_tokens / wall if wall > 0 else None,
            "decode_steps": self.n_decode_steps,
            "prefills": self.n_prefills,
            "prefill_chunks": self.n_prefill_chunks,
            "prefill_chunk": self.ecfg.prefill_chunk,
            "slot_utilization": self.sched.utilization(),
            "queue_depth_max": max(self.sched.queue_depth_hist, default=0),
            "queue_depth_at_submit_p50": p(self.sched.queue_depth_submit,
                                           50),
            "queue_depth_at_submit_p95": p(self.sched.queue_depth_submit,
                                           95),
            "admit_latency_mean_s": mean(self.sched.admit_latency_s),
            "admit_latency_p50_s": p(self.sched.admit_latency_s, 50),
            "admit_latency_p95_s": p(self.sched.admit_latency_s, 95),
            "ttft_mean_s": mean(ttfts),
            "ttft_p50_s": p(ttfts, 50),
            "ttft_p95_s": p(ttfts, 95),
            "request_tokens_per_s_mean": mean(tps),
            "decode_step_p50_s": p(steps, 50),
            "decode_step_p95_s": p(steps, 95),
            "decode_step_mean_s": mean(steps),
            "step_p50_s": p(full, 50),
            "step_p95_s": p(full, 95),
            "step_with_prefill_p95_s": p(withp, 95),
            "steps_with_prefill": int(pmask.sum()),
            "fused_attn": self.ecfg.fused_attn,
            "kv_mode": self.cache.mode,
            "kv_static_scales": self.cache.static,
            "kv_bytes_per_token": self.cache.bytes_per_token(),
            # the retire-reason partition (every finished request counted
            # exactly once) and the fault-tolerance counters
            "retire_reasons": reasons,
            "requests_shed": self.sched.n_shed,
            "requests_cancelled": self.sched.n_cancelled,
            "step_retries": self.n_step_retries,
            "quarantined": self.n_quarantined,
            "degradation_rung": self._rung,
            "degradation_transitions": (self._ladder.n_transitions
                                        if self._ladder else 0),
            # flight recorder + incident capture (§14)
            "flight_recorded": (self._flight.n_recorded
                                if self._flight is not None else 0),
            "incidents": list(self.incidents),
            "anomalies_fired": (self._detect.n_fired
                                if self._detect is not None else 0),
            **spec,
        }
        if self._faults is not None:
            out["faults_injected"] = self._faults.counts()
        if self.registry is not None:
            out["registry"] = self.registry.snapshot()
        if self.tracer:
            # a traced engine embeds its step-time breakdown, so a metrics
            # consumer needs no second pass over the trace
            out["phase_attribution"] = phase_breakdown(self.tracer.events)
            out["trace_records"] = len(self.tracer.events)
            out["trace_dropped"] = self.tracer.dropped
        return out
