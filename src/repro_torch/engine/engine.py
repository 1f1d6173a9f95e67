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
(fp32 or bf16). ``fused_attn=False`` decodes through the materialize read
path (each layer's cache copied to full precision and attended in plain
PyTorch), the JAX package's oracle. Torch cannot reproduce
``jax.random.categorical``: temperature sampling draws other tokens than
the JAX engine from the same distribution. A speculative engine takes its
draft as ``draft_params=`` or mints it from a calibration recipe
(``draft_recipe``, :func:`~repro_torch.engine.spec.load_draft_params`).
Not ported yet: faults and retry, journal and snapshots, metrics and
tracing, the flight recorder, deadlines and cancel, overload shedding and
degradation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import transformer
from ..models.common import dtype_of
from .kvcache import (clear_slot, hotswap_static_scales, init_slot_cache,
                      rollback_slot, write_prefill)
from .scheduler import EngineRequest, Scheduler, SubmitError
from .spec import (SpecDecoder, accept_length, load_draft_params,
                   verify_argmax)

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
    kv_dtype: str = "float32"           # fp-mode storage: float32 | bfloat16
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
    by default one seeded 0.
    """

    def __init__(self, cfg, params, ecfg: EngineConfig, device=None,
                 clock=time.perf_counter, *, kv_scales=None,
                 draft_params=None, generator=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the port's engine serves dense decoders, got "
                f"{cfg.family!r}"
                + (" — and spec_k > 0 additionally needs positional KV "
                   "rollback, which recurrent state cannot provide"
                   if ecfg.spec_k else ""))
        if ecfg.spec_k and ecfg.temperature > 0:
            raise NotImplementedError(
                "spec_k > 0 requires greedy decoding (temperature <= "
                "0): the lossless accept rule compares argmax tokens; "
                "temperature sampling needs speculative rejection "
                "sampling, which is not wired up")
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
        self.sched = Scheduler(ecfg.n_slots, clock=clock)
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
            self._spec = SpecDecoder(cfg, ecfg, draft_params, self.device)
        N = ecfg.n_slots
        self._last_tok = np.zeros(N, np.int64)
        self._pos = np.zeros(N, np.int64)
        self._prefill_prog = np.zeros(N, np.int64)
        self._uid = 0
        self.n_decode_steps = 0
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

    def load_kv_scales(self, kv_scales: dict) -> None:
        """Hot-swap a recipe's static KV scales into the live dynamic int8
        cache without draining slots: the codes are requantized once, and
        every later write skips the min/max reduce and the scale arrays.
        (The draft's twin cache keeps its dynamic scales.)"""
        self.cache = hotswap_static_scales(self.cache, kv_scales)

    # ------------------------------------------------------------ intake --
    def submit(self, prompt, max_new_tokens: Optional[int] = None) -> int:
        """Enqueue a request; returns its uid. Work happens in step()."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) == 0:
            raise SubmitError("empty_prompt",
                              "empty prompt (no tokens to prefill)")
        budget = (self.ecfg.max_new_tokens if max_new_tokens is None
                  else max_new_tokens)
        if budget < 0:
            raise SubmitError("bad_budget",
                              f"max_new_tokens must be >= 0, got {budget}")
        if len(prompt) + budget > self.ecfg.max_len:
            raise SubmitError(
                "too_long", f"prompt ({len(prompt)}) + max_new_tokens "
                            f"({budget}) exceeds max_len {self.ecfg.max_len}")
        req = EngineRequest(uid=self._uid, prompt=prompt,
                            max_new_tokens=budget)
        self._uid += 1
        self.sched.submit(req)
        return req.uid

    # ----------------------------------------------------------- serving --
    def _retire(self, slot: int, reason: str) -> None:
        """Free the slot everywhere: scheduler, cache rows, host state."""
        self.sched.retire(slot, reason=reason)
        clear_slot(self.cache, slot)
        if self._spec is not None:
            self._spec.clear(slot)
        self._pos[slot] = 0
        self._last_tok[slot] = 0

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
        if first == self.ecfg.eos_id:
            self._retire(slot, "eos")
            return
        req.out.append(first)
        self._last_tok[slot] = first
        self._pos[slot] = S
        if len(req.out) >= req.max_new_tokens:
            self._retire(slot, "budget")
        elif S >= self.ecfg.max_len:
            self._retire(slot, "max_len")

    def _admit_one(self, slot: int, req: EngineRequest) -> None:
        """One-shot admission (``prefill_chunk=0``): a dense prefill of
        the prompt right-padded to its bucket (the full-precision
        (L, S, Hkv, D) materialization), written into the slot by
        ``write_prefill``, then the first token from the logits row of
        the prompt's last token."""
        global FP_PREFILL_MATERIALIZATIONS
        if req.max_new_tokens <= 0:
            req.t_first_token = req.t_submit
            self.sched.retire(slot, reason="zero_budget")
            return
        t0 = self.clock()
        S = len(req.prompt)
        Sp = bucket_len(S, self.ecfg.prefill_bucket, self.ecfg.max_len)
        toks = np.zeros((1, Sp), np.int64)
        toks[0, :S] = req.prompt                      # right-pad
        toks = torch.from_numpy(toks).to(self.device)
        logits, pcache = transformer.prefill(self.params, self.cfg,
                                             {"tokens": toks})
        self.n_prefills += 1
        FP_PREFILL_MATERIALIZATIONS += 1
        # only [0, S) becomes visible; the bucket's padding stays masked
        write_prefill(self.cache, slot, pcache, S)
        del pcache
        if self._spec is not None:    # the draft's own materialization
            self._spec.prefill_oneshot(toks, slot, S)
            FP_PREFILL_MATERIALIZATIONS += 1
        self._start_decoding(slot, req, logits[0, S - 1], S)
        self.prefill_s.append(self.clock() - t0)

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
        for slot in self.sched.prefill_slots():
            req = self.sched.slots[slot]
            S = len(req.prompt)
            done = int(self._prefill_prog[slot])
            n = min(ecfg.prefill_chunk, S - done)
            if n > budget:
                break
            Sc = bucket_len(n, ecfg.prefill_bucket, ecfg.prefill_chunk)
            toks = np.zeros((1, Sc), np.int64)
            toks[0, :n] = req.prompt[done:done + n]   # right-pad the chunk
            t0 = self.clock()
            toks = torch.from_numpy(toks).to(self.device)
            logits = transformer.prefill_chunk_slots(
                self.params, self.cfg, self.cache, toks, slot, done, n)
            if self._spec is not None:        # mirror the chunk to the draft
                self._spec.prefill_chunk(toks, slot, done, n)
            budget -= n
            spent += n
            done += n
            self._prefill_prog[slot] = done
            self._pos[slot] = done                    # parked position
            self.n_prefill_chunks += 1
            if done >= S:                             # prompt complete
                self.sched.finish_prefill(slot)
                self._start_decoding(slot, req, logits[0], S)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)   # the chunk's device time
            self.prefill_chunk_s.append(self.clock() - t0)
        return spent

    def _decode(self) -> np.ndarray:
        """One batched decode step over all N slots, sampled on the
        device; returns the per-slot tokens on the host (one (N,)
        copy)."""
        t0 = self.clock()
        tokens = torch.from_numpy(self._last_tok[:, None]).to(self.device)
        pos = torch.from_numpy(self._pos).to(self.device)
        logits = transformer.decode_step_slots(
            self.params, self.cfg, self.cache, tokens, pos,
            fused=self.ecfg.fused_attn)
        toks = self._sample(logits[:, -1]).cpu().numpy()
        self.n_decode_steps += 1
        self.decode_step_s.append(self.clock() - t0)
        return toks

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
        t0 = self.clock()
        w = np.zeros(N, np.int64)       # 0 parks the slot in the draft pass
        for s in active:
            req = self.sched.slots[s]
            rem = req.max_new_tokens - len(req.out)
            w[s] = max(1, min(Sq, self.ecfg.max_len - int(pos0[s]), rem))
        drafts = self._spec.draft(self._last_tok, pos0, w)      # (k, N)
        for s in active:
            ws = int(w[s])
            toks = np.zeros((1, Sq), np.int64)
            toks[0, 0] = self._last_tok[s]
            toks[0, 1:ws] = drafts[:ws - 1, s]
            garg = verify_argmax(self.params, self.cfg, self.cache,
                                 torch.from_numpy(toks).to(self.device), s,
                                 int(pos0[s]), ws)
            self.n_verify_calls += 1
            self.n_verify_tokens += ws
            a = accept_length(drafts[:, s], garg, ws)
            self.sched.note_spec(s, proposed=ws - 1, accepted=a)
            new_pos = int(pos0[s]) + a + 1
            if a + 1 < ws:                   # rejected rows to undo
                self.n_rollbacks += 1
                rollback_slot(self.cache, s, new_pos)
                self._spec.rollback(s, new_pos)
            for t in garg[:a + 1]:
                self._pos[s] += 1
                if t != self.ecfg.eos_id:
                    self.n_spec_commit_tokens += 1
                if not self._commit(s, int(t)):
                    break
        self.n_spec_steps += 1
        self.spec_step_s.append(self.clock() - t0)

    def step(self) -> list[EngineRequest]:
        """Admit + chunk-budgeted prefill + one batched decode step.
        Returns the requests that finished in this step."""
        n_done_before = len(self.sched.finished)
        for slot, req in self.sched.admit():
            if self.ecfg.prefill_chunk:
                self._admit_chunked(slot, req)
            else:
                self._admit_one(slot, req)
        if self.ecfg.prefill_chunk:
            self._prefill_work()
            # nobody is decoding ⇒ nobody can be stalled: keep prefilling
            # until a slot joins the decode batch
            while not self.sched.active_slots() and \
                    self.sched.prefill_slots():
                self._prefill_work()
        active = self.sched.active_slots()
        if active and self._spec is not None:
            self._spec_step(active)
        elif active:
            toks = self._decode()
            for slot in active:
                self._pos[slot] += 1
                self._commit(slot, int(toks[slot]))
        return self.sched.finished[n_done_before:]

    def drain(self) -> list[EngineRequest]:
        """Run until queue and slots are empty; returns every finished
        request in uid order."""
        while not self.sched.idle:
            self.step()
        return sorted(self.sched.finished, key=lambda r: r.uid)
