"""Self-speculative decoding (port of ``repro.engine.spec``): a low-bit
SplitQuant DRAFT of the served weights proposes up to ``spec_k`` greedy
tokens per slot, and the TARGET scores each slot's whole window in one
verify pass (``transformer.verify_step_slots``: a prefill chunk whose
rows attend the window through the cache's storage round trip).

Accept rule (greedy, lossless): the window [last committed token, d_1 ..
d_{w-1}] is fed at positions [pos, pos + w); verify row j's argmax
g_{j+1} is the target's greedy token after window token j. With a the
longest prefix where d_i == g_i, the engine commits g_1 .. g_{a+1}, so
every committed token is the target's argmax given the committed prefix
and the output is token-identical to plain greedy decoding. The rejected
rows of both caches are undone by ``kvcache.rollback_slot``.

The draft comes in as ``draft_params=`` or from a calibration recipe
(:func:`load_draft_params`). Its instruments live in the engine's metrics
registry, under the JAX package's names, and a traced engine gets one
``draft`` span a step from it, with its dispatch / device-wait split.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.apply import dequantize_tree
from ..models import transformer
from ..models.common import dtype_of
from .kvcache import clear_slot, init_slot_cache, rollback_slot, \
    write_prefill


def load_draft_params(recipe_dir: str, params, cfg):
    """Mint the draft weight tree from a saved QuantRecipe: restore the
    pre-quantized checkpoint if the recipe ships one (no k-means at engine
    start; on the device of ``params``), else apply the recipe's per-path
    mixed-precision policies to the target's own ``params``, which must
    then be dense. The draft is the SAME model, just low-bit."""
    from ..calib.recipe import QuantRecipe
    from ..checkpoint import ckpt
    from ..core.apply import QuantPolicy, quantize_tree

    rec = QuantRecipe.load(recipe_dir)
    if rec.arch and rec.arch != cfg.name:
        raise ValueError(
            f"draft recipe {recipe_dir!r} was calibrated for arch "
            f"{rec.arch!r}, serving {cfg.name!r} — a mismatched draft "
            f"would propose garbage and pay full verify cost for it")
    ck = rec.resolve_ckpt_dir(recipe_dir)
    if ck is not None:
        draft, _ = ckpt.restore(ck, params)
        return draft
    if rec.policies:
        draft, _ = quantize_tree(params, QuantPolicy(), seed=0,
                                 overrides=rec.policies)
        return draft
    raise ValueError(
        f"draft recipe {recipe_dir!r} carries neither a pre-quantized "
        f"checkpoint nor quantization policies — nothing to draft with")


def accept_length(drafts, target_toks, window: int) -> int:
    """Longest accepted draft prefix: a = max n such that drafts[i] ==
    target_toks[i] for all i < n. ``drafts`` are d_1..d_{window-1};
    ``target_toks`` the verify rows' argmax g_1..g_window. Returns a in
    [0, window-1]; the engine then commits target_toks[:a+1]."""
    a = 0
    while a < window - 1 and int(drafts[a]) == int(target_toks[a]):
        a += 1
    return a


def verify_window(params, cfg, cache, tokens, slot: int, pos_start: int,
                  length: int) -> torch.Tensor:
    """One verify pass over a slot's window (tokens (1, Sq) on the
    device; the cache updated in place) with the greedy argmax of every
    row taken on the device: the (Sq,) argmax tensor, still on the
    device (the launches are asynchronous on the card)."""
    logits = transformer.verify_step_slots(params, cfg, cache, tokens, slot,
                                           pos_start, length)
    return torch.argmax(logits[0], dim=-1)


def verify_argmax(params, cfg, cache, tokens, slot: int, pos_start: int,
                  length: int) -> np.ndarray:
    """:func:`verify_window` with its (Sq,) argmax copied to the host."""
    return verify_window(params, cfg, cache, tokens, slot, pos_start,
                         length).cpu().numpy()


class SpecDecoder:
    """Draft side of the speculative engine: the draft weights and the
    draft's twin slot cache (the target's geometry, its own arrays), which
    mirrors every cache event of the target — prefill chunks, retire,
    rollback — so the draft's view of each slot tracks the committed
    sequence.

    The draft cache always takes dynamic scales, even when the target
    serves static ones: the recipe was calibrated on the target's
    activations, and a mis-scaled draft cache could only cost acceptance,
    never correctness (the accept rule guards that). The twin cache is
    serving state: an engine snapshot persists it beside the target's.

    ``registry``: the engine's metrics registry (None: no instruments);
    ``tracer``: the engine's ``obs.Tracer`` (falsy: none), which gets one
    aggregated ``draft`` span per engine step."""

    def __init__(self, cfg, ecfg, draft_params, device, registry=None,
                 tracer=None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.k = ecfg.spec_k
        self.device = device
        self.tracer = tracer if tracer else None
        self._mx = None
        if registry is not None:
            self._mx = {
                "steps": registry.counter(
                    "spec_draft_steps", "batched draft decode dispatches"),
                "draft_s": registry.histogram(
                    "spec_draft_pass_seconds",
                    "whole per-engine-step draft pass (all iterations)"),
                "suspended": registry.counter(
                    "spec_suspended_steps",
                    "decode steps where the degradation ladder routed a "
                    "spec-enabled engine through plain decode"),
            }
        if ecfg.draft_dequantize:
            # once, at start: the low-bit weights buy the draft's
            # faithfulness and storage, and a packed draft would unpack
            # every matrix again in each of its decode steps
            draft_params = dequantize_tree(draft_params)
        self.params = draft_params
        self.cache = init_slot_cache(cfg, ecfg.n_slots, ecfg.max_len,
                                     mode=ecfg.kv_mode,
                                     dtype=dtype_of(ecfg.kv_dtype),
                                     qchunks=ecfg.kv_qchunks, device=device)
        self.n_draft_steps = 0
        self.n_suspended_steps = 0
        self.last_draft_s = 0.0         # wall of the latest draft pass

    def note_suspended(self) -> None:
        """Record one plain-decode step taken while speculation is
        suspended (degradation-ladder rung >= 1). Its tokens never reach
        the draft cache, so the slot's draft rows grow position holes;
        holes are masked out of draft attention, which can only cost
        acceptance — the verify pass stays authoritative, so resuming
        speculation stays token-identical."""
        self.n_suspended_steps += 1
        if self._mx is not None:
            self._mx["suspended"].inc()

    # ------------------------------------------------- slot lifecycle ----
    def prefill_oneshot(self, toks, slot: int, length: int) -> None:
        """Mirror a one-shot admission (tokens (1, S) on the device): the
        draft's own dense prefill, written into its cache by
        ``write_prefill``."""
        _, pcache = transformer.prefill(self.params, self.cfg,
                                        {"tokens": toks})
        write_prefill(self.cache, slot, pcache, length)

    def prefill_chunk(self, toks, slot: int, pos_start: int,
                      length: int) -> None:
        """Mirror one prefill chunk (tokens (1, Sc) on the device)."""
        transformer.prefill_chunk_slots(self.params, self.cfg, self.cache,
                                        toks, slot, pos_start, length)

    def clear(self, slot: int) -> None:
        clear_slot(self.cache, slot)

    def rollback(self, slot: int, accept_len: int) -> None:
        """Drop the draft rows of rejected tokens, as on the target."""
        rollback_slot(self.cache, slot, accept_len)

    # ------------------------------------------------------- drafting ----
    def draft(self, last_tok, pos, steps) -> np.ndarray:
        """Propose up to k greedy tokens per slot in batched decode steps
        over the draft cache.

        last_tok / pos: (N,) host arrays of the engine's committed state;
        steps: (N,) per-slot window lengths w (0 for slots that are idle
        or mid-prefill). Iteration j feeds window token j at pos + j for
        every slot still inside its window, writing its draft-cache row;
        a slot past its window (and every inactive slot) parks: it feeds
        its current (token, position) again, so the only row it touches
        is one that the next chunk, admission or draft pass overwrites.
        Running max(steps) iterations (w - 1 drafts plus the row of the
        window's last token) keeps the draft cache free of holes on full
        acceptance.

        Returns drafts (k, N) int — drafts[j] is d_{j+1} per slot; rows
        at >= steps - 1 are garbage the caller never reads."""
        N = self.ecfg.n_slots
        cur_tok = np.asarray(last_tok, np.int64).copy()
        cur_pos = np.asarray(pos, np.int64).copy()
        steps = np.asarray(steps)
        drafts = np.zeros((self.k, N), np.int64)
        tr = self.tracer
        t_span = tr.begin() if tr else 0.0
        t_pass = time.perf_counter()
        dispatch_s = wait_s = 0.0
        n_iter = int(steps.max())
        for j in range(n_iter):
            if tr:
                t_d = tr.now()
            logits = transformer.decode_step_slots(
                self.params, self.cfg, self.cache,
                torch.from_numpy(cur_tok[:, None]).to(self.device),
                torch.from_numpy(cur_pos).to(self.device),
                fused=self.ecfg.fused_attn)
            toks = torch.argmax(logits[:, -1], dim=-1)
            if tr:
                dispatch_s += (t_w := tr.now()) - t_d
            toks = toks.cpu().numpy()           # the device wait
            if tr:
                wait_s += tr.now() - t_w
            self.n_draft_steps += 1
            if j < self.k:
                drafts[j] = toks
            adv = (j + 1) < steps
            cur_tok = np.where(adv, toks, cur_tok)
            cur_pos = np.where(adv, cur_pos + 1, cur_pos)
        self.last_draft_s = time.perf_counter() - t_pass
        if self._mx is not None:
            self._mx["steps"].inc(n_iter)
            self._mx["draft_s"].observe(self.last_draft_s)
        if tr:
            tr.span_end("draft", t_span, iters=n_iter,
                        dispatch_s=dispatch_s, wait_s=wait_s)
        return drafts
