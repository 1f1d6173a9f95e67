"""Batched wave serving loop for quantized models (port of
``repro.runtime.serve_loop``).

Requests are grouped into prefill waves of up to ``max_batch``; each
wave is left-padded with token 0 to its longest prompt, prefilled in one
forward, then decodes together until every member finishes: a finished
(or short) request's row stays in the batch until the wave's longest
generation completes. Sampling runs on the device (greedy argmax, or with
``temperature > 0`` a draw from softmax(logits / T) with the server's
``torch.Generator``), with one (B,) copy of the tokens to the host per
step for the eos/limit bookkeeping.

Dense, MoE and VLM models prefill into a ``KVCache`` of ``max_len`` rows with
a pad mask, so the pads' K/V are never attended to (their entries hold
position -1), and decode at the wave's shared position, as the JAX
``Server`` does. A MoE wave prefill routes the wave's B·S tokens, pads
included, as one block: above 512 tokens each expert's capacity is
``Tb·K·cf // E`` and the pairs past it drop, the same pairs as in JAX
(``models.ffn.apply_moe``); a decode step (B tokens) drops none. The
engine (:class:`repro_torch.engine.Engine`) is their default path, this
loop the baseline. RWKV6 and griffin fold the pads into their
recurrent states (their ``prefill`` takes no pad mask), as in the JAX
package; griffin's pads also enter its local attention's ring, and its
decode step takes the wave's position. Torch's generator cannot reproduce ``jax.random.categorical``:
at a temperature the tokens are other draws from the same distribution.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..engine.engine import sample_tokens
from ..models import get_model

#: families whose prefill takes ``max_len`` and a pad mask (per-request KV
#: validity) and whose decode step takes the wave's position (a VLM's
#: requests are text, as in the JAX ``Server``)
PAD_MASK_FAMILIES = ("dense", "moe", "vlm")
#: families whose decode step takes the wave's position: the above and
#: griffin (its ring row is ``pos % window``), which takes no pad mask
POS_FAMILIES = PAD_MASK_FAMILIES + ("hybrid",)


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_new_tokens: int = 32
    max_len: int = 256              # KV cache rows of a dense wave
    temperature: float = 0.0        # 0 ⇒ greedy
    eos_id: int = -1                # -1 ⇒ never stop early


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int
    max_new_tokens: Optional[int] = None   # None ⇒ ServeConfig budget
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Minimal wave-batching server on ``device`` (the card unless
    ``device="cpu"``). ``wave_prefill_s`` and ``decode_step_s`` record the
    host-clock time of each wave's prefill and each decode step, both
    ending in the tokens' copy to the host (which waits for the card).
    ``generator``: the ``torch.Generator`` temperature sampling draws
    from, on ``device`` (the JAX ``Server``'s ``rng=``); by default one
    seeded 0."""

    def __init__(self, cfg, params, serve_cfg: ServeConfig, device=None,
                 generator=None):
        self.cfg = cfg
        self.model = get_model(cfg)
        self.params = params
        self.scfg = serve_cfg
        self.device = resolve_device(device)
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(0))
        self.wave_prefill_s: list[float] = []
        self.decode_step_s: list[float] = []

    def _sample(self, logits):
        """The last position's token, on the device and as host ints:
        its argmax, or at a temperature a draw from softmax(logits / T)."""
        tok = sample_tokens(logits[:, -1], self.scfg.temperature,
                            self.generator)
        return tok, tok.tolist()

    def prefill_wave(self, prompts):
        """Left-pad ``prompts`` with token 0 to the longest, prefill them
        in one forward (dense: into a cache of ``max_len`` rows, the pads
        masked) and pick each row's first token → (state, tokens on the
        device, tokens as host ints). The wave decodes from position
        ``max(len(p) for p in prompts)``."""
        S = max(len(p) for p in prompts)
        toks = np.zeros((len(prompts), S), np.int64)
        pad = np.ones((len(prompts), S), bool)
        for j, p in enumerate(prompts):
            toks[j, S - len(p):] = p                       # left-pad
            pad[j, S - len(p):] = False
        kw = {}
        if self.cfg.family in PAD_MASK_FAMILIES:
            kw = dict(max_len=self.scfg.max_len,
                      pad_mask=torch.from_numpy(pad).to(self.device))
        logits, cache = self.model.prefill(
            self.params, self.cfg,
            {"tokens": torch.from_numpy(toks).to(self.device)}, **kw)
        return (cache, *self._sample(logits))

    def decode_wave(self, cache, tok_d, pos=None):
        """One step of the whole wave from its last tokens
        ``tok_d`` (B,) at position ``pos`` (a decoder's or griffin's;
        rwkv6 takes none) → (state, tokens on the device, host ints)."""
        args = (pos,) if self.cfg.family in POS_FAMILIES else ()
        logits, cache = self.model.decode_step(self.params, self.cfg, cache,
                                               tok_d[:, None], *args)
        return (cache, *self._sample(logits))

    def serve(self, requests: list[Request]) -> list[Request]:
        scfg = self.scfg
        for i in range(0, len(requests), scfg.max_batch):
            wave = requests[i:i + scfg.max_batch]
            t0 = time.perf_counter()
            cache, tok_d, tok = self.prefill_wave([r.prompt for r in wave])
            self.wave_prefill_s.append(time.perf_counter() - t0)
            limits = [scfg.max_new_tokens if r.max_new_tokens is None
                      else r.max_new_tokens for r in wave]
            for j, r in enumerate(wave):
                t = tok[j]
                # eos is never emitted, also on the prefill-sampled first
                # token (same semantics as the engine)
                if limits[j] <= 0 or t == scfg.eos_id:
                    r.done = True
                    continue
                r.out.append(t)
                if len(r.out) >= limits[j]:
                    r.done = True
            pos = max(len(r.prompt) for r in wave)
            for _ in range(max(limits + [1]) - 1):
                t0 = time.perf_counter()
                cache, tok_d, tok = self.decode_wave(cache, tok_d, pos)
                pos += 1
                self.decode_step_s.append(time.perf_counter() - t0)
                alive = False
                for j, r in enumerate(wave):
                    if r.done:
                        continue
                    t = tok[j]
                    if t == scfg.eos_id:
                        r.done = True
                        continue
                    r.out.append(t)
                    if len(r.out) >= limits[j]:
                        r.done = True
                    else:
                        alive = True
                if not alive:
                    break
            for r in wave:
                r.done = True
        return requests
