"""Decoder-only LM (port of ``repro.models.transformer`` for the dense,
MoE and VLM families): the forward over no cache, a plain ``KVCache``
(the wave loop's prefill and decode step) or the engine's slot cache
(its decode step, chunked prefill and speculative verify).

Parameters are plain nested dicts with the JAX package's names; each
layer stack is a Python list of per-layer dicts (the JAX ``(L, …)`` stack
and its ``lax.scan`` become a loop shared by every entry point). A MoE
model has two stacks, as in JAX: ``layers`` holds the ``first_k_dense``
dense layers (FFN width ``dense_d_ff``, or ``d_ff · top_k``) and
``moe_layers`` the rest, each with ``moe`` in place of ``ffn``; one cache
layer index runs across both (0 … n_layers - 1). The initializer is the
port's own, seeded by a ``torch.Generator``, at the same shapes; with
``on_part`` it hands each part of the tree to a hook as it is built (the
layer-by-layer quantized build of ``launch.serve.build_params``). The
MoE auxiliary loss (JAX's third output of ``forward``) is summed over
the layers for :func:`loss_fn`; the serving entry points drop it.
:func:`loss_fn` is the training loss: next-token cross-entropy (a VLM's
on its text tokens only) plus ``aux_weight`` times the aux loss, each
layer recomputed in the backward pass under ``remat``
(``torch.utils.checkpoint``, as JAX's ``jax.checkpoint``).

The VLM family (paligemma-3b) is the dense decoder with a stub vision
frontend: ``patch_proj`` (``VLM_PATCH_DIM`` x d_model) projects a
batch's ``patch_embeds`` (B, P, VLM_PATCH_DIM), which
:func:`embed_inputs` prepends to the token embeddings, positions
0 … P + S - 1. Its head is tied (``tie_embeddings``): no ``lm_head`` is
drawn and every entry point's logits are ``x @ embed.T`` (the table
dequantized first when ``quantize_embeddings`` packed it), a plain
product that the JAX package leaves to XLA outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .attention import KVCache, attention_block
from ..kernels.ops import PackedWeight
from .common import (apply_norm, dense, dtype_of, embed_init, embed_lookup,
                     he_init, init_norm, lm_loss)
from .ffn import apply_ffn, apply_moe, init_ffn, init_moe

#: SigLIP-so400m's embedding width (the VLM's stub frontend)
VLM_PATCH_DIM = 1152
#: the families this module builds
FAMILIES = ("dense", "moe", "vlm")


def _init_layer(gen, cfg, dtype, device, moe: bool = False, put=None):
    """One layer; ``put(names, part)`` takes each part as it is drawn (the
    attention, the two norms, the FFN, or each entry of the MoE) and
    returns what stands in its place."""
    d, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    put = put or (lambda names, part: part)
    p = {
        "attn": put(("attn",), {
            "wq": he_init(gen, (d, Hq * D), dtype, device),
            "wk": he_init(gen, (d, Hkv * D), dtype, device),
            "wv": he_init(gen, (d, Hkv * D), dtype, device),
            "wo": he_init(gen, (Hq * D, d), dtype, device, fan_in=Hq * D),
        }),
        "ln1": put(("ln1",), init_norm(d, cfg.norm_type, dtype, device)),
        "ln2": put(("ln2",), init_norm(d, cfg.norm_type, dtype, device)),
    }
    if moe:
        p["moe"] = init_moe(gen, cfg, dtype, device,
                            put=lambda name, part: put(("moe", name), part))
        return p
    ff = cfg.dense_d_ff or cfg.d_ff
    if cfg.n_experts and not cfg.dense_d_ff:
        ff = cfg.d_ff * max(cfg.top_k, 1)   # the dense prelude's width
    p["ffn"] = put(("ffn",), init_ffn(gen, d, ff, cfg.ffn_type, dtype,
                                      device, bias=cfg.bias))
    return p


def stack_depths(cfg) -> tuple[int, int]:
    """(dense layers, MoE layers) of ``cfg``."""
    n_moe = cfg.n_layers - cfg.first_k_dense if cfg.n_experts else 0
    return cfg.n_layers - n_moe, n_moe


def init(cfg, seed: int = 0, device=None, on_part=None):
    """Seeded random parameters at the config's shapes, on ``device``
    (the card unless ``device="cpu"``). ``on_part(path, part, stack)``,
    when given, is called on each part of the tree as soon as it is
    built, in the tree's order: each top-level entry (path ``(key,)``,
    stack 1) and each part of a layer of a stack as it is drawn (path
    ``(key, index, *names)``: the attention, the norms, the FFN, or each
    entry of the MoE — each expert stack on its own; stack the stack's
    depth); its return value takes the part's place."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"transformer builds the {', '.join(FAMILIES)} "
                         f"families, got {cfg.name!r}")
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    keep = on_part or (lambda path, part, stack: part)
    params = {"embed": keep(("embed",), embed_init(
                  gen, (cfg.vocab, cfg.d_model), dtype, device), 1),
              "final_norm": keep(("final_norm",), init_norm(
                  cfg.d_model, cfg.norm_type, dtype, device), 1)}
    for key, n, moe in zip(("layers", "moe_layers"), stack_depths(cfg),
                           (False, True)):
        if n:
            params[key] = [_init_layer(
                gen, cfg, dtype, device, moe,
                put=lambda names, part, key=key, i=i, n=n: keep(
                    (key, i, *names), part, n)) for i in range(n)]
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(("lm_head",), he_init(
            gen, (cfg.d_model, cfg.vocab), dtype, device), 1)
    if cfg.family == "vlm":
        params["patch_proj"] = keep(("patch_proj",), he_init(
            gen, (VLM_PATCH_DIM, cfg.d_model), dtype, device), 1)
    return params


def _layer(lp, moe: bool, cfg, x, positions, cache, layer: int,
           moe_blocks: int, attn_kw: dict):
    """One layer: norm, attention, residual, norm, FFN or MoE, residual.
    Returns (x, (k, v) with ``want_kv`` else None, the MoE aux loss or
    None)."""
    h = apply_norm(x, lp["ln1"], cfg.norm_type)
    a, kv = attention_block(lp["attn"], h, cfg, positions, cache, layer,
                            window=cfg.window, **attn_kw)
    x = x + a
    h = apply_norm(x, lp["ln2"], cfg.norm_type)
    if moe:
        out, aux = apply_moe(lp["moe"], h, cfg, n_blocks=moe_blocks)
        return x + out, kv, aux
    return x + apply_ffn(lp["ffn"], h, cfg.ffn_type), kv, None


def _layers(params, cfg, x, positions, cache=None, moe_blocks: int = 1,
            remat: bool = False, **attn_kw):
    """The layer stacks (dense, then MoE); cache layer ``layer`` runs
    across both. ``remat``: each layer's activations are recomputed in
    the backward pass (no cache). Returns (x, the layers' (k, v) with
    ``want_kv``, else Nones, the sum of the MoE layers' aux losses (fp32,
    0 without MoE))."""
    kvs = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stack = [(lp, False) for lp in params.get("layers", ())] + \
        [(lp, True) for lp in params.get("moe_layers", ())]
    for layer, (lp, moe) in enumerate(stack):
        args = (lp, moe, cfg, x, positions, cache, layer, moe_blocks,
                attn_kw)
        x, kv, a = (checkpoint(_layer, *args, use_reentrant=False)
                    if remat else _layer(*args))
        if a is not None:
            aux = aux + a
        kvs.append(kv)
    return x, kvs, aux


def _head(params, cfg, x):
    """Final norm and the LM head (tied: the embedding table's
    transpose); fp32 logits."""
    x = apply_norm(x, params["final_norm"], cfg.norm_type)
    head = params.get("lm_head")
    if head is None:
        table = params["embed"]
        if isinstance(table, PackedWeight):
            table = table.dequantize()
        return (x @ table.to(x.dtype).T).float()
    return dense(x, head).float()


def embed_inputs(params, cfg, batch):
    """tokens (+ a VLM's ``patch_embeds``, projected and prepended) →
    (B, P + S, d), positions (P + S,)."""
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        patches = dense(batch["patch_embeds"].to(x.dtype),
                        params["patch_proj"])
        x = torch.cat([patches, x], dim=1)
    return x, torch.arange(x.shape[1], dtype=torch.int32,
                           device=tokens.device)


def forward(params, cfg, batch, cache: Optional[KVCache] = None,
            positions=None, *, want_cache=False,
            cache_len: Optional[int] = None, pad_mask=None,
            moe_blocks: int = 1):
    """Returns (logits (B, S, V) fp32 — (B, P + S, V) with a VLM's P
    patch embeds — and new_cache). ``cache`` ⇒ a decode
    step at ``positions`` (1,), the cache updated in place and returned;
    ``want_cache`` ⇒ prefill, assembling a fresh cache of ``cache_len``
    rows from the computed K/V. ``pad_mask`` (B, S) marks True = padding
    tokens whose K/V are never attended to (left- or right-padded
    batched prefill). ``moe_blocks``: the MoE layers' dispatch blocks
    (:func:`~repro_torch.models.ffn.apply_moe`)."""
    if positions is None and cache is None:
        x, positions = embed_inputs(params, cfg, batch)
    else:
        x = embed_lookup(params["embed"], batch["tokens"])
    kv_pos_override = None
    if pad_mask is not None and cache is None:
        kv_pos_override = torch.where(pad_mask, -1,
                                      positions[None, :].to(torch.int32))
    x, kvs, _ = _layers(params, cfg, x, positions, cache,
                        moe_blocks=moe_blocks,
                        want_kv=want_cache and cache is None,
                        kv_pos_override=kv_pos_override)
    logits = _head(params, cfg, x)
    if cache is None and want_cache:
        cache = assemble_cache(cfg, kvs, positions, max_len=cache_len,
                               pad_mask=pad_mask)
    return logits, cache


def loss_fn(params, cfg, batch, *, remat: bool = True,
            aux_weight: float = 0.01, moe_blocks: int = 1):
    """The training loss of a batch {tokens (B, S), labels (B, S)} (and a
    VLM's ``patch_embeds``): the mean next-token cross-entropy over the
    labels >= 0 (a VLM's over its text tokens, after the patch prefix)
    plus ``aux_weight`` times the MoE layers' summed aux loss. Returns
    (loss, {"loss": the cross-entropy, "aux"})."""
    x, positions = embed_inputs(params, cfg, batch)
    x, _, aux = _layers(params, cfg, x, positions, moe_blocks=moe_blocks,
                        remat=remat)
    logits = _head(params, cfg, x)
    labels = batch["labels"]
    if cfg.family == "vlm" and "patch_embeds" in batch:
        logits = logits[:, -labels.shape[1]:]          # the text tokens
    loss = lm_loss(logits, labels)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


def assemble_cache(cfg, kvs, positions, max_len: Optional[int] = None,
                   pad_mask=None):
    """Build a decode cache from prefill K/V (``kvs``: one (k, v) of
    (B, S, Hkv, D) a layer): every position, padded with empty rows to
    ``max_len``. With ``pad_mask`` (B, S), slot_pos becomes per-request
    (L, B, T) and padded entries are marked -1 (never attended).
    Windowed attention (griffin) with S > window keeps a ring of the
    last ``window`` positions, position p in row p % window (``max_len``
    does not apply)."""
    k = torch.stack([kv[0] for kv in kvs])              # (L, B, S, Hkv, D)
    v = torch.stack([kv[1] for kv in kvs])
    L, B, S = k.shape[:3]
    if cfg.window is not None and S > cfg.window:
        W = cfg.window
        pos = positions[-W:].to(torch.int32)
        inv = torch.argsort(pos % W)             # ring rows: slot = pos % W
        k, v, pos = k[:, :, -W:][:, :, inv], v[:, :, -W:][:, :, inv], pos[inv]
        if pad_mask is not None:
            padb = pad_mask[:, -W:][:, inv]              # (B, W) ring order
            sp = torch.where(padb, -1, pos[None, :])
            return KVCache(k, v, sp.expand(L, B, W).contiguous())
        return KVCache(k, v, pos.expand(L, W).contiguous())
    T = max_len or S
    if T < S:
        raise ValueError(f"max_len {T} is shorter than the prompt, {S}")
    pad = T - S
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    sp = torch.cat([positions.to(torch.int32),
                    torch.full((pad,), -1, dtype=torch.int32,
                               device=positions.device)])
    if pad_mask is not None:
        padb = F.pad(pad_mask, (0, pad), value=True)
        sp = torch.where(padb, -1, sp[None, :])                  # (B, T)
        return KVCache(k, v, sp.expand(L, B, T).contiguous())
    return KVCache(k, v, sp.expand(L, T).contiguous())


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> KVCache:
    """An empty cache of ``max_len`` rows (``window`` rows for windowed
    attention) on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    T = min(cfg.window, max_len) if cfg.window else max_len
    shape = (cfg.n_layers, batch_size, T, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   slot_pos=torch.full((cfg.n_layers, T), -1,
                                       dtype=torch.int32, device=device))


def decode_step(params, cfg, cache: KVCache, tokens, pos):
    """One decode step of the whole batch at position ``pos`` (an int,
    shared by the batch). tokens: (B, 1) int. The cache is updated in
    place. Returns (logits (B, 1, V) fp32, cache)."""
    positions = torch.full((1,), int(pos), dtype=torch.int32,
                           device=tokens.device)
    return forward(params, cfg, {"tokens": tokens}, cache=cache,
                   positions=positions)


def prefill(params, cfg, batch, max_len: Optional[int] = None, *,
            pad_mask=None, moe_blocks: int = 1):
    """Prefill = one forward assembling a cache of ``max_len`` rows.
    Returns (logits (B, S, V) fp32, cache)."""
    return forward(params, cfg, batch, want_cache=True, cache_len=max_len,
                   pad_mask=pad_mask, moe_blocks=moe_blocks)


def _forward_slots(params, cfg, cache, tokens, positions, slot_chunk=None,
                   verify: bool = False, fused: bool = True):
    x = embed_lookup(params["embed"], tokens)
    x, _, _ = _layers(params, cfg, x, positions, cache,
                      slot_chunk=slot_chunk, spec_verify=verify,
                      fused_attn=fused)
    if slot_chunk is not None and not verify:
        # only the chunk's last valid token feeds the head (the engine
        # samples the first generated token from it): (1, 1, V), not
        # (1, Sc, V)
        length = slot_chunk[2]
        x = x[:, length - 1:length]
    return _head(params, cfg, x)


def decode_step_slots(params, cfg, cache, tokens, pos, *,
                      fused: bool = True):
    """One decode step over every slot of the cache (updated in place).
    tokens (N, 1) int; pos (N,) per-slot absolute positions. ``fused``:
    attention reads the cache through the fused decode kernel; False
    materializes each layer's cache in the step's dtype and attends it in
    plain PyTorch. Returns logits (N, 1, V) fp32."""
    positions = pos.reshape(-1, 1).to(torch.int32)
    return _forward_slots(params, cfg, cache, tokens, positions,
                          fused=fused)


def prefill_chunk_slots(params, cfg, cache, tokens, slot: int,
                        pos_start: int, length: int):
    """Chunked prefill of one slot straight into the cache (in place):
    tokens (1, Sc) at absolute positions [pos_start, pos_start + Sc),
    the first ``length`` of them real. Returns the logits (1, V) of the
    chunk's last valid token."""
    Sc = tokens.shape[1]
    positions = pos_start + torch.arange(Sc, dtype=torch.int32,
                                         device=tokens.device)
    logits = _forward_slots(params, cfg, cache, tokens, positions,
                            slot_chunk=(slot, pos_start, length))
    return logits[:, 0]


def verify_step_slots(params, cfg, cache, tokens, slot: int, pos_start: int,
                      length: int):
    """Speculative verify of one slot's draft window in one pass: tokens
    (1, Sq) = [last committed token, drafts...] at positions
    [pos_start, pos_start + Sq), the first ``length`` real. Like a prefill
    chunk, the window's K/V are written into the slot (in place), but
    every row attends the window through the storage round trip and
    every row's logits are kept, so row j's argmax is the token a plain
    decode step would produce after window token j. Returns logits
    (1, Sq, V) fp32; rows at >= length are padding."""
    Sq = tokens.shape[1]
    positions = pos_start + torch.arange(Sq, dtype=torch.int32,
                                         device=tokens.device)
    return _forward_slots(params, cfg, cache, tokens, positions,
                          slot_chunk=(slot, pos_start, length), verify=True)
