"""Griffin / RecurrentGemma (arXiv:2402.19427), port of
``repro.models.griffin``: RG-LRU recurrent blocks and local (windowed,
MQA) attention in a 1 attn : 2 recurrent ratio.

Layer pattern: groups of (rec, rec, attn), then ``n_layers mod 3``
trailing recurrent layers (``tail``). Parameters are plain nested dicts
with the JAX package's names; each stack (``groups``, ``tail``) is a
Python list of per-layer dicts (JAX's ``(L, …)`` stacks and their
``lax.scan`` become a loop), while :class:`GriffinCache` keeps the JAX
layout, stacked over layers. The initializer is the port's own, seeded
by a ``torch.Generator``, at the same shapes; with ``on_part`` it hands
each part of the tree to a hook as it is drawn (the part-by-part
quantized build of ``launch.serve.build_params``).

The RG-LRU is a linear elementwise recurrence. Prefill and training run
it as JAX's ``lax.associative_scan`` does (:func:`associative_scan`:
log-depth odd/even recursion over slices of T, the same combinations in
the same order); decode keeps an O(1) state. The local attention keeps a
ring of ``window`` rows (``attention.KVCache``; position p in row
p % window). The gate parameters (``rg_lru_*``) stay fp32 and
unquantized; the depthwise conv's taps and bias are quantized like any
other leaf and read dequantized (``materialize``). The JAX package has no
Pallas kernel on this family: every packed matrix runs through the
port's SplitQuant matmul, the rest is plain PyTorch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .attention import KVCache, attention_block
from .common import (apply_norm, dense, dtype_of, embed_init, embed_lookup,
                     he_init, init_norm, lm_loss, materialize)
from .ffn import apply_ffn, init_ffn

LRU_C = 8.0   # Griffin's fixed gate sharpness


class GriffinCache(NamedTuple):
    rec_h: torch.Tensor      # (Lr, B, lru)        RG-LRU hidden state, fp32
    rec_conv: torch.Tensor   # (Lr, B, cw-1, lru)  temporal-conv tail
    attn_k: torch.Tensor     # (La, B, W, Hkv, D)  ring buffer
    attn_v: torch.Tensor
    attn_pos: torch.Tensor   # (La, W) row → absolute position (-1 empty)


def _lru_width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def _init_rec(gen, cfg, dtype, device):
    d, r = cfg.d_model, _lru_width(cfg)
    f32 = torch.float32
    return {
        "ln": init_norm(d, cfg.norm_type, dtype, device),
        "w_x": he_init(gen, (d, r), dtype, device),
        "w_gate_branch": he_init(gen, (d, r), dtype, device),
        "conv_w": (torch.randn((cfg.conv_width, r), generator=gen,
                               device=device) * 0.1).to(dtype),
        "conv_b": torch.zeros(r, dtype=dtype, device=device),
        "rg_lru_lambda": torch.full((r,), 2.0, dtype=f32, device=device),
        "rg_lru_wa": he_init(gen, (r, r), f32, device).mul_(0.1),
        "rg_lru_ba": torch.zeros(r, dtype=f32, device=device),
        "rg_lru_wx": he_init(gen, (r, r), f32, device).mul_(0.1),
        "rg_lru_bx": torch.zeros(r, dtype=f32, device=device),
        "w_out": he_init(gen, (r, d), dtype, device, fan_in=r),
        "ln_mlp": init_norm(d, cfg.norm_type, dtype, device),
        "mlp": init_ffn(gen, d, cfg.d_ff, cfg.ffn_type, dtype, device),
    }


def _init_attn(gen, cfg, dtype, device):
    d, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "ln": init_norm(d, cfg.norm_type, dtype, device),
        "attn": {"wq": he_init(gen, (d, Hq * D), dtype, device),
                 "wk": he_init(gen, (d, Hkv * D), dtype, device),
                 "wv": he_init(gen, (d, Hkv * D), dtype, device),
                 "wo": he_init(gen, (Hq * D, d), dtype, device,
                               fan_in=Hq * D)},
        "ln_mlp": init_norm(d, cfg.norm_type, dtype, device),
        "mlp": init_ffn(gen, d, cfg.d_ff, cfg.ffn_type, dtype, device),
    }


def layout(cfg) -> tuple[int, int]:
    """(n_groups, n_tail_rec): groups of (rec, rec, attn) + trailing
    recurrent layers."""
    n_groups = cfg.n_layers // 3
    return n_groups, cfg.n_layers - 3 * n_groups


def init(cfg, seed: int = 0, device=None, on_part=None):
    """Seeded random parameters at the config's shapes, on ``device``
    (the card unless ``device="cpu"``). ``on_part(path, part, stack)``,
    when given, takes each part as soon as it is drawn, in the tree's
    order (as ``transformer.init``'s): the top-level entries (path
    ``(key,)``, stack 1) and each block of a stack (path ``("groups", g,
    "rec1" | "rec2" | "attn")`` or ``("tail", i)``, stack the stack's
    depth); its return value takes the part's place."""
    if cfg.family != "hybrid":
        raise ValueError(f"griffin builds the 'hybrid' family, got "
                         f"{cfg.name!r}")
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    keep = on_part or (lambda path, part, stack: part)
    n_groups, n_tail = layout(cfg)
    params = {"embed": keep(("embed",), embed_init(
        gen, (cfg.vocab, cfg.d_model), dtype, device), 1)}
    params["groups"] = [
        {name: keep(("groups", g, name), fn(gen, cfg, dtype, device),
                    n_groups)
         for name, fn in (("rec1", _init_rec), ("rec2", _init_rec),
                          ("attn", _init_attn))}
        for g in range(n_groups)]
    params["final_norm"] = keep(("final_norm",), init_norm(
        cfg.d_model, cfg.norm_type, dtype, device), 1)
    params["lm_head"] = keep(("lm_head",), he_init(
        gen, (cfg.d_model, cfg.vocab), dtype, device), 1)
    if n_tail:
        params["tail"] = [keep(("tail", i), _init_rec(gen, cfg, dtype,
                                                      device), n_tail)
                          for i in range(n_tail)]
    return params


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise temporal conv of width cw. x: (B, T, r); ``conv_state``
    (B, cw-1, r) the carry-in (zeros when None). The taps are summed left
    to right in x's dtype, as JAX's ``sum``. Returns (y, the last cw-1
    rows of the padded input: the next carry)."""
    cw = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # (B, T+cw-1, r)
    T = x.shape[1]
    y = xp[:, 0:T] * w[0].to(x.dtype)
    for i in range(1, cw):
        y = y + xp[:, i:i + T] * w[i].to(x.dtype)
    return y + b.to(x.dtype), xp[:, -(cw - 1):]


def _combine(left, right):
    """The RG-LRU's associative operator: (a_l·a_r, b_l·a_r + b_r)."""
    (al, bl), (ar, br) = left, right
    return al * ar, bl * ar + br


def _interleave(even, odd):
    """Rows of ``even`` at 0, 2, … and of ``odd`` at 1, 3, … along
    dim 1 (JAX's ``_interleave``)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n, *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a, b):
    """Inclusive scan of (a, b) along dim 1 under :func:`_combine`, in
    ``jax.lax.associative_scan``'s order: adjacent pairs combined, the
    half-length scan by recursion (the odd rows), each even row from the
    odd row before it and the original element. Returns (a, b) scanned;
    b holds h_t."""
    T = a.shape[1]
    if T < 2:
        return a, b
    ra, rb = _combine((a[:, 0:T - 1:2], b[:, 0:T - 1:2]),
                      (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if T % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rg_lru(p, x, h0):
    """x: (B, T, r). h_t = a_t·h_{t-1} + √(1-a_t²)·(i_t·x_t) in fp32, over
    T by :func:`associative_scan`, the carry h0 (B, r) folded into step 0.
    The gate products are fp32 (``rg_lru_*`` are never quantized).
    Returns (h in x's dtype, the last h in fp32)."""
    xf = x.float()
    rt = torch.sigmoid(xf @ p["rg_lru_wa"].float() + p["rg_lru_ba"].float())
    it = torch.sigmoid(xf @ p["rg_lru_wx"].float() + p["rg_lru_bx"].float())
    lam = p["rg_lru_lambda"].float()
    log_a = -LRU_C * torch.logaddexp(lam, torch.zeros_like(lam)) * rt
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=0.0)) * \
        (it * xf)
    b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                  dim=1)
    _, h = associative_scan(a, b)
    return h.to(x.dtype), h[:, -1].float()


def _rec_block(cfg, p, x, state):
    """Griffin recurrent block + its MLP. state: (h0, conv_state)."""
    h0, conv_state = state
    h = apply_norm(x, p["ln"], cfg.norm_type)
    u = dense(h, p["w_x"])
    u, conv_state = _causal_conv(u, materialize(p["conv_w"]),
                                 materialize(p["conv_b"]), conv_state)
    u, h_last = _rg_lru(p, u, h0)
    g = F.gelu(dense(h, p["w_gate_branch"]), approximate="tanh")
    x = x + dense(u * g, p["w_out"])
    m = apply_norm(x, p["ln_mlp"], cfg.norm_type)
    x = x + apply_ffn(p["mlp"], m, cfg.ffn_type)
    return x, (h_last, conv_state)


def _attn_block(cfg, p, x, positions, cache, layer, kv_chunk, want_kv):
    h = apply_norm(x, p["ln"], cfg.norm_type)
    out, kv = attention_block(p["attn"], h, cfg, positions, cache, layer,
                              causal=True, window=cfg.window,
                              kv_chunk=kv_chunk, want_kv=want_kv)
    x = x + out
    m = apply_norm(x, p["ln_mlp"], cfg.norm_type)
    x = x + apply_ffn(p["mlp"], m, cfg.ffn_type)
    return x, kv


def init_cache(cfg, batch_size: int, dtype=torch.bfloat16,
               device=None) -> GriffinCache:
    """Zero recurrent states and an empty ring of ``window`` rows on
    ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    n_groups, n_tail = layout(cfg)
    Lr, La = 2 * n_groups + n_tail, n_groups
    r, W = _lru_width(cfg), cfg.window
    kv = (La, batch_size, W, cfg.n_kv_heads, cfg.head_dim)
    return GriffinCache(
        rec_h=torch.zeros((Lr, batch_size, r), device=device),
        rec_conv=torch.zeros((Lr, batch_size, cfg.conv_width - 1, r),
                             dtype=dtype, device=device),
        attn_k=torch.zeros(kv, dtype=dtype, device=device),
        attn_v=torch.zeros(kv, dtype=dtype, device=device),
        attn_pos=torch.full((La, W), -1, dtype=torch.int32, device=device))


def _blocks(params, cfg):
    """(kind, params, recurrent-state row or attention layer) in order:
    each group's rec1 (row 2g), rec2 (2g + 1) and attn (layer g), then
    the tail's recurrent layers (rows 2·n_groups + i)."""
    n_groups, _ = layout(cfg)
    for g, gp in enumerate(params["groups"]):
        yield "rec", gp["rec1"], 2 * g
        yield "rec", gp["rec2"], 2 * g + 1
        yield "attn", gp["attn"], g
    for i, tp in enumerate(params.get("tail", ())):
        yield "rec", tp, 2 * n_groups + i


def forward(params, cfg, batch, cache: Optional[GriffinCache] = None,
            positions=None, *, kv_chunk=None, remat: bool = False,
            want_cache: bool = False):
    """Returns (logits (B, S, V) fp32, new cache or None).

    S == 1 with a cache ⇒ decode: each attention layer's ring row
    ``pos % window`` is written in place, the recurrent states are
    advanced one step. Otherwise prefill or training: the recurrent
    states start from the given cache (or zeros), attention runs
    windowed over the sequence, and with ``want_cache`` a fresh ring is
    assembled from the last ``window`` positions. ``remat``: each block's
    activations are recomputed in the backward pass."""
    from .transformer import assemble_cache     # the shared ring layout

    x = embed_lookup(params["embed"], batch["tokens"])
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    decode = cache is not None and S == 1
    work = cache if cache is not None else init_cache(cfg, B, x.dtype,
                                                      x.device)
    ring = KVCache(work.attn_k, work.attn_v, work.attn_pos)
    want_kv = want_cache and not decode
    rec_h, rec_conv, kvs = {}, {}, []
    for kind, p, row in _blocks(params, cfg):
        if kind == "rec":
            args = (cfg, p, x, (work.rec_h[row], work.rec_conv[row]))
            x, (rec_h[row], rec_conv[row]) = (
                checkpoint(_rec_block, *args, use_reentrant=False)
                if remat else _rec_block(*args))
        else:
            args = (cfg, p, x, positions, ring if decode else None, row,
                    kv_chunk, want_kv)
            x, kv = (checkpoint(_attn_block, *args, use_reentrant=False)
                     if remat else _attn_block(*args))
            kvs.append(kv)
    x = apply_norm(x, params["final_norm"], cfg.norm_type)
    logits = dense(x, params["lm_head"]).float()

    if not decode and not want_cache and cache is None:
        return logits, None
    h = torch.stack([rec_h[i] for i in sorted(rec_h)]).float()
    c = torch.stack([rec_conv[i] for i in sorted(rec_conv)]).to(
        work.rec_conv.dtype)
    if want_kv:
        new = assemble_cache(cfg, kvs, positions, max_len=cfg.window)
        ak, av, ap = new.k, new.v, new.slot_pos
    else:                   # decode wrote the ring in place
        ak, av, ap = work.attn_k, work.attn_v, work.attn_pos
    return logits, GriffinCache(h, c, ak, av, ap)


def loss_fn(params, cfg, batch, *, kv_chunk=None, remat: bool = True, **_):
    """Mean next-token cross-entropy over the labels >= 0 of a batch
    {tokens, labels}. Returns (loss, {"loss"})."""
    logits, _ = forward(params, cfg, batch, kv_chunk=kv_chunk, remat=remat)
    loss = lm_loss(logits, batch["labels"])
    return loss, {"loss": loss}


def decode_step(params, cfg, cache: GriffinCache, tokens, pos):
    """One token of the whole batch at position ``pos`` (shared): tokens
    (B, 1). The attention rings are written in place. Returns (logits
    (B, 1, V) fp32, cache)."""
    positions = torch.full((1,), int(pos), dtype=torch.int32,
                           device=tokens.device)
    return forward(params, cfg, {"tokens": tokens}, cache=cache,
                   positions=positions)


def prefill(params, cfg, batch, max_len=None, *, kv_chunk=None,
            pad_mask=None, moe_blocks=1):
    """Prefill from the zero state. The returned cache carries the
    recurrent states and a ring of the last ``window`` positions, so
    ``max_len`` is met whatever it is (a ring never overflows). Options
    whose silent swallowing would corrupt results fail loudly: a pad mask
    cannot be honored, because the RG-LRU folds every token into its
    state in order."""
    if pad_mask is not None:
        raise NotImplementedError(
            "griffin prefill cannot honor pad_mask: the RG-LRU states "
            "integrate every token in order, so pad tokens would corrupt "
            "them — feed unpadded (per-request) prompts instead")
    if moe_blocks != 1:
        raise NotImplementedError("griffin has no MoE layers to block "
                                  f"(moe_blocks={moe_blocks})")
    return forward(params, cfg, batch, kv_chunk=kv_chunk, want_cache=True)


def verify_step_slots(*args, **kwargs):
    """Speculative decoding needs positional rollback, which the RG-LRU
    recurrence cannot provide: fail loudly."""
    raise NotImplementedError(
        "griffin cannot serve speculative decoding (spec_k > 0): "
        "rejecting draft tokens requires rolling the cache back to the "
        "accepted position, but the RG-LRU states integrate every token "
        "into a running recurrence with no per-position storage (the "
        "local-attention ring alone cannot restore them). Serve this "
        "family with spec_k=0")
