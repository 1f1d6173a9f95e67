"""Whisper-tiny (arXiv:2212.04356), port of ``repro.models.whisper``: an
encoder-decoder whose conv audio frontend is a stub, as in the JAX
package: a batch carries precomputed frame embeddings ``frames``
(B, enc_seq, d), the output the two conv layers would give. Everything
after it is real: learned positions, the bidirectional encoder, the
causal decoder with cross-attention, LayerNorm and biased linears, the
head tied to the embedding table.

Parameters are plain nested dicts with the JAX package's names; the
stacks ``enc_layers`` and ``dec_layers`` are Python lists of per-layer
dicts, while :class:`WhisperCache` keeps the JAX layout, stacked over
the decoder's layers. The initializer is the port's own, seeded by a
``torch.Generator``, at the same shapes. Every attention and FFN bias is
a leaf ``quantize_tree`` quantizes (a 1-D ``SplitQuantTensor``, added
dequantized by ``dense``); the position tables and the embedding table
are tables, quantized only with ``quantize_embeddings``. The tied head
``x @ embed.T`` is a plain product, as in JAX, outside any kernel.
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

#: rows of the decoder's learned position table (JAX's ``dec_pos``)
DEC_POS_ROWS = 4096


class WhisperCache(NamedTuple):
    self_k: torch.Tensor     # (Ld, B, T, H, D)
    self_v: torch.Tensor
    slot_pos: torch.Tensor   # (Ld, T)
    cross_k: torch.Tensor    # (Ld, B, enc_seq, H, D): fixed after prefill
    cross_v: torch.Tensor


def _init_attn(gen, cfg, dtype, device):
    d, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    z = lambda n: torch.zeros(n, dtype=dtype, device=device)
    return {"wq": he_init(gen, (d, Hq * D), dtype, device), "bq": z(Hq * D),
            "wk": he_init(gen, (d, Hkv * D), dtype, device),
            "bk": z(Hkv * D),
            "wv": he_init(gen, (d, Hkv * D), dtype, device),
            "bv": z(Hkv * D),
            "wo": he_init(gen, (Hq * D, d), dtype, device, fan_in=Hq * D),
            "bo": z(d)}


def _init_enc_layer(gen, cfg, dtype, device):
    d = cfg.d_model
    return {"ln1": init_norm(d, "layer", dtype, device),
            "attn": _init_attn(gen, cfg, dtype, device),
            "ln2": init_norm(d, "layer", dtype, device),
            "ffn": init_ffn(gen, d, cfg.d_ff, "gelu", dtype, device,
                            bias=True)}


def _init_dec_layer(gen, cfg, dtype, device):
    d = cfg.d_model
    return {"ln1": init_norm(d, "layer", dtype, device),
            "attn": _init_attn(gen, cfg, dtype, device),
            "ln_cross": init_norm(d, "layer", dtype, device),
            "cross": _init_attn(gen, cfg, dtype, device),
            "ln2": init_norm(d, "layer", dtype, device),
            "ffn": init_ffn(gen, d, cfg.d_ff, "gelu", dtype, device,
                            bias=True)}


def init(cfg, seed: int = 0, device=None):
    """Seeded random parameters at the config's shapes, on ``device``
    (the card unless ``device="cpu"``)."""
    if cfg.family != "audio":
        raise ValueError(f"whisper builds the 'audio' family, got "
                         f"{cfg.name!r}")
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model
    return {
        "embed": embed_init(gen, (cfg.vocab, d), dtype, device),
        "enc_pos": embed_init(gen, (cfg.enc_seq, d), dtype, device),
        "dec_pos": embed_init(gen, (DEC_POS_ROWS, d), dtype, device),
        "enc_layers": [_init_enc_layer(gen, cfg, dtype, device)
                       for _ in range(cfg.n_enc_layers)],
        "dec_layers": [_init_dec_layer(gen, cfg, dtype, device)
                       for _ in range(cfg.n_layers)],
        "enc_final": init_norm(d, "layer", dtype, device),
        "final_norm": init_norm(d, "layer", dtype, device),
    }


def encode(params, cfg, frames):
    """frames: (B, enc_seq, d) stub conv output → encoder states
    (bidirectional attention over positions 0 … enc_seq - 1)."""
    x = frames.to(params["enc_pos"].dtype) + params["enc_pos"][None]
    positions = torch.arange(cfg.enc_seq, dtype=torch.int32,
                             device=x.device)
    for lp in params["enc_layers"]:
        h = apply_norm(x, lp["ln1"], "layer")
        out, _ = attention_block(lp["attn"], h, cfg, positions,
                                 causal=False)
        x = x + out
        h = apply_norm(x, lp["ln2"], "layer")
        x = x + apply_ffn(lp["ffn"], h, "gelu")
    return apply_norm(x, params["enc_final"], "layer")


def _cross_kv(lp, enc_out, cfg):
    """A decoder layer's cross-attention K/V of the encoder states, with
    their biases: (B, enc_seq, Hkv, D) each."""
    B, T, _ = enc_out.shape
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
    k = dense(enc_out, lp["cross"]["wk"], lp["cross"]["bk"]).reshape(shape)
    v = dense(enc_out, lp["cross"]["wv"], lp["cross"]["bv"]).reshape(shape)
    return k, v


def _dec_layer(cfg, lp, x, positions, self_cache, layer, cross_k, cross_v,
               want_kv=False, kv_chunk=None):
    enc_pos = torch.arange(cross_k.shape[1], dtype=torch.int32,
                           device=x.device)
    h = apply_norm(x, lp["ln1"], "layer")
    out, kv = attention_block(lp["attn"], h, cfg, positions, self_cache,
                              layer, causal=True, want_kv=want_kv,
                              kv_chunk=kv_chunk)
    x = x + out
    h = apply_norm(x, lp["ln_cross"], "layer")
    out, _ = attention_block(lp["cross"], h, cfg, positions, causal=False,
                             cross_kv=(cross_k, cross_v, enc_pos))
    x = x + out
    h = apply_norm(x, lp["ln2"], "layer")
    return x + apply_ffn(lp["ffn"], h, "gelu"), kv


def _head(params, x):
    """Final LayerNorm and the tied head ``x @ embed.T`` (the table
    dequantized first when ``quantize_embeddings`` packed it): fp32
    logits."""
    x = apply_norm(x, params["final_norm"], "layer")
    table = materialize(params["embed"], x.dtype)
    return torch.matmul(x, table.T).float()


def forward(params, cfg, batch, cache: Optional[WhisperCache] = None,
            positions=None, *, want_cache: bool = False, remat: bool = False,
            kv_chunk=None, **_):
    """Train or prefill: batch {frames, tokens}. Decode: batch {tokens}
    (B, 1) and a cache (the cross K/V computed at prefill), its self-
    attention rows written in place. Returns (logits (B, S, V) fp32, the
    cache with ``want_cache`` or in decode, else None). ``remat``: each
    decoder layer is recomputed in the backward pass, as JAX's."""
    from .transformer import assemble_cache

    tokens = batch["tokens"]
    B, S = tokens.shape
    decode = cache is not None and S == 1
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_lookup(params["embed"], tokens) + \
        params["dec_pos"][positions.long()][None]
    if decode:
        cross = list(zip(cache.cross_k, cache.cross_v))
        self_cache = KVCache(cache.self_k, cache.self_v, cache.slot_pos)
    else:
        enc_out = encode(params, cfg, batch["frames"])
        cross = [_cross_kv(lp, enc_out, cfg) for lp in params["dec_layers"]]
        self_cache = None
    want_kv = want_cache and not decode
    kvs = []
    for i, (lp, (ck, cv)) in enumerate(zip(params["dec_layers"], cross)):
        args = (cfg, lp, x, positions, self_cache, i, ck, cv, want_kv,
                kv_chunk)
        x, kv = (checkpoint(_dec_layer, *args, use_reentrant=False)
                 if remat else _dec_layer(*args))
        kvs.append(kv)
    logits = _head(params, x)
    if decode:
        return logits, cache
    new_cache = None
    if want_cache:
        ring = assemble_cache(cfg, kvs, positions)
        new_cache = WhisperCache(ring.k, ring.v, ring.slot_pos,
                                 torch.stack([k for k, _ in cross]),
                                 torch.stack([v for _, v in cross]))
    return logits, new_cache


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> WhisperCache:
    """An empty cache of ``max_len`` self-attention rows and zero cross
    K/V on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    Ld, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return WhisperCache(z(Ld, batch_size, max_len, H, D),
                        z(Ld, batch_size, max_len, H, D),
                        torch.full((Ld, max_len), -1, dtype=torch.int32,
                                   device=device),
                        z(Ld, batch_size, cfg.enc_seq, H, D),
                        z(Ld, batch_size, cfg.enc_seq, H, D))


def loss_fn(params, cfg, batch, *, remat: bool = True, kv_chunk=None, **_):
    """Mean next-token cross-entropy over the labels >= 0 of a batch
    {frames, tokens, labels}. Returns (loss, {"loss"})."""
    logits, _ = forward(params, cfg, batch, remat=remat, kv_chunk=kv_chunk)
    loss = lm_loss(logits, batch["labels"])
    return loss, {"loss": loss}


def decode_step(params, cfg, cache: WhisperCache, tokens, pos):
    """One token of the whole batch at position ``pos`` (shared): tokens
    (B, 1); the self-attention rows are written in place. Returns
    (logits (B, 1, V) fp32, cache)."""
    positions = torch.full((1,), int(pos), dtype=torch.int32,
                           device=tokens.device)
    return forward(params, cfg, {"tokens": tokens}, cache=cache,
                   positions=positions)


def prefill(params, cfg, batch, max_len=None, *, kv_chunk=None,
            pad_mask=None, moe_blocks=1):
    """Prefill the decoder's self-cache (padded with empty rows, position
    -1, to ``max_len``) and the encoder's cross K/V. Options this family
    cannot honor fail loudly: ignoring a pad mask would leave left-pad
    K/V attendable."""
    if pad_mask is not None:
        raise NotImplementedError(
            "whisper prefill cannot honor pad_mask: WhisperCache keeps no "
            "per-request KV validity, so left-padded batches would attend "
            "to pad K/V — serve whisper with unpadded (per-request) "
            "prompts instead")
    if moe_blocks != 1:
        raise NotImplementedError("whisper has no MoE layers to block "
                                  f"(moe_blocks={moe_blocks})")
    logits, cache = forward(params, cfg, batch, want_cache=True,
                            kv_chunk=kv_chunk)
    S = batch["tokens"].shape[1]
    if max_len and max_len > S:
        pad = max_len - S
        cache = WhisperCache(
            F.pad(cache.self_k, (0, 0, 0, 0, 0, pad)),
            F.pad(cache.self_v, (0, 0, 0, 0, 0, pad)),
            F.pad(cache.slot_pos, (0, pad), value=-1),
            cache.cross_k, cache.cross_v)
    return logits, cache


def verify_step_slots(*args, **kwargs):
    """Speculative decoding runs over the engine's slot cache, which this
    family does not have: fail loudly."""
    raise NotImplementedError(
        "whisper cannot serve speculative decoding (spec_k > 0): the "
        "engine's draft/verify/rollback contract needs a slot-indexed "
        "cache with per-position validity, but WhisperCache is a "
        "wave-loop cache with no slot layout (and no rollback of the "
        "encoder cross-attention state). Serve this family with "
        "spec_k=0")
