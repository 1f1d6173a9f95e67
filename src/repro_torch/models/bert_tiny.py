"""bert-tiny sequence classifier (port of ``repro.models.bert_tiny``; Turc
et al. 2019, the paper's test vehicle): 2 layers, d=128, 2 heads,
learned positions, post-LN, GELU FFN with biases, a [CLS] pooler and a
classification head.

This is the model the paper's Table 1 quantizes: ``launch.table1``
fine-tunes it on the two synthetic tasks of
:mod:`repro_torch.data.classification` and compares the baseline with
SplitQuant at INT2/4/8. The layer stack is a Python list of per-layer
dicts (JAX's ``(L, …)`` stack and its ``lax.scan`` become a loop); the
initializer is the port's own, seeded by a ``torch.Generator``, at JAX's
shapes. Attention is the plain non-causal ``attend`` with the padding
folded into the key positions (-1 never attended); a quantized tree runs
its packed matrices through ``dense`` (the matmul kernel on the card)
and adds its quantized biases dequantized. The §4.2 activation
quantization is simulated in plain PyTorch
(:func:`~repro_torch.core.splitquant.split_activation_fake_quant`: one
range per chunk over the whole tensor), as JAX does in jnp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.quantize import linear_percentile
from ..core.splitquant import (activation_chunk_bounds,
                               split_activation_fake_quant)
from ..device import resolve_device
from .attention import attend
from .common import dense, dtype_of, embed_init, embed_lookup, he_init, \
    layer_norm

#: activation tap sites instrumented for calibration
#: (:func:`repro_torch.calib.collect_act_stats`): exactly the §4.2
#: quantization points
ACT_SITES = ("attn_in", "attn_out", "ffn_in", "ffn_hidden")


def _init_layer(gen, cfg, dtype, device):
    d, H, D = cfg.d_model, cfg.n_heads, cfg.head_dim
    z = lambda n: torch.zeros(n, dtype=dtype, device=device)
    he = lambda shape, fan=None: he_init(gen, shape, dtype, device, fan)
    return {
        "attn": {"wq": he((d, H * D)), "bq": z(H * D),
                 "wk": he((d, H * D)), "bk": z(H * D),
                 "wv": he((d, H * D)), "bv": z(H * D),
                 "wo": he((H * D, d)), "bo": z(d)},
        "ln1": {"norm_scale": torch.ones(d, dtype=dtype, device=device),
                "norm_bias": z(d)},
        "ffn": {"w_up": he((d, cfg.d_ff)), "b_up": z(cfg.d_ff),
                "w_down": he((cfg.d_ff, d), cfg.d_ff), "b_down": z(d)},
        "ln2": {"norm_scale": torch.ones(d, dtype=dtype, device=device),
                "norm_bias": z(d)},
    }


def init(cfg, n_classes: int, max_len: int = 128, seed: int = 0,
         device=None):
    """Seeded random parameters at the JAX package's shapes on ``device``
    (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model
    return {
        "embed": embed_init(gen, (cfg.vocab, d), dtype, device),
        "pos_table": embed_init(gen, (max_len, d), dtype, device),
        "embed_ln": {"norm_scale": torch.ones(d, dtype=dtype, device=device),
                     "norm_bias": torch.zeros(d, dtype=dtype,
                                              device=device)},
        "layers": [_init_layer(gen, cfg, dtype, device)
                   for _ in range(cfg.n_layers)],
        "pooler": {"w": he_init(gen, (d, d), dtype, device),
                   "b": torch.zeros(d, dtype=dtype, device=device)},
        "classifier": {"w": he_init(gen, (d, n_classes), dtype, device),
                       "b": torch.zeros(n_classes, dtype=dtype,
                                        device=device)},
    }


def _site_stats(h, n_chunks: int, percentile: float) -> dict:
    """Range statistics of one activation tensor: whole-tensor min/max,
    the symmetric percentile clip points (``jnp.percentile``'s, through
    :func:`~repro_torch.core.quantize.linear_percentile`), and per-chunk
    (§4.2) min/max along the feature axis (the ``array_split``
    chunks)."""
    hf = h.float()
    bounds = activation_chunk_bounds(h.shape[-1], n_chunks)
    spans = list(zip(bounds, bounds[1:]))
    return {"min": hf.min(), "max": hf.max(),
            "p_lo": linear_percentile(hf, (1 - percentile) * 100),
            "p_hi": linear_percentile(hf, percentile * 100),
            "chunk_min": torch.stack([hf[..., lo:hi].min()
                                      for lo, hi in spans]),
            "chunk_max": torch.stack([hf[..., lo:hi].max()
                                      for lo, hi in spans])}


def forward(params, cfg, batch, *, act_quant=None, act_chunks: int = 1,
            collect_stats=None):
    """batch: {tokens (B, S), mask (B, S) 1 = real} → logits (B,
    n_classes) fp32.

    ``act_quant``: a QuantConfig for simulated activation quantization
    (paper §4.2) at the :data:`ACT_SITES`; ``act_chunks=3`` gives each of
    three feature chunks its own dynamic range (SplitQuant), 1 one range
    for the whole tensor (the baseline).

    ``collect_stats``: ``{"n_chunks": int, "percentile": float}``, the
    calibration instrumentation: the range statistics of every site in
    every layer, each stat stacked over the layers (a leading L axis), and
    the return value becomes ``(logits, {site: stats})``."""
    def aq(h):
        if act_quant is None:
            return h
        return split_activation_fake_quant(h, act_quant, n_chunks=act_chunks)

    tokens = batch["tokens"]
    B, S = tokens.shape
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(tokens)
    x = embed_lookup(params["embed"], tokens) + params["pos_table"][None, :S]
    x = layer_norm(x, params["embed_ln"]["norm_scale"],
                   params["embed_ln"]["norm_bias"])
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    H, D = cfg.n_heads, cfg.head_dim
    # the padding folded into the key positions: masked keys get -1
    kv_pos = torch.where(mask > 0, positions[None, :], -1)      # (B, S)
    per_layer = []
    for lp in params["layers"]:
        a, stats = lp["attn"], {}

        def tap(site, h):
            if collect_stats is not None:
                stats[site] = _site_stats(h, collect_stats["n_chunks"],
                                          collect_stats["percentile"])
            return aq(h)

        x = tap("attn_in", x)
        q = dense(x, a["wq"], a["bq"]).reshape(B, S, H, D)
        k = dense(x, a["wk"], a["bk"]).reshape(B, S, H, D)
        v = dense(x, a["wv"], a["bv"]).reshape(B, S, H, D)
        o = attend(q, k, v, positions, kv_pos, causal=False)
        o = tap("attn_out", o.reshape(B, S, H * D))
        x = layer_norm(x + dense(o, a["wo"], a["bo"]),
                       lp["ln1"]["norm_scale"], lp["ln1"]["norm_bias"])
        h = F.gelu(dense(tap("ffn_in", x), lp["ffn"]["w_up"],
                         lp["ffn"]["b_up"]), approximate="tanh")
        h = dense(tap("ffn_hidden", h), lp["ffn"]["w_down"],
                  lp["ffn"]["b_down"])
        x = layer_norm(x + h, lp["ln2"]["norm_scale"],
                       lp["ln2"]["norm_bias"])
        per_layer.append(stats)
    pooled = torch.tanh(dense(x[:, 0], params["pooler"]["w"],
                              params["pooler"]["b"]))
    logits = dense(pooled, params["classifier"]["w"],
                   params["classifier"]["b"]).float()
    if collect_stats is None:
        return logits
    return logits, {site: {s: torch.stack([st[site][s] for st in per_layer])
                           for s in per_layer[0][site]}
                    for site in ACT_SITES}


def loss_fn(params, cfg, batch, **_):
    """Mean cross-entropy of the labels (B,) and the batch's accuracy:
    (loss, {"loss", "acc"})."""
    logits = forward(params, cfg, batch)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}


def accuracy(params, cfg, batch):
    logits = forward(params, cfg, batch)
    return (logits.argmax(-1) == batch["labels"].long()).float().mean()
