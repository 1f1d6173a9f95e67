"""RWKV-6 "Finch" (arXiv:2404.05892), port of ``repro.models.rwkv6``: an
attention-free LM with data-dependent decay and a matrix-valued state
per head, so decoding needs O(1) memory.

Per-layer time-mix recurrence (head h, key dim i, value dim j):
    S_t[i,j] = w_t[i] · S_{t-1}[i,j] + k_t[i] · v_t[j]
    y_t[j]   = Σ_i r_t[i] · (S_{t-1}[i,j] + u[i]·k_t[i]·v_t[j])
with w_t = exp(-exp(d + tanh(x_w W1) W2)) ∈ (0, 1).

Parameters are plain nested dicts with the JAX package's names; the layer
stack is a Python list of per-layer dicts (the JAX ``(L, …)`` stack and
its ``lax.scan`` become a loop), while :class:`RWKVState` keeps the
JAX layout, stacked over layers. The initializer is the port's own,
seeded by a ``torch.Generator``, at the same shapes. The decay, μ and u
parameters carry the ``time_`` fragment and stay unquantized, as in the
JAX package.

Like the JAX model, a time-mix over T > 1 tokens with T % 16 == 0 runs
the chunked WKV (:func:`~repro_torch.kernels.wkv_chunked.wkv_chunked`, the
CUDA kernel on the card, differentiated by its backward kernel); any
other length, decode included, runs the recurrence step by step in plain
PyTorch (autograd differentiates it), as JAX runs it in ``lax.scan``
outside any kernel. :func:`loss_fn` is the training loss, every layer
recomputed in the backward pass under ``remat``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels.wkv_chunked import wkv_chunked, wkv_step_ref
from .common import (apply_norm, dense, dtype_of, embed_init, embed_lookup,
                     he_init, init_norm, lm_loss)

LORA_MU, LORA_DECAY = 32, 64


class RWKVState(NamedTuple):
    """Recurrent cache: token-shift carries + per-head matrix state."""
    att_xprev: torch.Tensor   # (L, B, d)
    ffn_xprev: torch.Tensor   # (L, B, d)
    wkv: torch.Tensor         # (L, B, H, Dh, Dh) fp32


def _heads(cfg) -> tuple[int, int]:
    return cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim


def _init_layer(gen, cfg, dtype, device):
    d, ff = cfg.d_model, cfg.d_ff
    H, Dh = _heads(cfg)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    he = lambda *s, fan_in=None: he_init(gen, s, dtype, device, fan_in)
    return {
        "ln1": init_norm(d, "rms", dtype, device),
        "ln2": init_norm(d, "rms", dtype, device),
        "att": {
            "time_mu_x": z(d), "time_mu_w": z(d), "time_mu_k": z(d),
            "time_mu_v": z(d), "time_mu_r": z(d), "time_mu_g": z(d),
            "time_w1": he(d, 5 * LORA_MU),
            "time_w2": he(5, LORA_MU, d, fan_in=LORA_MU),
            "time_decay": torch.full((d,), -4.0, dtype=dtype, device=device),
            "time_decay_w1": he(d, LORA_DECAY),
            "time_decay_w2": he(LORA_DECAY, d, fan_in=LORA_DECAY),
            "time_faaaa": z(H, Dh),
            "wr": he(d, d), "wk": he(d, d), "wv": he(d, d), "wg": he(d, d),
            "wo": he(d, d),
            "ln_x_scale": torch.ones(d, dtype=dtype, device=device),
            "ln_x_bias": z(d),
        },
        "ffn": {
            "time_mu_k": z(d), "time_mu_r": z(d),
            "wr": he(d, d), "wk": he(d, ff), "wv": he(ff, d, fan_in=ff),
        },
    }


def init(cfg, seed: int = 0, device=None):
    """Seeded random parameters at the config's shapes, on ``device``
    (the card unless ``device="cpu"``)."""
    if cfg.family != "ssm":
        raise ValueError(f"rwkv6 builds the 'ssm' family, got {cfg.name!r}")
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dtype, device),
        "layers": [_init_layer(gen, cfg, dtype, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": init_norm(cfg.d_model, "rms", dtype, device),
        "lm_head": he_init(gen, (cfg.d_model, cfg.vocab), dtype, device),
    }


def init_state(cfg, batch_size: int, dtype=torch.bfloat16,
               device=None) -> RWKVState:
    d, L = cfg.d_model, cfg.n_layers
    H, Dh = _heads(cfg)
    device = resolve_device(device)
    return RWKVState(
        att_xprev=torch.zeros((L, batch_size, d), dtype=dtype, device=device),
        ffn_xprev=torch.zeros((L, batch_size, d), dtype=dtype, device=device),
        wkv=torch.zeros((L, batch_size, H, Dh, Dh), device=device))


def _token_shift(x, x_prev):
    """(B, T, d) → x_{t-1} with carry-in x_prev (B, d)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(x, xx, mu, lora):
    return x + (xx - x) * (mu + lora)


def _time_mix(p, x, cfg, x_prev, wkv_state):
    """x: (B, T, d). Returns (out, new_x_prev, new_wkv_state)."""
    B, T, d = x.shape
    H, Dh = _heads(cfg)
    xx = _token_shift(x, x_prev)
    base = _ddlerp(x, xx, p["time_mu_x"], 0.0)
    m = torch.tanh(dense(base, p["time_w1"])).reshape(B, T, 5, LORA_MU)
    lora = torch.einsum("btfm,fmd->fbtd", m, p["time_w2"].to(x.dtype))
    xw = _ddlerp(x, xx, p["time_mu_w"], lora[0])
    xk = _ddlerp(x, xx, p["time_mu_k"], lora[1])
    xv = _ddlerp(x, xx, p["time_mu_v"], lora[2])
    xr = _ddlerp(x, xx, p["time_mu_r"], lora[3])
    xg = _ddlerp(x, xx, p["time_mu_g"], lora[4])

    r = dense(xr, p["wr"]).reshape(B, T, H, Dh)
    k = dense(xk, p["wk"]).reshape(B, T, H, Dh)
    v = dense(xv, p["wv"]).reshape(B, T, H, Dh)
    g = torch.nn.functional.silu(dense(xg, p["wg"]))
    dec = p["time_decay"].float() + dense(
        torch.tanh(dense(xw, p["time_decay_w1"])), p["time_decay_w2"]).float()
    w = torch.exp(-torch.exp(dec)).reshape(B, T, H, Dh)      # (0, 1)
    u = p["time_faaaa"].float()                              # (H, Dh)

    # the (B·H, T, Dh) fold of both branches
    fold = lambda a: a.transpose(1, 2).reshape(B * H, T, Dh)
    u_f = u.expand(B, H, Dh).reshape(B * H, Dh)
    s0 = wkv_state.reshape(B * H, Dh, Dh)
    if T > 1 and T % 16 == 0:
        yf, Sf = wkv_chunked(fold(r), fold(k), fold(v), fold(w), u_f,
                             s0=s0)
    else:
        yf, Sf = wkv_step_ref(*(fold(a.float()) for a in (r, k, v, w)), u_f,
                              s0=s0)
    y = yf.reshape(B, H, T, Dh).transpose(1, 2).reshape(B, T, d).float()
    S = Sf.reshape(B, H, Dh, Dh)

    # per-head group norm
    yh = y.reshape(B, T, H, Dh)
    mu_ = yh.mean(-1, keepdim=True)
    var = yh.var(-1, correction=0, keepdim=True)
    yh = (yh - mu_) * torch.rsqrt(var + 64e-5)
    y = yh.reshape(B, T, d) * p["ln_x_scale"].float() + p["ln_x_bias"].float()
    out = dense(y.to(x.dtype) * g, p["wo"])
    return out, x[:, -1, :], S


def _channel_mix(p, x, x_prev):
    xx = _token_shift(x, x_prev)
    xk = _ddlerp(x, xx, p["time_mu_k"], 0.0)
    xr = _ddlerp(x, xx, p["time_mu_r"], 0.0)
    r = torch.sigmoid(dense(xr, p["wr"]))
    k = torch.square(torch.relu(dense(xk, p["wk"])))
    return r * dense(k, p["wv"]), x[:, -1, :]


def _layer(cfg, p, x, state_layer):
    ax, fx, S = state_layer
    h = apply_norm(x, p["ln1"], "rms")
    att, ax, S = _time_mix(p["att"], h, cfg, ax, S)
    x = x + att
    h = apply_norm(x, p["ln2"], "rms")
    ffn, fx = _channel_mix(p["ffn"], h, fx)
    return x + ffn, (ax, fx, S)


def forward(params, cfg, batch, state: RWKVState | None = None, *,
            remat: bool = False):
    """batch {"tokens": (B, T) int} → (logits (B, T, V) fp32, new
    state). ``remat``: each layer's activations are recomputed in the
    backward pass (``torch.utils.checkpoint``, as JAX's
    ``jax.checkpoint``)."""
    x = embed_lookup(params["embed"], batch["tokens"])
    if state is None:
        state = init_state(cfg, x.shape[0], x.dtype, x.device)
    axs, fxs, Ss = [], [], []
    for i, lp in enumerate(params["layers"]):
        args = (cfg, lp, x, (state.att_xprev[i].to(x.dtype),
                             state.ffn_xprev[i].to(x.dtype), state.wkv[i]))
        x, (ax, fx, S) = (checkpoint(_layer, *args, use_reentrant=False)
                          if remat else _layer(*args))
        axs.append(ax)
        fxs.append(fx)
        Ss.append(S)
    x = apply_norm(x, params["final_norm"], "rms")
    logits = dense(x, params["lm_head"]).float()
    return logits, RWKVState(torch.stack(axs), torch.stack(fxs),
                             torch.stack(Ss))


def loss_fn(params, cfg, batch, *, remat: bool = True, **_):
    """Mean next-token cross-entropy over the labels >= 0 of a batch
    {tokens, labels}. Returns (loss, {"loss"})."""
    logits, _ = forward(params, cfg, batch, remat=remat)
    loss = lm_loss(logits, batch["labels"])
    return loss, {"loss": loss}


def decode_step(params, cfg, state: RWKVState, tokens):
    """One token per sequence: tokens (B, 1) → (logits (B, 1, V),
    state)."""
    return forward(params, cfg, {"tokens": tokens}, state)


def prefill(params, cfg, batch, *, pad_mask=None, moe_blocks=1):
    """Prefill = one forward from the zero state. Options whose silent
    swallowing would corrupt results fail loudly: the recurrence folds
    every input token into the state in order, so a pad mask cannot be
    honored."""
    if pad_mask is not None:
        raise NotImplementedError(
            "rwkv6 prefill cannot honor pad_mask: the recurrence "
            "integrates every token into the state in order, so pad "
            "tokens would corrupt it — feed unpadded (per-request) "
            "prompts instead")
    if moe_blocks != 1:
        raise NotImplementedError("rwkv6 has no MoE layers to block "
                                  f"(moe_blocks={moe_blocks})")
    return forward(params, cfg, batch)


def verify_step_slots(*args, **kwargs):
    """Speculative decoding needs positional KV rollback, which a
    recurrence cannot provide: fail loudly."""
    raise NotImplementedError(
        "rwkv6 cannot serve speculative decoding (spec_k > 0): rejecting "
        "draft tokens requires rolling the cache back to the accepted "
        "position, but the WKV state is a running recurrence with no "
        "per-position storage — once a draft token is folded in it "
        "cannot be unfolded. Serve this family with spec_k=0")
