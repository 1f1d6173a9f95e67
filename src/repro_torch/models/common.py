"""Shared model building blocks (port of ``repro.models.common``): the
quantization-transparent dense layer, norms, RoPE (full and GLM's half
variant), embedding lookup and the initializers."""
from __future__ import annotations

import torch

from ..kernels import ops
from ..core.splitquant import SplitQuantTensor
from ..kernels.ops import PackedWeight

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def dense(x, w, b=None):
    """Linear layer (:func:`~repro_torch.kernels.ops.linear`): the
    quantized path for packed SplitQuant weights, a quantized bias added
    dequantized. Computation dtype follows x."""
    return ops.linear(x, w, b)


def materialize(w, dtype=None):
    """Dense view of a (possibly quantized) parameter, for ops that need
    the raw tensor (griffin's depthwise conv taps and bias): a packed
    weight or a quantized bias dequantized (eq. 4), as the JAX package's
    ``materialize``."""
    if isinstance(w, (PackedWeight, SplitQuantTensor)):
        w = w.dequantize()
    return w if dtype is None else w.to(dtype)


def embed_lookup(table, ids):
    """Rows ``ids`` of the embedding table; a packed table
    (``quantize_embeddings``) is dequantized first, as the JAX package
    does."""
    if isinstance(table, PackedWeight):
        table = table.dequantize()
    return table[ids]


def lm_loss(logits, labels):
    """Mean next-token cross-entropy of fp32 ``logits`` (B, S, V) over the
    ``labels`` >= 0 (B, S) (the LM losses of every decoder family)."""
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return loss


def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


def apply_norm(x, p, norm_type: str):
    if norm_type == "rms":
        return rms_norm(x, p["norm_scale"])
    return layer_norm(x, p["norm_scale"], p["norm_bias"])


def init_norm(d, norm_type: str, dtype, device):
    if norm_type == "rms":
        return {"norm_scale": torch.zeros(d, dtype=dtype, device=device)}
    return {"norm_scale": torch.ones(d, dtype=dtype, device=device),
            "norm_bias": torch.zeros(d, dtype=dtype, device=device)}


def rope_freqs(theta: float, rotary_dim: int, device) -> torch.Tensor:
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=device) / rotary_dim
    return 1.0 / (theta ** exps)                          # (rd/2,)


def apply_rope(x, positions, theta: float, variant: str = "full"):
    """x: (..., S, H, D), positions (..., S). 'half' rotates only the
    first D/2 dims (GLM's 2-D RoPE)."""
    if variant == "none":
        return x
    D = x.shape[-1]
    rd = D // 2 if variant == "half" else D
    inv = rope_freqs(theta, rd, x.device)
    ang = positions[..., None].float() * inv              # (..., S, rd/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, rd/2)
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr[..., :rd // 2], xr[..., rd // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot, x[..., rd:].float()], dim=-1).to(x.dtype)


def he_init(gen: torch.Generator, shape, dtype, device, fan_in=None):
    fan = fan_in if fan_in is not None else shape[0]
    # scaled in place: one fp32 copy of the draw at a time
    w = torch.randn(shape, generator=gen, device=device).mul_(
        (2.0 / fan) ** 0.5)
    return w.to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)
