"""Dense feed-forward layers (port of ``repro.models.ffn``: swiglu, geglu,
gelu; the MoE layer is not ported yet)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense, he_init


def init_ffn(gen, d_model: int, d_ff: int, ffn_type: str, dtype, device,
             bias=False):
    if ffn_type in ("swiglu", "geglu"):
        return {"w_gate": he_init(gen, (d_model, d_ff), dtype, device),
                "w_up": he_init(gen, (d_model, d_ff), dtype, device),
                "w_down": he_init(gen, (d_ff, d_model), dtype, device,
                                  fan_in=d_ff)}
    p = {"w_up": he_init(gen, (d_model, d_ff), dtype, device),
         "w_down": he_init(gen, (d_ff, d_model), dtype, device, fan_in=d_ff)}
    if bias:
        p["b_up"] = torch.zeros(d_ff, dtype=dtype, device=device)
        p["b_down"] = torch.zeros(d_model, dtype=dtype, device=device)
    return p


def apply_ffn(p, x, ffn_type: str):
    # jax.nn.gelu defaults to the tanh approximation
    if ffn_type == "swiglu":
        return dense(F.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"]),
                     p["w_down"])
    if ffn_type == "geglu":
        return dense(F.gelu(dense(x, p["w_gate"]), approximate="tanh")
                     * dense(x, p["w_up"]), p["w_down"])
    h = F.gelu(dense(x, p["w_up"], p.get("b_up")), approximate="tanh")
    return dense(h, p["w_down"], p.get("b_down"))
