"""Feed-forward layers (port of ``repro.models.ffn``): swiglu, geglu,
gelu, and the sort-based dropping MoE layer.

MoE (:func:`apply_moe`) keeps the JAX package's semantics: fp32 router,
softmax, top-k with the gates renormalized, the Switch auxiliary loss,
and per block of ``Tb`` tokens a capacity C (``Tb`` when ``Tb <= 512``,
so decode and prefill chunks never drop; else ``Tb·K·cf // E``) with each
token→expert pair's position in its expert from a stable sort by expert
id, pairs at ``pos >= C`` dropped. Two ways to compute the experts:

* on the CPU, JAX's literal form: the pairs scattered into a dense
  (E, C, d) buffer per block, every expert stack dequantized
  (eq. 4, ``materialize``) and an einsum over the buffer;
* on the card with packed experts, the grouped SplitQuant matmul: the
  pairs sorted by expert (offsets computed on the card), one grouped
  launch per projection (gate, up, down) that reads only the packed codes
  of the experts that got rows, and the outputs put back in pair order.
  No expert stack is dequantized (``EXPERT_DEQUANTIZATIONS`` counts the
  stacks the literal form dequantizes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ops import PackedWeight, grouped_linear
from .common import dense, he_init

#: expert stacks dequantized whole (the literal form) in this process
EXPERT_DEQUANTIZATIONS = 0


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


# -------------------------------------------------------------------- MoE --
def init_moe(gen, cfg, dtype, device, put=None):
    """A MoE layer at the JAX package's shapes and scales: an fp32 router
    (d, E), expert stacks (E, d, f) / (E, f, d), and the shared experts as
    one swiglu FFN of width ``f · n_shared_experts``. ``put(name, part)``,
    when given, takes each entry as soon as it is drawn and returns what
    stands in its place (the part-by-part quantized build hands each
    expert stack to the quantizer before the next is drawn)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    put = put or (lambda name, part: part)
    p = {"router": put("router", he_init(gen, (d, E), torch.float32,
                                         device))}
    for name, shape, fan in (("w_gate", (E, d, f), None),
                             ("w_up", (E, d, f), None),
                             ("w_down", (E, f, d), f)):
        p[name] = put(name, expert_stack(gen, shape, dtype, device, fan))
    if cfg.n_shared_experts:
        p["shared"] = put("shared", init_ffn(
            gen, d, f * cfg.n_shared_experts, "swiglu", dtype, device))
    return p


def expert_stack(gen, shape, dtype, device, fan_in=None):
    """He-init of an (E, ·, ·) expert stack, fan E unless given (as the
    JAX package's ``init_moe``), drawn one matrix at a time into the
    stack's dtype: the fp32 draw of a whole stack (22.5 GB for one of
    kimi-k2-1t-a32b's) never exists."""
    std = (2.0 / (fan_in if fan_in is not None else shape[0])) ** 0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        out[e] = torch.randn(shape[1:], generator=gen,
                             device=device).mul_(std)
    return out


def route(p, xt, cfg):
    """Router of a MoE layer over tokens xt (T, d): (probs (T, E) fp32,
    gates (T, K) in xt's dtype, renormalized, expert ids (T, K))."""
    logits = dense(xt.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = (gate / gate.sum(-1, keepdim=True)).to(xt.dtype)
    return probs, gate, eidx


def routing_margin(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The smallest gap between a token's k-th and (k+1)-th router
    probability over probs (T, E), a 0-d tensor on probs' device. A small
    margin is where a last-bit difference in the logits can swap an
    expert."""
    top = torch.topk(probs, k + 1, dim=-1).values
    return (top[:, -2] - top[:, -1]).min()


def positions_in_expert(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Each pair's position among its block's pairs routed to the same
    expert, in pair order (a stable sort by expert id). flat_e
    (n_blocks, Tb·K) → (n_blocks, Tb·K)."""
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=flat_e.device).expand(
        flat_e.shape[0], E).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts)
    pos_sorted = torch.arange(flat_e.shape[1], device=flat_e.device) - \
        torch.gather(seg_start, 1, sorted_e)
    return torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)


def dispatch(eidx: torch.Tensor, n_blocks: int, E: int, C: int):
    """The token→expert pairs of ``eidx`` (T, K) in ``n_blocks`` blocks:
    (flat_e (n_blocks, Tb·K) each pair's expert, pos its position among
    its block's pairs routed there, keep whether pos < C; the pairs past
    the capacity C drop)."""
    flat_e = eidx.reshape(n_blocks, -1)
    pos = positions_in_expert(flat_e, E)
    return flat_e, pos, pos < C


def _materialize(w, dtype):
    global EXPERT_DEQUANTIZATIONS
    if isinstance(w, PackedWeight):
        EXPERT_DEQUANTIZATIONS += 1
        w = w.dequantize()
    return w.to(dtype)


def _experts_literal(p, xt, flat_e, pos, C, n_blocks, E, K):
    """JAX's form: pairs scattered into (n_blocks, E, C, d), every expert
    stack dequantized, einsums over the buffer, each pair's output read
    back (a dropped pair reads row C-1, weighted 0). → (T·K, d)."""
    T, d = xt.shape
    Tb = T // n_blocks
    keep = pos < C
    safe_pos = torch.where(keep, pos, C - 1)
    src = xt.reshape(n_blocks, Tb, d).repeat_interleave(K, dim=1)
    blk = torch.arange(n_blocks, device=xt.device)[:, None].expand_as(
        flat_e)
    buf = torch.zeros((n_blocks, E, C, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((blk, flat_e, safe_pos),
                   torch.where(keep[..., None], src, 0), accumulate=True)
    bufe = buf.transpose(0, 1)                           # (E, nb, C, d)
    wg = _materialize(p["w_gate"], xt.dtype)
    wu = _materialize(p["w_up"], xt.dtype)
    wd = _materialize(p["w_down"], xt.dtype)
    h = torch.einsum("encd,edf->encf", bufe, wg)
    u = torch.einsum("encd,edf->encf", bufe, wu)
    y = torch.einsum("encf,efd->encd", F.silu(h) * u, wd).transpose(0, 1)
    return y[blk, flat_e, safe_pos].reshape(T * K, d)


def _experts_grouped(p, xt, flat_e, E, K):
    """The card's form: the T·K pairs sorted by expert, the offsets of
    each expert's rows from a search of the sorted ids (on the card),
    three grouped launches, the outputs put back in pair order. Every
    pair is computed (a dropped one is weighted 0). → (T·K, d)."""
    flat = flat_e.reshape(-1)
    order = torch.argsort(flat, stable=True)
    offsets = torch.searchsorted(
        flat[order], torch.arange(E + 1, device=xt.device)).to(torch.int32)
    xs = xt[order // K]
    h = grouped_linear(xs, offsets, p["w_gate"])
    u = grouped_linear(xs, offsets, p["w_up"])
    y = grouped_linear(F.silu(h) * u, offsets, p["w_down"])
    out = torch.empty_like(y)
    out[order] = y
    return out


def apply_moe(p, x, cfg, capacity_factor: float | None = None,
              n_blocks: int = 1):
    """x: (B, S, d) → (out (B, S, d), aux loss). ``n_blocks``: dispatch
    blocks (capacity and positions are per block; ``T`` not divisible by
    it falls back to one block, as in JAX)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    if n_blocks > 1 and T % n_blocks != 0:
        n_blocks = 1
    Tb = T // n_blocks
    cf = capacity_factor or cfg.capacity_factor
    # Tb <= 512 (decode, chunks): capacity Tb, so no pair is dropped
    C = Tb if Tb <= 512 else max(1, int(Tb * K * cf) // E)

    xt = x.reshape(T, d)
    probs, gate, eidx = route(p, xt, cfg)
    # load-balancing aux loss (Switch): E · Σ_e f_e · p_e
    me = F.one_hot(eidx[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * probs.mean(0))

    flat_e, pos, keep = dispatch(eidx, n_blocks, E, C)
    if x.device.type == "cuda" and isinstance(p["w_gate"], PackedWeight):
        y = _experts_grouped(p, xt, flat_e, E, K)
    else:
        y = _experts_literal(p, xt, flat_e, pos, C, n_blocks, E, K)
    w = torch.where(keep.reshape(-1), gate.reshape(-1), 0).to(x.dtype)
    out = (y * w[:, None]).reshape(T, K, d).sum(1)
    if "shared" in p:
        out = out + apply_ffn(p["shared"], xt, "swiglu")
    return out.reshape(B, S, d), aux
