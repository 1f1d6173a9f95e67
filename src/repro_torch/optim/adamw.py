"""AdamW with configurable state dtypes, global-norm clipping and optional
int8 gradient compression with error feedback (port of
``repro.optim.adamw``).

The JAX package computes all of it in jnp, outside any Pallas kernel, so
the port's is plain PyTorch, leaf by leaf, on the device the parameters
live on. Every scalar is an fp32 tensor on that device, as JAX's weak
typed Python floats are fp32 there: ``lr``, ``b1 ** t``, the clip factor
and ``127 / amax`` are fp32 operations, and divisions are tensor by
tensor (a Python float over a tensor is a reciprocal times the float in
torch, and a CUDA tensor over a CPU scalar is too). Each formula keeps
JAX's order of operations; XLA's CPU code may contract a product and a
sum into one FMA, so single steps agree with JAX to an ulp or so.

Trees are nested dicts, lists (the layer stacks) and tuples of tensors;
the moments mirror the parameter tree (walked by :mod:`repro_torch.tree`,
in the JAX package's flatten order). Where JAX
holds a layer stack as one ``(L, …)`` leaf, the port holds L leaves: the
int8 compression takes one range for all L of them, as JAX's one range
for the stacked leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..tree import STACK_FRAGMENTS, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"      # "float32" | "bfloat16"
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    grad_compress: Optional[str] = None   # None | "int8"


class OptState(NamedTuple):
    step: torch.Tensor                # () int32
    m: dict
    v: dict
    err: Optional[dict]               # error-feedback residual (compression)


def _state_dtype(cfg: OptConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def _f32(x: float, device) -> torch.Tensor:
    """A Python float as an fp32 scalar on ``device``."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def init(cfg: OptConfig, params) -> OptState:
    """Zero moments (and error residuals with compression) of the state
    dtype, on each parameter's device."""
    dt = _state_dtype(cfg)
    zeros = lambda: tree_map(
        lambda x: torch.zeros(x.shape, dtype=dt, device=x.device), params)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=zeros(), v=zeros(),
                    err=zeros() if cfg.grad_compress else None)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to min_lr_frac · lr (fp32)."""
    dev = step.device
    step = step.float()
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1), dev),
                         _f32(1.0, dev))
    prog = torch.clamp((step - _f32(cfg.warmup_steps, dev)) /
                       _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                            dev), 0, 1)
    cos = _f32(0.5, dev) * (_f32(1.0, dev) + torch.cos(_f32(math.pi, dev)
                                                       * prog))
    frac = _f32(cfg.min_lr_frac, dev) + _f32(1 - cfg.min_lr_frac, dev) * cos
    return _f32(cfg.lr, dev) * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in fp32."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _amax(g: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(g.float() + err.float()))


def compress_int8(g: torch.Tensor, err: torch.Tensor, amax=None):
    """Symmetric per-tensor int8 quantization with error feedback: returns
    (the decompressed gradient in g's dtype, the new residual in err's).
    The codes are rint(gf · 127 / amax) clipped to ±127, gf = g + err;
    ``amax`` (max |gf| + 1e-12) is gf's own unless given (a range shared
    by the leaves of a layer stack)."""
    gf = g.float() + err.float()
    if amax is None:
        amax = _amax(g, err) + _f32(1e-12, g.device)
    scale = _f32(127.0, g.device) / amax
    q = torch.clamp(torch.round(gf * scale), -127, 127)
    deq = q / scale
    return deq.to(g.dtype), (gf - deq).to(err.dtype)


def _compress_tree(grads, err, parent=None):
    """:func:`compress_int8` over a tree, one range a JAX leaf: a layer
    stack's L leaves at one path share theirs. Returns the tree of
    (decompressed, residual) pairs."""
    if isinstance(grads, dict):
        return {k: _compress_tree(grads[k], err[k], k) for k in grads}
    if isinstance(grads, list) and parent in STACK_FRAGMENTS:
        n = len(grads)
        amax = tree_map(lambda *ge: torch.stack(
            [_amax(g, e) for g, e in zip(ge[:n], ge[n:])]).max() +
            _f32(1e-12, ge[0].device), grads[0], *grads[1:], *err)
        return [tree_map(compress_int8, g, e, amax)
                for g, e in zip(grads, err)]
    if isinstance(grads, (list, tuple)):
        return [_compress_tree(g, e) for g, e in zip(grads, err)]
    return compress_int8(grads, err)


def _part(out, i: int, like):
    """The i-th of the tuples at the leaves of ``out`` (``like``'s
    structure)."""
    return tree_map(lambda _, o: o[i], like, out)


@torch.no_grad()
def update(cfg: OptConfig, state: OptState, params, grads):
    """One AdamW step: returns (new_params, new_state, {"grad_norm",
    "lr"}). ``grads`` mirrors ``params``.

    The moments are updated in place (``new_state.m`` and ``.v`` are
    ``state``'s tensors; the params are new tensors): the caller holds
    the old state through the step, and old and new fp32 moments together
    take 8 bytes a parameter more, which at rwkv6-3b's 3.1 B parameters
    does not fit one 80 GB card beside the parameters and gradients. A
    failure inside the update leaves them partly updated:
    ``train_loop.run`` then restores the last checkpoint, or raises where
    there is none."""
    dev = state.step.device
    step = state.step + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm:
        factor = torch.minimum(_f32(1.0, dev), _f32(cfg.clip_norm, dev) /
                               (gnorm + _f32(1e-9, dev)))
        # fp32, as JAX promotes a bf16 gradient times an fp32 factor
        grads = tree_map(lambda g: g.float() * factor, grads)

    new_err = state.err
    if cfg.grad_compress == "int8":
        pairs = _compress_tree(grads, state.err)
        grads, new_err = _part(pairs, 0, params), _part(pairs, 1, params)

    lr = schedule(cfg, step)
    t = step.float()
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    c1, c2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    one = _f32(1.0, dev)
    bc1 = one - b1 ** t
    bc2 = one - b2 ** t
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)

    def upd(p, g, m, v):
        gf = g.float()
        mf = b1 * m.float() + c1 * gf
        vf = b2 * v.float() + c2 * gf * gf
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.float()
        new_p = p.float() - lr * delta
        m.copy_(mf)
        v.copy_(vf)
        return new_p.to(p.dtype)

    new_params = tree_map(upd, params, grads, state.m, state.v)
    return (new_params, OptState(step, state.m, state.v, new_err),
            {"grad_norm": gnorm, "lr": lr})
