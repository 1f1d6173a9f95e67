"""Model-level SplitQuant application (port of ``repro.core.apply``): walk
a parameter tree and replace quantizable weights with packed SplitQuant
weights.

Same rules as the JAX package's defaults: normalization scales and other
"semantically not weights" parameters (the exclude list) and embedding
tables are never quantized, and tiny parameters (fewer than
``MIN_SIZE`` elements) are left alone. Quantized biases (1-D) are not
ported yet and raise. The JAX package stacks the layers on a leading
axis and quantizes each layer's slice on its own; the port's layer stack
is a Python list, so each leaf already is one layer's matrix, and
``MIN_SIZE`` is applied to the size of the whole stack as in JAX. A MoE
layer's expert leaf (E, d, f) is E matrices, each clustered and quantized
on its own (the JAX package's ``infer_stack_dims`` = 2 over its
(L, E, d, f) leaf), into one stacked packed weight; the k-means of the E
matrices runs as one batched pass. The router stays fp32.

Each quantized leaf is packed ONCE, here, into the kernel layout
(:class:`~repro_torch.kernels.ops.PackedWeight`). Methods: ``splitquant``
(the paper), ``baseline`` (one min/max range), ``percentile`` (one
clipped range, the outlier treatment the paper argues against) and, as a
per-path override, ``none``. Per-path overrides and ``report["per_path"]``
use the JAX package's paths, where the layer stack is one leaf
(``layers/attn/wq``, ``moe_layers/moe/w_gate``): an override applies to
that leaf of every layer.

:class:`LeafQuantizer` is the per-leaf step with its running leaf index
(the k-means seed); ``launch.serve.build_params`` feeds it one layer at a
time while ``transformer.init`` builds the tree, so a model whose bf16
tree and packed tree would not fit on the card together is built with
the same packed bytes as ``quantize_tree(init(...))``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.ops import PackedWeight, pack_for_kernel
from .quantize import QuantConfig
from .splitquant import baseline_quant_tensor, splitquant_tensor

#: parameter-path fragments that are never quantized
DEFAULT_EXCLUDE = (
    "norm", "ln_", "layernorm", "rmsnorm", "scale_param",
    "decay", "gate_a", "rg_lru", "time_", "alibi", "rope",
    "router",
)

#: path fragments marking stacked per-layer parameter groups
STACK_FRAGMENTS = ("layers", "moe_layers", "groups", "tail",
                   "enc_layers", "dec_layers")

#: leave tiny parameters alone
MIN_SIZE = 64

#: embedding tables are never quantized
TABLE_FRAGMENTS = ("embed", "pos_table", "enc_pos", "dec_pos")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """What to quantize and how."""

    cfg: QuantConfig = QuantConfig(bits=8)
    method: str = "splitquant"          # "splitquant" | "baseline" |
                                        # "percentile" | "none"
    k: int = 3                          # number of split layers (paper: 3)

    def replace(self, **kw) -> "QuantPolicy":
        return dataclasses.replace(self, **kw)


#: the clip of method="percentile" when the policy sets no percentile
#: (paper §1: "often 99% is used in practice")
DEFAULT_PERCENTILE = 0.99

#: per-path override keys a calibration recipe may carry
OVERRIDE_KEYS = ("bits", "k", "method", "percentile")


def resolve_policy(policy: QuantPolicy, override: Optional[dict] = None
                   ) -> QuantPolicy:
    """The effective policy of one leaf: a per-path override (bits / k /
    method / percentile) applied, then the method's percentile rule:
    ``baseline`` never clips, ``percentile`` always clips (at
    :data:`DEFAULT_PERCENTILE` when unset), ``splitquant`` takes
    ``cfg.percentile`` as given."""
    if override:
        unknown = set(override) - set(OVERRIDE_KEYS)
        if unknown:
            raise ValueError(f"unknown override keys {sorted(unknown)}")
        cfg_kw = {kk: override[kk] for kk in ("bits", "percentile")
                  if kk in override}
        pol_kw = {kk: override[kk] for kk in ("method", "k")
                  if kk in override}
        policy = policy.replace(
            cfg=dataclasses.replace(policy.cfg, **cfg_kw), **pol_kw)
    if policy.method == "baseline":
        policy = policy.replace(
            cfg=dataclasses.replace(policy.cfg, percentile=None))
    elif policy.method == "percentile":
        pct = (policy.cfg.percentile if policy.cfg.percentile is not None
               else DEFAULT_PERCENTILE)
        policy = policy.replace(
            cfg=dataclasses.replace(policy.cfg, percentile=pct))
    return policy


def _quantizable(path_s: str, leaf, stack: int) -> bool:
    if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
        return False
    if leaf.numel() * stack < MIN_SIZE or leaf.ndim == 0:
        return False
    return not any(frag in path_s
                   for frag in DEFAULT_EXCLUDE + TABLE_FRAGMENTS)


def _walk(tree, path, stack, jpath=()):
    """Yield (path string, the JAX package's path string, container, key,
    leaf, stack size); the JAX path leaves out the index into a layer
    stack."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    stacked = isinstance(tree, list) and path and path[-1] in STACK_FRAGMENTS
    for key, val in items:
        p = path + (str(key),)
        jp = jpath if stacked else jpath + (str(key),)
        if isinstance(val, (dict, list)):
            inner = stack
            if isinstance(val, list) and str(key) in STACK_FRAGMENTS:
                inner = stack * len(val)
            yield from _walk(val, p, inner, jp)
        else:
            yield ("/".join(p).lower(), "/".join(jp).lower(), tree, key, val,
                   stack)


class LeafQuantizer:
    """Quantize the leaves of a tree in place, in :func:`quantize_tree`'s
    walk order: the i-th leaf walked (quantizable or not) draws its
    k-means seeding from a ``torch.Generator`` seeded ``seed + i`` on the
    leaf's device. ``report`` is :func:`quantize_tree`'s report."""

    def __init__(self, policy: QuantPolicy, seed: int = 0,
                 overrides: Optional[dict] = None):
        self.policy, self.seed = policy, seed
        self.overrides = dict(overrides or {})
        self.i = 0
        self.report = {"quantized": [], "skipped": [], "deployed_bytes": 0,
                       "orig_bytes": 0, "per_path": {}}

    def walk(self, tree, path=(), stack: int = 1, jpath=()) -> None:
        """Quantize every quantizable leaf of ``tree`` (a dict or list) in
        place; ``path``/``jpath`` prefix its paths and ``stack`` is the
        depth of the layer stack it lies in."""
        for path_s, jp, box, key, leaf, st in _walk(tree, path, stack,
                                                     jpath):
            self._leaf(path_s, jp, box, key, leaf, st)
            self.i += 1

    def part(self, path: tuple, part, stack: int):
        """The hook of ``transformer.init(on_part=)``: quantize one part of
        a tree being built, in the tree's order: a top-level entry (path
        ``(key,)``) or one layer of a stack (path ``(key, index)``,
        ``stack`` the stack's depth). Returns the part quantized."""
        if len(path) == 1:
            box = {path[0]: part}
            self.walk(box)
            return box[path[0]]
        self.walk(part, tuple(map(str, path)), stack, (path[0],))
        return part

    def _leaf(self, path_s, jpath, box, key, leaf, stack) -> None:
        report = self.report
        if not _quantizable(path_s, leaf, stack):
            report["skipped"].append(path_s)
            return
        eff = resolve_policy(self.policy, self.overrides.get(jpath))
        if eff.method == "none":
            report["skipped"].append(path_s)
            return
        if leaf.ndim not in (2, 3):
            raise NotImplementedError(f"{path_s}: only 2-D weights and "
                                      f"stacks of them (a MoE layer's "
                                      f"experts) are packed for the kernel "
                                      f"(quantized biases are not ported)")
        sd = leaf.ndim - 2
        if eff.method == "splitquant":
            gen = torch.Generator(device=leaf.device).manual_seed(
                self.seed + self.i)
            sq = splitquant_tensor(gen, leaf, eff.cfg, k=eff.k,
                                   stack_dims=sd)
        elif eff.method in ("baseline", "percentile"):
            sq = baseline_quant_tensor(leaf, eff.cfg, stack_dims=sd)
        else:
            raise ValueError(f"unknown method {eff.method!r}")
        box[key] = pack_for_kernel(sq)
        report["quantized"].append(path_s)
        entry = report["per_path"].setdefault(
            jpath, {"bits": eff.cfg.bits, "k": sq.k, "method": eff.method,
                    "bytes": 0})
        # the JAX package's count (codes, 2-bit cids when k > 1, scales),
        # not the kernel layout's (PackedWeight.nbytes_packed)
        entry["bytes"] += sq.nbytes_deployed()
        report["deployed_bytes"] += sq.nbytes_deployed()
        report["orig_bytes"] += leaf.numel() * 4


def quantize_tree(params, policy: QuantPolicy, seed: int = 0,
                  overrides: Optional[dict] = None):
    """Return a copy of ``params`` with quantizable leaves replaced by
    packed SplitQuant weights, plus a report dict. The k-means seeding of
    each leaf draws from a ``torch.Generator`` seeded with ``seed`` plus
    the leaf's index, on the leaf's device.

    ``overrides``: ``{path: {bits|k|method|percentile: ...}}`` on top of
    ``policy``, keyed by the JAX package's lowercase paths (module doc);
    a path that matches no quantizable leaf raises before anything is
    quantized. ``report["per_path"]`` gives each such path's bits, k,
    method and deployed bytes (summed over the layers); bytes are counted
    as the JAX package counts them
    (:meth:`SplitQuantTensor.nbytes_deployed`)."""
    out = _copy_tree(params)
    found = {jp for path_s, jp, _, _, leaf, stack in _walk(out, (), 1)
             if _quantizable(path_s, leaf, stack)}
    unused = set(overrides or {}) - found
    if unused:
        raise ValueError(f"overrides matched no quantizable leaf: "
                         f"{sorted(unused)}")
    q = LeafQuantizer(policy, seed, overrides)
    q.walk(out)
    return out, q.report


def dequantize_tree(params):
    """Replace every packed weight with its dequantized dense tensor."""
    out = _copy_tree(params)
    for _, _, box, key, leaf, _ in _walk(out, (), 1):
        if isinstance(leaf, PackedWeight):
            box[key] = leaf.dequantize()
    return out


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def tree_to(params, device):
    """Move every tensor and packed weight of a tree to ``device``."""
    if isinstance(params, dict):
        return {k: tree_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [tree_to(v, device) for v in params]
    return params.to(device)
