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
``MIN_SIZE`` is applied to the size of the whole stack as in JAX.

Each quantized leaf is packed ONCE, here, into the kernel layout
(:class:`~repro_torch.kernels.ops.PackedWeight`). Methods: ``splitquant``
(the paper), ``baseline`` (one min/max range), ``percentile`` (one
clipped range, the outlier treatment the paper argues against) and, as a
per-path override, ``none``. Per-path overrides and ``report["per_path"]``
use the JAX package's paths, where the layer stack is one leaf
(``layers/attn/wq``): an override applies to that leaf of every layer.
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


def quantize_tree(params, policy: QuantPolicy, seed: int = 0,
                  overrides: Optional[dict] = None):
    """Return a copy of ``params`` with quantizable leaves replaced by
    packed SplitQuant weights, plus a report dict. The k-means seeding of
    each leaf draws from a ``torch.Generator`` seeded with ``seed`` plus
    the leaf's index, on the leaf's device.

    ``overrides``: ``{path: {bits|k|method|percentile: ...}}`` on top of
    ``policy``, keyed by the JAX package's lowercase paths (module doc);
    a path that matches no quantizable leaf raises. ``report["per_path"]``
    gives each such path's bits, k, method and deployed bytes (summed
    over the layers); bytes are counted as the JAX package counts them
    (:meth:`SplitQuantTensor.nbytes_deployed`)."""
    out = _copy_tree(params)
    report = {"quantized": [], "skipped": [], "deployed_bytes": 0,
              "orig_bytes": 0, "per_path": {}}
    overrides = dict(overrides or {})
    unused = set(overrides)
    for i, (path_s, jpath, box, key, leaf, stack) in enumerate(
            _walk(out, (), 1)):
        if not _quantizable(path_s, leaf, stack):
            report["skipped"].append(path_s)
            continue
        eff = resolve_policy(policy, overrides.get(jpath))
        unused.discard(jpath)
        if eff.method == "none":
            report["skipped"].append(path_s)
            continue
        if leaf.ndim != 2:
            raise NotImplementedError(f"{path_s}: only 2-D weights are "
                                      f"packed for the kernel (quantized "
                                      f"biases are not ported)")
        if eff.method == "splitquant":
            gen = torch.Generator(device=leaf.device).manual_seed(seed + i)
            sq = splitquant_tensor(gen, leaf, eff.cfg, k=eff.k)
        elif eff.method in ("baseline", "percentile"):
            sq = baseline_quant_tensor(leaf, eff.cfg)
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
    if unused:
        raise ValueError(f"overrides matched no quantizable leaf: "
                         f"{sorted(unused)}")
    return out, report


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
