"""Per-group quantization sensitivity on a calibration batch (port of
``repro.calib.sensitivity``).

For each quantizable group (one JAX path such as ``layers/attn/wq``: that
leaf of every layer, each layer quantized on its own, as the JAX
package's ``stack_dims`` vmap does) and each candidate bit-width, quantize
ONLY that group, run the model on the calibration batch, and score the
damage against the unquantized logits:

    mse = E[(z_q - z_fp)²]          kl = E[KL(softmax z_fp ‖ softmax z_q)]

The perturbed tree holds the group dequantized to its leaves' dtype and
everything else as given, so the evaluation runs no quantized kernel. The
table also records each group's deployed bytes per bit-width, counted as
the JAX package counts them, which is what
:mod:`repro_torch.calib.allocate` trades against a byte budget.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.apply import (QuantPolicy, _copy_tree, _quantizable, _walk,
                          resolve_policy)
from ..core.splitquant import baseline_quant_tensor, splitquant_tensor


def quantizable_groups(params,
                       is_quantizable: Optional[Callable] = None) -> list:
    """[(JAX path, [(container, key, leaf) of each layer])] of the
    quantizable leaves of ``params``, in the JAX package's flatten order
    (the paths that ``quantize_tree`` reports and overrides take).
    ``is_quantizable(path, leaf, stack)`` replaces ``quantize_tree``'s
    rule (``path`` with the layer index, ``stack`` the layer count)."""
    rule = is_quantizable or _quantizable
    groups: dict = {}
    for path_s, jpath, box, key, leaf, stack in _walk(params, (), 1):
        if rule(path_s, leaf, stack):
            groups.setdefault(jpath, []).append((box, key, leaf))
    return sorted(groups.items(), key=lambda g: g[0].split("/"))


def _kl(logp_ref, logp_q):
    """Mean KL(ref ‖ q) over rows from log-probs (..., n_classes)."""
    return (logp_ref.exp() * (logp_ref - logp_q)).sum(-1).mean()


@torch.no_grad()
def layer_sensitivity(seed: int, cfg, params, forward_fn: Callable,
                      calib_batch: dict, *,
                      policy: Optional[QuantPolicy] = None,
                      bits_list=(2, 4, 8),
                      is_quantizable: Optional[Callable] = None) -> dict:
    """Sensitivity table {path: {"orig_bytes", "size", "per_bits":
    {bits: {"mse", "kl", "bytes"}}}} of the dense tree ``params``.

    ``forward_fn(params, batch) -> logits``; ``calib_batch`` maps names to
    arrays, moved to the device the parameters live on. ``policy`` fixes
    method and k (default: the paper's splitquant, k=3). The k-means of
    group g draws from a ``torch.Generator`` seeded ``seed + g`` for each
    bit-width, on the leaves' device, one layer after another."""
    policy = policy or QuantPolicy()
    tree = _copy_tree(params)                # boxes to perturb; params kept
    groups = quantizable_groups(tree, is_quantizable)
    if not groups:
        return {}
    device = groups[0][1][0][2].device
    batch = {k: torch.as_tensor(np.asarray(v)).to(device)
             for k, v in calib_batch.items()}
    logits_fp = forward_fn(tree, batch).float()
    logp_fp = torch.log_softmax(logits_fp, dim=-1)
    table = {}
    for g, (path, members) in enumerate(groups):
        size = sum(leaf.numel() for _, _, leaf in members)
        row = {"orig_bytes": int(size * 4), "size": int(size),
               "per_bits": {}}
        for bits in bits_list:
            eff = resolve_policy(policy.replace(
                cfg=dataclasses.replace(policy.cfg, bits=bits)))
            gen = torch.Generator(device=device).manual_seed(seed + g)
            nbytes = 0
            for box, key, leaf in members:
                if eff.method == "splitquant":
                    sq = splitquant_tensor(gen, leaf, eff.cfg, k=eff.k)
                else:
                    sq = baseline_quant_tensor(leaf, eff.cfg)
                box[key] = sq.dequantize().to(leaf.dtype)
                nbytes += sq.nbytes_deployed()
            logits_q = forward_fn(tree, batch).float()
            for box, key, leaf in members:
                box[key] = leaf
            logp_q = torch.log_softmax(logits_q, dim=-1)
            row["per_bits"][int(bits)] = {
                "mse": float(((logits_q - logits_fp) ** 2).mean()),
                "kl": float(_kl(logp_fp, logp_q)),
                "bytes": int(nbytes),
            }
        table[path] = row
    return table


def sensitivity_summary(table: dict, bits: int = 2) -> list:
    """[(path, kl)] sorted most-sensitive-first at the probe bit-width:
    the human-readable ranking for logs and the recipe's provenance."""
    rows = [(p, r["per_bits"][bits]["kl"]) for p, r in table.items()
            if bits in r["per_bits"]]
    return sorted(rows, key=lambda t: -t[1])
