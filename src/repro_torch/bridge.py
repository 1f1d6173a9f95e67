"""Load the JAX package's parameters into the port.

Input: the JAX parameter tree as nested dicts of numpy arrays, with each
``SplitQuantTensor`` given as a dict ``{q, cid, scale, zero, bits, k,
orig_shape}`` (scales per tensor (k,) or per output column (k, out)) and
the layer stacks as ``(L, …)`` leaves under one of
:data:`~repro_torch.tree.STACK_FRAGMENTS` (``layers``, a MoE model's
``moe_layers``, griffin's ``groups`` and ``tail``, whisper's
``enc_layers`` and ``dec_layers``). Output: the port's tree — the same names, each
stack as a list of per-layer dicts, every quantized matrix packed for
the kernel and every quantized bias (``orig_shape`` of one axis) kept as
a :class:`SplitQuantTensor`, which ``dense`` dequantizes. A quantized
2-D leaf that is no matrix product (griffin's depthwise ``conv_w``) is
packed too; the model reads it through ``materialize``, whose
``PackedWeight.dequantize`` gives JAX's ``dequantize`` exactly. A MoE layer's expert leaf (L, E, d, f), with scales
(L, E, k[, f]), becomes one stacked packed weight (E, d, f) a layer. The
caller flattens JAX arrays to numpy; this module imports neither ``jax``
nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .tree import STACK_FRAGMENTS, tree_to
from .device import resolve_device
from .core.splitquant import SplitQuantTensor
from .kernels.ops import pack_for_kernel

_SQT_KEYS = {"q", "cid", "scale", "zero", "bits", "k", "orig_shape"}


def _is_sqt(node) -> bool:
    return isinstance(node, dict) and _SQT_KEYS <= set(node)


def _leaf(node, dtype):
    if _is_sqt(node):
        sd = len(node["q"].shape) - len(node["orig_shape"])
        if sd > 1 or tuple(node["q"].shape[sd:]) != \
                tuple(node["orig_shape"]):
            raise ValueError(f"stacked leaf {node['q'].shape} reached a "
                             f"per-layer slot")
        sqt = SplitQuantTensor(
            q=torch.from_numpy(np.array(node["q"], np.int8)),
            cid=torch.from_numpy(np.array(node["cid"], np.uint8)),
            scale=torch.from_numpy(np.array(node["scale"], np.float32)),
            zero=torch.from_numpy(np.array(node["zero"], np.float32)),
            bits=int(node["bits"]), k=int(node["k"]), orig_dtype=dtype,
            stack_dims=sd)
        return sqt if len(node["orig_shape"]) == 1 else pack_for_kernel(sqt)
    return torch.from_numpy(np.array(node))


def _convert(node, dtype):
    if isinstance(node, dict) and not _is_sqt(node):
        return {k: _convert(v, dtype) for k, v in node.items()}
    return _leaf(node, dtype)


def _unstack(node, i):
    """Layer ``i`` of a stacked subtree."""
    if _is_sqt(node):
        return {**node, "q": node["q"][i], "cid": node["cid"][i],
                "scale": node["scale"][i], "zero": node["zero"][i]}
    if isinstance(node, dict):
        return {k: _unstack(v, i) for k, v in node.items()}
    return node[i]


def _n_layers(node) -> int:
    if _is_sqt(node):
        return node["q"].shape[0]
    if isinstance(node, dict):
        return _n_layers(next(iter(node.values())))
    return node.shape[0]


def from_jax_tree(tree: dict, dtype=torch.float32, device=None) -> dict:
    """Convert a numpy-flattened JAX parameter tree (see module doc) into
    the port's parameters on ``device`` (the card unless
    ``device="cpu"``). ``dtype`` is the original parameter dtype that
    dequantization returns."""
    out = {}
    for key, node in tree.items():
        if key in STACK_FRAGMENTS:
            out[key] = [_convert(_unstack(node, i), dtype)
                        for i in range(_n_layers(node))]
        else:
            out[key] = _convert(node, dtype)
    return tree_to(out, resolve_device(device))
