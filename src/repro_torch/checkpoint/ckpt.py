"""Atomic, optionally asynchronous checkpoints in the JAX package's format
(port of ``repro.checkpoint.ckpt``), so each package restores what the
other saved.

On disk: ``<dir>/step_<N:08d>/arrays.npz`` plus ``manifest.json`` (step,
a description of the tree, keys, shapes, dtypes, ``quant_meta`` and CRC32
``checksums``). Keys are JAX's ``keystr`` paths: ``['layers']['attn']
['wq'].q``, ``['lm_head'].scale``, ``['layers']['ln1']['norm_scale']``;
a tuple index is ``[i]``. The port holds the layer stack as a list of
per-layer dicts; on disk, as in JAX, every leaf under ``layers`` (any
list under a stack fragment) is stacked along a leading L axis, the MoE
family's two stacks (``layers`` and ``moe_layers``) each on its own.

A quantized leaf (:class:`~repro_torch.kernels.ops.PackedWeight`) is
saved unpacked: ``.q`` int8 and ``.cid`` uint8 codes of the original
shape, ``.scale``/``.zero`` of shape (k,) or (k, N), with ``quant_meta``
{bits, k, orig_shape, orig_dtype}. A MoE layer's stacked experts keep E
in front: ``['moe_layers']['moe']['w_gate'].q`` is (L, E, d, f), its
scales (L, E, k[, f]), and ``orig_shape`` is one matrix's (d, f), as
the JAX package writes them. A quantized bias (a 1-D
:class:`~repro_torch.core.splitquant.SplitQuantTensor`) is saved the same
way, with ``orig_shape`` its own (``['layers']['attn']['bq'].q`` is
(L, d), ``orig_shape`` (d,)), and comes back unpacked. bf16 arrays are
widened to fp32 in the npz and ``dtypes`` records ``"bfloat16"``. Writes go to ``<step>.tmp``,
are fsynced and renamed; ``retain`` old steps are kept.

:func:`restore` runs the integrity gate (checksums, code ranges, finite
scales: :mod:`repro_torch.engine.recovery`) before any array reaches the
caller, then rebuilds the ``like`` tree: a key in ``quant_meta`` comes
back as a ``PackedWeight`` packed for the kernel on the ``like`` leaf's
device, whether that leaf is dense or packed. No k-means runs. A training
checkpoint is the tuple ``(params, opt_state)`` with the optimizer state a
named tuple (:class:`~repro_torch.optim.adamw.OptState`), keyed as JAX
keys it: ``[0]['layers']['w']``, ``[1].step``, ``[1].m['layers']['w']``,
``[1].v[...]`` (``[1].err[...]`` only with gradient compression). A tuple
``like`` such as ``(params, None)`` reads the params half.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..core.splitquant import SplitQuantTensor
from ..engine.recovery import (check_code_range, check_finite,
                               checksum_arrays, verify_checksums)
from ..kernels.ops import PackedWeight, pack_for_kernel
from ..models.common import DTYPES
from ..tree import STACK_FRAGMENTS

SQT_FIELDS = ("q", "cid", "scale", "zero")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _map(node, fn, key: str = "", layer: Optional[int] = None,
         parent: Optional[str] = None, sort: bool = False):
    """Rebuild ``node`` with ``fn(key, leaf, layer)`` at every leaf, where
    ``key`` is the leaf's JAX ``keystr`` path and ``layer`` its index in
    the layer stack (None outside it). Dicts are walked in key order with
    ``sort`` (JAX's flatten order), else in their own; ``None`` is an
    empty subtree, as in JAX."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _map(node[k], fn, f"{key}[{k!r}]", layer, k, sort)
                for k in (sorted(node) if sort else node)}
    if isinstance(node, list) and layer is None and \
            parent in STACK_FRAGMENTS:
        return [_map(v, fn, key, i, None, sort) for i, v in enumerate(node)]
    if hasattr(node, "_fields"):             # a named tuple: ``.field``
        return type(node)(*(_map(getattr(node, f), fn, f"{key}.{f}", layer,
                                 None, sort) for f in node._fields))
    if isinstance(node, (list, tuple)):
        out = [_map(v, fn, f"{key}[{i}]", layer, None, sort)
               for i, v in enumerate(node)]
        return tuple(out) if isinstance(node, tuple) else out
    return fn(key, node, layer)


def _leaves(tree) -> dict:
    """{keystr: [leaf of each layer] (one leaf outside a stack)} in JAX's
    flatten order, and whether each key is stacked."""
    found, stacked = {}, {}

    def visit(key, leaf, layer):
        found.setdefault(key, []).append(leaf)
        stacked[key] = layer is not None
    _map(tree, visit, sort=True)
    return found, stacked


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as numpy, which later in-place updates of the
    tensor (AdamW's moments) do not reach; bf16 (and other dtypes npz
    does not store) widened to fp32."""
    t = t.detach()
    if t.dtype not in (torch.float64, torch.float32, torch.float16,
                       torch.int64, torch.int32, torch.int16, torch.int8,
                       torch.uint8, torch.bool):
        t = t.float()
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def _orig_shape(leaf) -> tuple:
    """One matrix's (K, N) of a packed weight (or stack); a quantized
    bias's own shape."""
    if isinstance(leaf, SplitQuantTensor):
        return tuple(leaf.shape[leaf.stack_dims:])
    return tuple(leaf.shape[-2:])


def _stack(parts: list, stacked: bool) -> torch.Tensor:
    return torch.stack(parts) if stacked else parts[0]


def _treedef_str(tree) -> str:
    """The tree's structure as JAX prints its ``PyTreeDef`` (informational:
    restore reads keys, not this string)."""
    def render(node, parent=None):
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {render(node[k], k)}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list) and node and parent in STACK_FRAGMENTS:
            return render(node[0])            # a layer stack: one leaf each
        if hasattr(node, "_fields"):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(render(getattr(node, f)) for f in
                                node._fields) + "])")
        if isinstance(node, (list, tuple)):
            inner = ", ".join(render(v) for v in node)
            if isinstance(node, tuple):
                return f"({inner},)" if len(node) == 1 else f"({inner})"
            return f"[{inner}]"
        if isinstance(node, (PackedWeight, SplitQuantTensor)):
            dt = _dtype_name(node.orig_dtype)
            dt = f"dtype('{dt}')" if dt != "bfloat16" else "dtype(bfloat16)"
            return (f"CustomNode(SplitQuantTensor[({node.bits}, {node.k}, "
                    f"{_orig_shape(node)}, {dt})], [*, *, *, *])")
        return "*"
    return f"PyTreeDef({render(tree)})"


def save(ckpt_dir: str, step: int, tree: Any, *, retain: int = 3,
         blocking: bool = True) -> str:
    """Atomically write ``tree`` under ckpt_dir/step_<N>. Returns the path.
    The arrays are copied to the host before returning, also with
    ``blocking=False`` (then only the write runs on a thread)."""
    leaves, stacked = _leaves(tree)
    host_arrays, dtypes, quant_meta = {}, {}, {}
    for key, parts in leaves.items():
        sd = stacked[key]
        if isinstance(parts[0], (PackedWeight, SplitQuantTensor)):
            p0 = parts[0]
            if any((p.bits, p.k, p.shape, p.orig_dtype) !=
                   (p0.bits, p0.k, p0.shape, p0.orig_dtype) for p in parts):
                raise ValueError(f"{key}: the layers differ in bits, k, "
                                 f"shape or dtype; a checkpoint leaf holds "
                                 f"one of each")
            sqts = [p.unpack() if isinstance(p, PackedWeight) else p
                    for p in parts]
            for f in SQT_FIELDS:
                a = _stack([getattr(s, f) for s in sqts], sd)
                host_arrays[f"{key}.{f}"] = _host(a)
                dtypes[f"{key}.{f}"] = _dtype_name(a.dtype)
            quant_meta[key] = {"bits": int(p0.bits), "k": int(p0.k),
                               "orig_shape": list(_orig_shape(p0)),
                               "orig_dtype": _dtype_name(p0.orig_dtype)}
        else:
            a = _stack(parts, sd)
            host_arrays[key] = _host(a)
            dtypes[key] = _dtype_name(a.dtype)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    treedef = _treedef_str(tree)

    def _write():
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host_arrays)
        manifest = {
            "step": step,
            "treedef": treedef,
            "keys": list(host_arrays.keys()),
            "shapes": {k: list(v.shape) for k, v in host_arrays.items()},
            "dtypes": dtypes,
            "quant_meta": quant_meta,
            "checksums": checksum_arrays(host_arrays),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic commit
        _gc(ckpt_dir, retain)

    if blocking:
        _write()
    else:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        save._last_async = t            # joinable by tests/shutdown
    return final


def _gc(ckpt_dir: str, retain: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-retain]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _device_of(leaf) -> torch.device:
    if isinstance(leaf, PackedWeight):
        return leaf.qp.device
    return leaf.q.device if isinstance(leaf, SplitQuantTensor) else \
        leaf.device


def _packed(data: dict, key: str, meta: Optional[dict], like,
            layer: Optional[int], device):
    """One layer's quantized leaf from the saved arrays and the manifest's
    meta (borrowed from a quantized ``like`` leaf for a checkpoint without
    quant_meta), packed for the kernel on ``device``; a bias (one axis)
    comes back as a ``SplitQuantTensor``."""
    if meta is not None:
        bits, k = int(meta["bits"]), int(meta["k"])
        orig_shape = tuple(meta["orig_shape"])
        orig_dtype = DTYPES[meta["orig_dtype"]]
    elif isinstance(like, (PackedWeight, SplitQuantTensor)):
        bits, k = like.bits, like.k
        orig_shape, orig_dtype = _orig_shape(like), like.orig_dtype
    else:
        raise ValueError(
            f"checkpoint has quantized arrays for {key!r} but no "
            f"quant_meta and no quantized `like` leaf to borrow meta from")
    arrs = {}
    for f, dt in zip(SQT_FIELDS, (torch.int8, torch.uint8, torch.float32,
                                  torch.float32)):
        a = data[f"{key}.{f}"]
        if layer is not None:
            a = a[layer]
        arrs[f] = torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dt)
    sd = arrs["q"].dim() - len(orig_shape)     # 1: a layer's experts
    if sd not in (0, 1) or tuple(arrs["q"].shape[sd:]) != orig_shape:
        raise ValueError(f"{key}: codes {tuple(arrs['q'].shape)} do not "
                         f"match orig_shape {orig_shape}")
    sqt = SplitQuantTensor(bits=bits, k=k, orig_dtype=orig_dtype,
                           stack_dims=sd, **arrs)
    return sqt if len(orig_shape) == 1 else pack_for_kernel(sqt)


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None
            ) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (values replaced; keys of
    the checkpoint that ``like`` lacks are not read). Dense leaves take
    the ``like`` leaf's dtype and device; a key in ``quant_meta`` comes
    back as a ``PackedWeight`` with its saved bits, k and dtype, packed
    on the ``like`` leaf's device, whether that leaf is packed (its meta
    is overridden) or dense (an offline-quantized tree restored into
    freshly initialized parameters, with no k-means). Returns
    (tree, step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        data = {k: npz[k] for k in npz.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    quant_meta = manifest.get("quant_meta", {})
    # integrity gate: checksums when the manifest has them (older
    # checkpoints predate the field), quant invariants always
    if "checksums" in manifest:
        verify_checksums(data, manifest["checksums"], context=path)
    for key, meta in quant_meta.items():
        check_code_range(f"{key}.q", data[f"{key}.q"], int(meta["bits"]),
                         context=path)
        for f_ in ("scale", "zero"):
            check_finite(f"{key}.{f_}", data[f"{key}.{f_}"], context=path)

    def leaf(key, like_leaf, layer):
        device = _device_of(like_leaf)
        if key in quant_meta or isinstance(like_leaf, (PackedWeight,
                                                       SplitQuantTensor)):
            return _packed(data, key, quant_meta.get(key), like_leaf, layer,
                           device)
        a = data[key] if layer is None else data[key][layer]
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=like_leaf.dtype)
    return _map(like, leaf), step


def wait_for_async():
    t = getattr(save, "_last_async", None)
    if t is not None:
        t.join()
