"""Model-level SplitQuant application (port of ``repro.core.apply``): walk
a parameter tree and replace quantizable weights with packed SplitQuant
weights.

Same rules as the JAX package's defaults: normalization scales and other
"semantically not weights" parameters (the exclude list) are never
quantized, embedding tables only with ``quantize_embeddings`` (a VLM's
``patch_proj`` is a projection, not a table, and is quantized by
default), and tiny parameters (fewer than ``MIN_SIZE`` elements) are
left alone. Biases (1-D leaves) are quantized like weights, as the paper
and the JAX package do, and stay :class:`SplitQuantTensor`s: the kernel
takes matrices, and ``dense`` adds a bias's eq. (4) dequantization. The
JAX package stacks the layers on a leading
axis and quantizes each layer's slice on its own; the port's layer stack
is a Python list, so each leaf already is one layer's matrix, and
``MIN_SIZE`` is applied to the size of the whole stack as in JAX. A MoE
layer's expert leaf (E, d, f) is E matrices, each clustered and quantized
on its own (the JAX package's ``infer_stack_dims`` = 2 over its
(L, E, d, f) leaf), into one stacked packed weight; the k-means of a
slab of the E matrices runs as one batched pass. The router stays fp32.

A large leaf is quantized in slabs (:data:`SLAB_ELEMS`): an expert
stack by whole matrices, each on a k-means generator of its own, a
matrix by rows with its ranges combined; the bytes are those of the
unslabbed quantization. Each quantized matrix is packed ONCE, here, into
the kernel layout
(:class:`~repro_torch.kernels.ops.PackedWeight`). Methods: ``splitquant``
(the paper), ``baseline`` (one min/max range), ``percentile`` (one
clipped range, the outlier treatment the paper argues against) and, as a
per-path override, ``none``. Per-path overrides and ``report["per_path"]``
use the JAX package's paths, where the layer stack is one leaf
(``layers/attn/wq``, ``moe_layers/moe/w_gate``): an override applies to
that leaf of every layer.

:class:`LeafQuantizer` is the per-leaf step with its running leaf index
(the k-means seed); ``launch.serve.build_params`` feeds it one part at a
time while ``transformer.init`` builds the tree, so a model whose bf16
tree and packed tree would not fit on the card together is built with
the same packed bytes as ``quantize_tree(init(...))``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.ops import PackedWeight, dequant_constants, pack_for_kernel
from ..kernels.packing import pack_cids, pack_codes
from ..tree import STACK_FRAGMENTS
from ..tree import tree_to  # noqa: F401  (its callers import it here)
from .kmeans import row_generators
from .quantize import QuantConfig, qparams, quantize
from .splitquant import (SplitQuantTensor, assign_clusters,
                         baseline_quant_tensor, deployed_bytes,
                         empty_to_zero, fit_centroids, masked_min_max,
                         select_per_element, splitquant_tensor)

#: parameter-path fragments that are never quantized
DEFAULT_EXCLUDE = (
    "norm", "ln_", "layernorm", "rmsnorm", "scale_param",
    "decay", "gate_a", "rg_lru", "time_", "alibi", "rope",
    "router",
)

#: leave tiny parameters alone
MIN_SIZE = 64

#: embedding tables: quantized only with ``quantize_embeddings``
TABLE_FRAGMENTS = ("embed", "pos_table", "enc_pos", "dec_pos")

#: elements a slab of a large leaf holds at most: an expert stack is
#: quantized and packed in slabs of whole matrices, and a matrix of more
#: elements (splitquant or the min/max baseline) in slabs of rows, so
#: the working set stays near 25 bytes a slab element (kimi-k2's 384
#: experts of 7168 x 2048, its 7168 x 163840 lm_head). The slab follows
#: from the shapes alone, and the bytes do not depend on it.
SLAB_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """What to quantize and how."""

    cfg: QuantConfig = QuantConfig(bits=8)
    method: str = "splitquant"          # "splitquant" | "baseline" |
                                        # "percentile" | "none"
    k: int = 3                          # number of split layers (paper: 3)
    quantize_embeddings: bool = False   # the embedding table too (a tied
                                        # head then reads it dequantized)

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


def _quantizable(path_s: str, leaf, stack: int,
                 tables: bool = False) -> bool:
    """Whether a leaf is quantized; ``tables``: the policy's
    ``quantize_embeddings``."""
    if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
        return False
    if leaf.numel() * stack < MIN_SIZE or leaf.ndim == 0:
        return False
    if not tables and any(frag in path_s for frag in TABLE_FRAGMENTS):
        return False
    return not any(frag in path_s for frag in DEFAULT_EXCLUDE)


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
        ``(key,)``), one layer of a stack (path ``(key, index)``) or a
        part of one (path ``(key, index, *names)``: a sub-tree or a single
        leaf such as one expert stack), ``stack`` the stack's depth.
        Returns the part quantized."""
        path = tuple(map(str, path))
        jpath = path[:1] + path[2:]      # the JAX path has no layer index
        if len(path) > 1 and isinstance(part, (dict, list)):
            self.walk(part, path, stack, jpath)
            return part
        box = {path[-1]: part}
        self.walk(box, path[:-1], stack, jpath[:-1])
        return box[path[-1]]

    def _leaf(self, path_s, jpath, box, key, leaf, stack) -> None:
        report = self.report
        if not _quantizable(path_s, leaf, stack,
                            self.policy.quantize_embeddings):
            report["skipped"].append(path_s)
            return
        eff = resolve_policy(self.policy, self.overrides.get(jpath))
        if eff.method == "none":
            report["skipped"].append(path_s)
            return
        if leaf.ndim > 3:
            raise NotImplementedError(f"{path_s}: a {leaf.ndim}-D leaf; the "
                                      f"port quantizes vectors, matrices "
                                      f"and stacks of them (a MoE layer's "
                                      f"experts)")
        if eff.method not in ("splitquant", "baseline", "percentile"):
            raise ValueError(f"unknown method {eff.method!r}")
        gen = torch.Generator(device=leaf.device).manual_seed(
            self.seed + self.i) if eff.method == "splitquant" else None
        if leaf.ndim == 1:       # a bias: kept unpacked, dequantized by dense
            qleaf = _quantize(gen, leaf, eff, 0)
            nbytes = qleaf.nbytes_deployed()
        elif leaf.ndim == 3:
            qleaf, nbytes = quantize_stack(gen, leaf, eff, SLAB_ELEMS)
        elif leaf.numel() > SLAB_ELEMS and _row_slabs_take(eff):
            qleaf, nbytes = quantize_rows(gen, leaf, eff, SLAB_ELEMS)
        else:
            sq = _quantize(gen, leaf, eff, 0)
            qleaf, nbytes = pack_for_kernel(sq), sq.nbytes_deployed()
        box[key] = qleaf
        report["quantized"].append(path_s)
        entry = report["per_path"].setdefault(
            jpath, {"bits": eff.cfg.bits, "k": qleaf.k,
                    "method": eff.method, "bytes": 0})
        # the JAX package's count (codes, 2-bit cids when k > 1, scales),
        # not the kernel layout's (PackedWeight.nbytes_packed)
        entry["bytes"] += nbytes
        report["deployed_bytes"] += nbytes
        report["orig_bytes"] += leaf.numel() * 4


def _quantize(gen, w, eff: QuantPolicy, stack_dims: int):
    """The SplitQuantTensor of ``w`` (or of each matrix of a stack) under
    the effective policy; ``gen`` (or one generator a matrix) seeds
    splitquant's k-means."""
    if eff.method == "splitquant":
        return splitquant_tensor(gen, w, eff.cfg, k=eff.k,
                                 stack_dims=stack_dims)
    return baseline_quant_tensor(w, eff.cfg, stack_dims=stack_dims)


def quantize_stack(gen, w, eff: QuantPolicy, slab_elems: int):
    """An expert stack (E, K, N), each matrix quantized on its own and
    packed, in slabs of as many whole matrices as ``slab_elems`` holds
    (at least one). Each matrix's k-means draws from a generator of its
    own (:func:`~repro_torch.core.kmeans.row_generators` of ``gen``), so
    the bytes do not depend on the slab. Returns (the stacked
    PackedWeight, the deployed bytes as the JAX package counts them)."""
    E, K, N = w.shape
    step = max(1, min(E, slab_elems // (K * N)))
    gens = row_generators(gen, E) if gen is not None else [None] * E
    out, nbytes = None, 0
    for e0 in range(0, E, step):
        sl = slice(e0, min(E, e0 + step))
        sq = _quantize(gens[sl] if gen is not None else None, w[sl], eff, 1)
        part = pack_for_kernel(sq)
        nbytes += sq.nbytes_deployed()
        del sq
        if out is None:          # the whole stack's fields, filled in turn
            out = {f: torch.empty((E, *getattr(part, f).shape[1:]),
                                  dtype=getattr(part, f).dtype,
                                  device=w.device)
                   for f in ("qp", "cp", "recip", "shift", "scale", "zero")}
            proto = part
        for f, t in out.items():
            t[sl] = getattr(part, f)
    return dataclasses.replace(proto, shape=(E, K, N), **out), nbytes


def _row_slabs_take(eff: QuantPolicy) -> bool:
    """Min/max ranges combine across slabs of rows; a percentile does
    not."""
    k = eff.k if eff.method == "splitquant" else 1
    return eff.method != "percentile" and (k > 1 or
                                           eff.cfg.percentile is None)


def quantize_rows(gen, w, eff: QuantPolicy, slab_elems: int):
    """A (K, N) matrix quantized and packed in slabs of rows (a multiple
    of 8, as many as ``slab_elems`` holds): the centroids from the whole
    matrix's sample, then each slab's cluster ids and per-cluster ranges
    (min, max: exact across slabs), the scales once, then each slab's
    codes packed in place. The same bytes as ``pack_for_kernel`` of the
    whole matrix's quantization. Returns (PackedWeight, deployed
    bytes)."""
    K, N = w.shape
    k = eff.k if eff.method == "splitquant" else 1
    cfg = eff.cfg
    rows = max(8, slab_elems // N // 8 * 8)
    cents = fit_centroids(gen, w, k) if k > 1 else None
    red = 0 if cfg.per_channel else (0, 1)
    cid = torch.empty((K, N), dtype=torch.uint8, device=w.device)
    ranges = None
    for r0 in range(0, K, rows):
        wf = w[r0:r0 + rows].float()
        c = cid[r0:r0 + rows]
        c.copy_(assign_clusters(wf, cents) if k > 1 else torch.zeros_like(c))
        part = [masked_min_max(wf, c == j, red) for j in range(k)]
        ranges = part if ranges is None else [
            (torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1]),
             a[2] | b[2]) for a, b in zip(ranges, part)]
        del wf
    ranges = [empty_to_zero(*r) for r in ranges]
    scale, zero = qparams(torch.stack([r[0] for r in ranges]),
                          torch.stack([r[1] for r in ranges]), cfg)
    per = 8 // cfg.bits
    qp = torch.empty((K // per, N), dtype=torch.uint8, device=w.device)
    cp = torch.empty((K // 4, N), dtype=torch.uint8, device=w.device)
    for r0 in range(0, K, rows):
        c = cid[r0:r0 + rows]
        q = quantize(w[r0:r0 + rows].float(), select_per_element(scale, c),
                     select_per_element(zero, c), cfg)
        qp[r0 // per:(r0 + rows) // per] = pack_codes(q, cfg.bits)
        cp[r0 // 4:(r0 + rows) // 4] = pack_cids(c)
    recip, shift = dequant_constants(scale, zero, N)
    return (PackedWeight(qp=qp, cp=cp, recip=recip, shift=shift,
                         scale=scale.float(), zero=zero.float(),
                         bits=cfg.bits, k=k, shape=(K, N),
                         orig_dtype=w.dtype),
            deployed_bytes(K * N, cfg.bits, k,
                           scale.numel() + zero.numel()))


def quantize_tree(params, policy: QuantPolicy, seed: int = 0,
                  overrides: Optional[dict] = None):
    """Return a copy of ``params`` with quantizable leaves replaced by
    packed SplitQuant weights (biases: unpacked ``SplitQuantTensor``s),
    plus a report dict. The k-means seeding of
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
             if _quantizable(path_s, leaf, stack,
                             policy.quantize_embeddings)}
    unused = set(overrides or {}) - found
    if unused:
        raise ValueError(f"overrides matched no quantizable leaf: "
                         f"{sorted(unused)}")
    q = LeafQuantizer(policy, seed, overrides)
    q.walk(out)
    return out, q.report


def dequantize_tree(params):
    """Replace every quantized leaf with its dequantized dense tensor."""
    out = _copy_tree(params)
    for _, _, box, key, leaf, _ in _walk(out, (), 1):
        if isinstance(leaf, (PackedWeight, SplitQuantTensor)):
            box[key] = leaf.dequantize()
    return out


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree
