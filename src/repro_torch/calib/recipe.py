"""QuantRecipe: the serializable product of offline calibration (port of
``repro.calib.recipe``; the same files, so each package loads what the
other saved).

A recipe is everything serving needs to deploy a quantized model without
redoing calibration at start-up:

  * ``policies``   — per-path ``{bits, k, method[, percentile]}`` overrides
                     for :func:`repro_torch.core.apply.quantize_tree` (the
                     output of :mod:`repro_torch.calib.allocate`);
  * ``kv_scales``  — static per-layer INT8 KV-cache quantization params
                     (``k_scale/k_zero/v_scale/v_zero``, each (L, Hkv, C));
  * ``act_scales`` — static per-site activation scale/zero arrays;
  * ``ckpt_dir``   — optional pointer to a checkpoint of the already
                     quantized weight tree (:mod:`repro_torch.checkpoint`),
                     so serving never runs k-means.

On disk a recipe is a directory: ``recipe.json`` (indent 2, sorted keys)
holds everything scalar and the policy map, ``scales.npz`` the arrays
(keys ``kv/<name>`` and ``act/<site>/scale|zero``). ``save`` records a
CRC32 per array; ``load`` verifies them (when present), requires the KV
scales to be finite and strictly positive and every other array finite,
and raises :class:`~repro_torch.engine.recovery.IntegrityError` otherwise.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from ..engine.recovery import (check_finite, check_positive,
                               checksum_arrays, verify_checksums)

RECIPE_JSON = "recipe.json"
SCALES_NPZ = "scales.npz"

KV_KEYS = ("k_scale", "k_zero", "v_scale", "v_zero")


@dataclasses.dataclass
class QuantRecipe:
    """Offline calibration output (see module docstring)."""

    name: str = "recipe"
    arch: str = ""
    #: per-path quantize_tree overrides: {path: {bits|k|method|percentile}}
    policies: dict = dataclasses.field(default_factory=dict)
    #: static KV quant params {k_scale,k_zero,v_scale,v_zero: (L, Hkv, C)}
    kv_scales: Optional[dict] = None
    kv_qchunks: int = 4
    #: static activation params {site: {"scale": arr, "zero": arr}}
    act_scales: Optional[dict] = None
    #: checkpoint dir of the pre-quantized weight tree; a relative path
    #: resolves against the recipe dir
    ckpt_dir: Optional[str] = None
    #: free-form provenance (budget, calibration set, sensitivity summary)
    meta: dict = dataclasses.field(default_factory=dict)

    def save(self, recipe_dir: str) -> str:
        os.makedirs(recipe_dir, exist_ok=True)
        arrays = {}
        if self.kv_scales is not None:
            missing = [kk for kk in KV_KEYS if kk not in self.kv_scales]
            if missing:
                raise ValueError(f"kv_scales missing {missing}")
            for kk in KV_KEYS:
                arrays[f"kv/{kk}"] = np.asarray(self.kv_scales[kk],
                                                np.float32)
        for site, sz in (self.act_scales or {}).items():
            arrays[f"act/{site}/scale"] = np.asarray(sz["scale"], np.float32)
            arrays[f"act/{site}/zero"] = np.asarray(sz["zero"], np.float32)
        doc = {
            "name": self.name,
            "arch": self.arch,
            "policies": self.policies,
            "kv_qchunks": self.kv_qchunks,
            "has_kv_scales": self.kv_scales is not None,
            "act_sites": sorted((self.act_scales or {}).keys()),
            "ckpt_dir": self.ckpt_dir,
            "meta": self.meta,
            "checksums": checksum_arrays(arrays),
        }
        tmp = os.path.join(recipe_dir, RECIPE_JSON + ".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True, default=str)
        if arrays:
            np.savez(os.path.join(recipe_dir, SCALES_NPZ), **arrays)
        os.replace(tmp, os.path.join(recipe_dir, RECIPE_JSON))
        return recipe_dir

    @classmethod
    def load(cls, recipe_dir: str) -> "QuantRecipe":
        with open(os.path.join(recipe_dir, RECIPE_JSON)) as f:
            doc = json.load(f)
        npz_path = os.path.join(recipe_dir, SCALES_NPZ)
        arrays = dict(np.load(npz_path)) if os.path.exists(npz_path) else {}
        if "checksums" in doc:
            verify_checksums(arrays, doc["checksums"], context=recipe_dir)
        for key, a in arrays.items():
            # KV scales are divisors in dequant: zero or negative can only
            # be corruption; act sites keep the finite-only check (a dead
            # site legitimately calibrates to a degenerate range)
            if key.startswith("kv/") and key.endswith("_scale"):
                check_positive(key, a, context=recipe_dir)
            else:
                check_finite(key, a, context=recipe_dir)
        kv_scales = None
        if doc.get("has_kv_scales"):
            kv_scales = {kk: arrays[f"kv/{kk}"] for kk in KV_KEYS}
        act_scales = {site: {"scale": arrays[f"act/{site}/scale"],
                             "zero": arrays[f"act/{site}/zero"]}
                      for site in doc.get("act_sites", [])}
        return cls(name=doc["name"], arch=doc["arch"],
                   policies=doc.get("policies", {}),
                   kv_scales=kv_scales,
                   kv_qchunks=int(doc.get("kv_qchunks", 4)),
                   act_scales=act_scales or None,
                   ckpt_dir=doc.get("ckpt_dir"),
                   meta=doc.get("meta", {}))

    def resolve_ckpt_dir(self, recipe_dir: str) -> Optional[str]:
        """ckpt_dir as an absolute path (relative = inside the recipe)."""
        if self.ckpt_dir is None:
            return None
        if os.path.isabs(self.ckpt_dir):
            return self.ckpt_dir
        return os.path.join(recipe_dir, self.ckpt_dir)
