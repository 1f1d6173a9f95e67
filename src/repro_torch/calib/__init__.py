"""Offline calibration of the port (``repro.calib``): measure → decide →
serialize → serve.

    stats.collect_act_stats       activation range statistics (bert-tiny)
    stats.collect_kv_stats        K/V range statistics
    sensitivity.layer_sensitivity per-group logit damage × deployed bytes
        │
    allocate.greedy_allocate      mixed-precision (bits, k, method) per path
        │
    recipe.QuantRecipe            JSON + npz on disk, with a checkpoint of
                                  the quantized tree (checkpoint.ckpt)

Serving (``launch.serve --recipe``) only reads the recipe and the
checkpoint: no k-means, no calibration batches, no runtime min/max.
"""
from .allocate import best_uniform_within, greedy_allocate, uniform_bytes
from .recipe import QuantRecipe
from .sensitivity import (layer_sensitivity, quantizable_groups,
                          sensitivity_summary)
from .stats import (ActStats, act_static_scales, collect_act_stats,
                    collect_kv_stats, kv_static_scales, static_qparams)

__all__ = [
    "ActStats", "QuantRecipe", "act_static_scales", "best_uniform_within",
    "collect_act_stats", "collect_kv_stats", "greedy_allocate",
    "kv_static_scales", "layer_sensitivity", "quantizable_groups",
    "sensitivity_summary", "static_qparams", "uniform_bytes",
]
