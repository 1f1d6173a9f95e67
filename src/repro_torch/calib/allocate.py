"""Greedy mixed-precision bit allocation under a deployed-bytes budget
(port of ``repro.calib.allocate``; pure Python, the same table gives the
same result).

Given the sensitivity table (per group: calibration error and deployed
bytes at each candidate bit-width), start every group at the lowest
bit-width and repeatedly buy the upgrade with the best error reduction
per extra byte that still fits the budget. The result is an overrides
map for ``quantize_tree(overrides=...)`` / ``QuantRecipe.policies``.
"""
from __future__ import annotations

from typing import Optional


def uniform_bytes(table: dict, bits: int) -> int:
    """Deployed bytes if every group uniformly gets ``bits``."""
    return sum(r["per_bits"][bits]["bytes"] for r in table.values())


def greedy_allocate(table: dict, budget_bytes: float, *,
                    metric: str = "kl",
                    method: str = "splitquant", k: int = 3) -> dict:
    """Allocate per-group bit-widths under ``budget_bytes``.

    ``table``: :func:`repro_torch.calib.sensitivity.layer_sensitivity`
    output. ``metric``: "kl" or "mse", the calibration error minimized.

    Returns ``{"overrides": {path: {bits, method, k}}, "assignment":
    {path: bits}, "total_bytes": int, "avg_bits": float, "feasible":
    bool}``; ``feasible`` is False when even the all-minimum assignment
    exceeds the budget (the minimum assignment is still returned).
    """
    paths = sorted(table.keys())
    if not paths:
        raise ValueError("empty sensitivity table")
    bits_lists = {p: sorted(table[p]["per_bits"].keys()) for p in paths}
    assign = {p: bits_lists[p][0] for p in paths}

    def group_bytes(p):
        return table[p]["per_bits"][assign[p]]["bytes"]

    def group_err(p, bits):
        return table[p]["per_bits"][bits][metric]

    total = sum(group_bytes(p) for p in paths)
    feasible = total <= budget_bytes
    while True:
        best = None                      # (gain_per_byte, path, next_bits)
        for p in paths:
            blist = bits_lists[p]
            i = blist.index(assign[p])
            if i + 1 >= len(blist):
                continue
            nxt = blist[i + 1]
            extra = table[p]["per_bits"][nxt]["bytes"] - group_bytes(p)
            if total + extra > budget_bytes:
                continue
            gain = group_err(p, assign[p]) - group_err(p, nxt)
            # upgrades that cost nothing extra are always taken first
            rate = gain / max(extra, 1)
            if gain > 0 and (best is None or rate > best[0]):
                best = (rate, p, nxt, extra)
        if best is None:
            break
        _, p, nxt, extra = best
        assign[p] = nxt
        total += extra

    n_weights = sum(table[p]["size"] for p in paths)
    avg_bits = sum(assign[p] * table[p]["size"] for p in paths) / n_weights
    overrides = {p: {"bits": int(assign[p]), "method": method, "k": k}
                 for p in paths}
    return {"overrides": overrides,
            "assignment": {p: int(assign[p]) for p in paths},
            "total_bytes": int(total),
            "avg_bits": float(avg_bits),
            "feasible": bool(feasible)}


def best_uniform_within(table: dict, budget_bytes: float) -> Optional[int]:
    """Largest uniform bit-width whose deployment fits the budget (None if
    not even the smallest fits): the fair uniform baseline at a budget."""
    fits = [b for b in sorted(next(iter(table.values()))["per_bits"])
            if uniform_bytes(table, b) <= budget_bytes]
    return max(fits) if fits else None
