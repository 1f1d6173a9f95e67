"""Trace aggregation (port of ``repro.obs.report``): phase breakdown,
dispatch-vs-device attribution and per-request waterfalls.
``Engine.metrics()`` embeds the breakdown of a traced engine as its
``phase_attribution``.
"""
from __future__ import annotations

from .summary import mean, pct


def spans(records, name=None):
    return [r for r in records if r.get("kind") == "span"
            and (name is None or r.get("name") == name)]


def phase_breakdown(records) -> dict:
    """Aggregate span records into the per-phase timeline summary.

    ``step`` spans are the denominator (total measured wall-clock step
    time); every other phase nests inside a step, and the phases are
    non-overlapping by construction (engine instrumentation brackets
    disjoint regions), so ``coverage`` = attributed / step-total is the
    fraction of step wall the taxonomy explains — the acceptance bar is
    ≥ 0.9. Per phase: total/count/mean plus the ``dispatch_s`` (host
    time inside the entry point's launches) and ``wait_s`` (device
    wait) attribution,
    with ``host_s = total − device wait`` (host incl. dispatch).
    """
    per: dict[str, dict] = {}
    step_total, step_count = 0.0, 0
    for r in spans(records):
        if r["name"] == "step":
            step_total += r["dur"]
            step_count += 1
            continue
        d = per.setdefault(r["name"], {"total_s": 0.0, "count": 0,
                                       "dispatch_s": 0.0,
                                       "device_wait_s": 0.0})
        d["total_s"] += r["dur"]
        d["count"] += 1
        d["dispatch_s"] += r.get("dispatch_s", 0.0)
        d["device_wait_s"] += r.get("wait_s", 0.0)
    attributed = 0.0
    for d in per.values():
        d["mean_s"] = d["total_s"] / d["count"]
        d["host_s"] = d["total_s"] - d["device_wait_s"]
        d["frac_of_step"] = (d["total_s"] / step_total if step_total
                             else None)
        attributed += d["total_s"]
    dispatch = sum(d["dispatch_s"] for d in per.values())
    wait = sum(d["device_wait_s"] for d in per.values())
    return {
        "phases": per,
        "steps": step_count,
        "step_total_s": step_total,
        "attributed_s": attributed,
        "coverage": attributed / step_total if step_total else None,
        # the dispatch-bound question, answered: host time inside the
        # entry points (kernel launches, enqueue) vs device-result wait
        # vs other host work (accept loops, scheduler, numpy staging)
        "dispatch_s": dispatch,
        "device_wait_s": wait,
        "other_host_s": attributed - dispatch - wait,
        "dispatch_frac": dispatch / attributed if attributed else None,
        "device_wait_frac": wait / attributed if attributed else None,
    }


def request_waterfalls(records) -> list[dict]:
    """Per-request lifecycle rows (uid order): submit/admit/first-token/
    retire timestamps with the derived queued / prefill+first-token /
    decode segments a waterfall plots."""
    reqs: dict[int, dict] = {}
    for r in records:
        if r.get("kind") != "event" or r.get("uid") is None:
            continue
        row = reqs.setdefault(int(r["uid"]), {"uid": int(r["uid"])})
        name = r["name"]
        if name == "submit":
            row["t_submit"] = r["ts"]
            row["prompt_len"] = r.get("prompt_len")
            row["budget"] = r.get("budget")
        elif name == "admit":
            row["t_admit"] = r["ts"]
            row["slot"] = r.get("slot")
        elif name == "first_token":
            row["t_first_token"] = r["ts"]
        elif name == "retire":
            row["t_retire"] = r["ts"]
            row["reason"] = r.get("reason")
            row["n_out"] = r.get("n_out")

    def seg(row, a, b):
        return (row[b] - row[a] if a in row and b in row else None)
    for row in reqs.values():
        row["queued_s"] = seg(row, "t_submit", "t_admit")
        row["prefill_s"] = seg(row, "t_admit", "t_first_token")
        row["decode_s"] = seg(row, "t_first_token", "t_retire")
        row["total_s"] = seg(row, "t_submit", "t_retire")
    return [reqs[u] for u in sorted(reqs)]


def lifecycle_summary(records) -> dict:
    """Aggregate waterfall segments (the per-request view of the same
    trace the phase breakdown views per-step)."""
    rows = request_waterfalls(records)

    def agg(key):
        vals = [r[key] for r in rows if r.get(key) is not None]
        return {"mean": mean(vals), "p50": pct(vals, 50),
                "p95": pct(vals, 95)}
    reasons: dict[str, int] = {}
    for r in rows:
        if r.get("reason"):
            reasons[r["reason"]] = reasons.get(r["reason"], 0) + 1
    return {"requests": len(rows), "queued_s": agg("queued_s"),
            "prefill_s": agg("prefill_s"), "decode_s": agg("decode_s"),
            "total_s": agg("total_s"), "retire_reasons": reasons}
