"""Trace inspector for the engine's JSONL event logs (port of
``repro.launch.trace_report``; reads either package's traces).

    PYTHONPATH=src python -m repro_torch.launch.trace_report /tmp/t.jsonl

Prints the per-step phase breakdown (draft / verify / rollback / prefill
/ decode, with the dispatch vs device-wait attribution), the per-request
lifecycle summary, and textual waterfalls. Options:

  --validate        validate against the event schema; exit 1 on errors
  --chrome PATH     re-export the loaded trace as Chrome/Perfetto JSON
  --waterfalls N    how many per-request waterfall rows to draw (0 = off)

The JAX package's ``--hlo`` (an XLA HLO roofline cross-check) is not
ported: passing it exits with a message.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..obs import (chrome_trace, lifecycle_summary, load_jsonl,
                   phase_breakdown, request_waterfalls, validate_events)


def _fmt_ms(s) -> str:
    return "-" if s is None else f"{s * 1e3:8.2f}"


def print_phase_table(pb: dict) -> None:
    print(f"\nphase breakdown — {pb['steps']} steps, "
          f"{pb['step_total_s']:.3f} s stepped wall")
    cov = pb["coverage"]
    print(f"  coverage: {'n/a' if cov is None else f'{cov:.1%}'} of step "
          f"wall attributed to phases")
    hdr = (f"  {'phase':<16}{'count':>7}{'total s':>10}{'mean ms':>10}"
           f"{'% step':>8}{'dispatch ms':>13}{'wait ms':>10}{'host ms':>10}")
    print(hdr)
    print("  " + "-" * (len(hdr) - 2))
    order = sorted(pb["phases"].items(), key=lambda kv: -kv[1]["total_s"])
    for name, d in order:
        frac = d["frac_of_step"]
        print(f"  {name:<16}{d['count']:>7}{d['total_s']:>10.3f}"
              f"{d['mean_s'] * 1e3:>10.2f}"
              f"{'-' if frac is None else f'{frac:7.1%}':>8}"
              f"{_fmt_ms(d['dispatch_s'] / d['count']):>13}"
              f"{_fmt_ms(d['device_wait_s'] / d['count']):>10}"
              f"{_fmt_ms(d['host_s'] / d['count']):>10}")
    att = pb["attributed_s"]
    if att:
        print(f"\ndispatch-vs-device attribution over {att:.3f} s "
              f"attributed:")
        print(f"  host dispatch (launch phases): "
              f"{pb['dispatch_s']:.3f} s ({pb['dispatch_frac']:.1%})")
        print(f"  device wait (token copy / synchronize): "
              f"{pb['device_wait_s']:.3f} s ({pb['device_wait_frac']:.1%})")
        print(f"  other host (commit loops, staging, sched): "
              f"{pb['other_host_s']:.3f} s "
              f"({pb['other_host_s'] / att:.1%})")


def print_waterfalls(records: list, limit: int, width: int = 44) -> None:
    rows = [r for r in request_waterfalls(records)
            if r.get("t_submit") is not None
            and r.get("t_retire") is not None]
    if not rows or not limit:
        return
    t_lo = min(r["t_submit"] for r in rows)
    t_hi = max(r["t_retire"] for r in rows)
    span = max(t_hi - t_lo, 1e-9)

    def col(t):
        return min(width - 1, int((t - t_lo) / span * width))
    print(f"\nper-request waterfalls ({min(limit, len(rows))}/{len(rows)} "
          f"shown; . queued  = prefill  # decode):")
    for r in rows[:limit]:
        bar = [" "] * width
        t_ft = r.get("t_first_token", r["t_retire"])
        t_ad = r.get("t_admit", r["t_submit"])
        for c in range(col(r["t_submit"]), col(t_ad) + 1):
            bar[c] = "."
        for c in range(col(t_ad), col(t_ft) + 1):
            bar[c] = "="
        for c in range(col(t_ft), col(r["t_retire"]) + 1):
            bar[c] = "#"
        print(f"  uid {r['uid']:>4} |{''.join(bar)}| "
              f"{(r['total_s'] or 0) * 1e3:7.1f} ms  "
              f"slot={r.get('slot', '?')} {r.get('n_out', 0)} tok "
              f"[{r.get('reason', '?')}]")


def print_lifecycle(records: list) -> None:
    ls = lifecycle_summary(records)
    if not ls["requests"]:
        print("\nno request lifecycle events in trace")
        return
    print(f"\nlifecycle — {ls['requests']} requests, retire reasons "
          f"{ls['retire_reasons']}")
    for seg in ("queued_s", "prefill_s", "decode_s", "total_s"):
        d = ls[seg]
        print(f"  {seg[:-2]:<8} mean {_fmt_ms(d['mean'])} ms   "
              f"p50 {_fmt_ms(d['p50'])} ms   p95 {_fmt_ms(d['p95'])} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="inspect an engine trace (JSONL from serve --trace)")
    ap.add_argument("trace", help="JSONL event log path")
    ap.add_argument("--validate", action="store_true",
                    help="schema-validate; exit 1 on any error")
    ap.add_argument("--chrome", default=None, metavar="PATH",
                    help="also export Chrome/Perfetto trace JSON")
    ap.add_argument("--waterfalls", type=int, default=8)
    ap.add_argument("--hlo", default=None, metavar="PATH",
                    help="not ported: the JAX package's HLO roofline "
                         "cross-check (ROADMAP queue 1 item 6)")
    args = ap.parse_args(argv)
    if args.hlo:
        raise NotImplementedError(
            "--hlo is not ported: it reads an XLA HLO dump, which the "
            "port has none of (ROADMAP queue 1 item 6, sharding; the "
            "port's roofline terms are chip_smoke.py's kernel bounds and "
            "launch.profile_engine)")

    records = load_jsonl(args.trace)
    head = records[0] if records else {}
    print(f"{args.trace}: {len(records) - 1} records, schema "
          f"{head.get('schema')}, dropped {head.get('dropped', 0)}"
          + (f", arch {head['arch']}" if "arch" in head else ""))
    dropped = int(head.get("dropped", 0) or 0)
    if dropped:
        # loud, not a status field: a ring-buffer overflow silently
        # truncates the OLDEST records, so every aggregate below (phase
        # fractions, coverage, lifecycle percentiles, waterfalls) is
        # computed over the tail of the run only — early prefill-heavy
        # steps are the usual casualties, which skews phase attribution
        # toward decode
        kept = max(len(records) - 1, 0)
        print(f"\n{'!' * 72}\n"
              f"!! WARNING: {dropped} trace records DROPPED (ring buffer "
              f"overflow; {kept} kept).\n"
              f"!! The oldest records are missing — phase attribution, "
              f"coverage, and\n"
              f"!! lifecycle percentiles below describe only the tail of "
              f"the run.\n"
              f"!! Re-trace with a larger EngineConfig.trace_capacity "
              f"(currently\n"
              f"!! {head.get('capacity', '?')}) or a shorter run for "
              f"trustworthy attribution.\n"
              f"{'!' * 72}")
    errs = validate_events(records)
    if errs:
        print(f"\nschema validation: {len(errs)} error(s)")
        for e in errs[:20]:
            print(f"  {e}")
        if args.validate:
            return 1
    else:
        print("schema validation: ok")

    pb = phase_breakdown(records)
    print_phase_table(pb)
    print_lifecycle(records)
    print_waterfalls(records, args.waterfalls)
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(chrome_trace(records), f)
        print(f"\nchrome trace -> {args.chrome}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
