"""Postmortem reporter for incident bundles (port of
``repro.launch.incident_report``; bundles of ``obs.flight``, written by
either package).

    PYTHONPATH=src python -m repro_torch.launch.incident_report \
        incidents/incident-000-step_retry

Merges the bundle's flight-recorder window, its journal tail (plus an
optional full ``--journal``), and an optional ``--trace`` JSONL into one
uid/step-keyed timeline, names the triggering detector, and prints
root-cause hints. Options:

  --validate     structural validation for CI; exit 1 on any error
  --journal P    full request journal to merge (supersedes the tail)
  --trace P      tracer JSONL to correlate (slot spans per uid)
  --window N     how many trailing flight-record rows to print

Correlation semantics (DESIGN.md §14): the flight window is the step
axis — each record carries the uids holding slots that step, so a uid's
slot residency is the [first, last] step it appears. Journal/trace
records are uid-keyed, not step-keyed; they are joined per uid, and the
trigger's uid (when attributable) gets the merged per-uid story."""
from __future__ import annotations

import argparse
import json
import sys

from ..obs.detect import DETECTORS
from ..obs.flight import load_incident_bundle

_LIFECYCLE_ORDER = ("submit", "admit", "first_token", "retire")


def _journal_events(bundle: dict, journal_path: str | None) -> list[dict]:
    """Event records from --journal (preferred) or the bundle tail."""
    recs: list[dict] = []
    if journal_path:
        try:
            with open(journal_path) as f:
                recs = [json.loads(ln) for ln in f if ln.strip()]
        except (OSError, json.JSONDecodeError) as e:
            print(f"warning: --journal {journal_path} unreadable ({e}); "
                  f"falling back to bundle tail")
            recs = []
    if not recs:
        recs = bundle.get("journal_tail.jsonl", []) or []
    return [r for r in recs if r.get("kind") == "event"]


def _uid_stories(events: list[dict]) -> dict:
    """uid -> ordered lifecycle events (journal axis)."""
    out: dict = {}
    for r in events:
        uid = r.get("uid")
        if uid is None:
            continue
        out.setdefault(uid, []).append(r)
    return out


def _uid_steps(flight: list[dict]) -> dict:
    """uid -> (first step, last step) slot residency from the window."""
    out: dict = {}
    for rec in flight:
        for uid in rec.get("uids", ()) or ():
            first, _ = out.get(uid, (rec["step"], rec["step"]))
            out[uid] = (first, rec["step"])
    return out


def _fired_steps(trigger_doc: dict) -> dict:
    """step -> [detector names] for every firing in the bundle."""
    out: dict = {}
    for f in trigger_doc.get("firings", []):
        out.setdefault(f.get("step"), []).append(f.get("detector"))
    return out


def print_timeline(flight: list[dict], trigger_doc: dict,
                   window: int) -> None:
    fired = _fired_steps(trigger_doc)
    rows = flight[-window:] if window > 0 else flight
    if not rows:
        print("\ntimeline: flight window empty (recorder disabled?)")
        return
    print(f"\ntimeline — last {len(rows)} of {len(flight)} flight "
          f"records (step axis):")
    hdr = (f"  {'step':>5} {'wall ms':>8} {'q':>3} {'rung':>4} "
           f"{'retry':>5} {'quar':>4} {'acc':>5} {'clip':>5}  "
           f"uids / firings")
    print(hdr)
    print("  " + "-" * (len(hdr) - 2))
    # a window that starts at step 0 has a true zero baseline; a
    # wrapped window can only show deltas from its second row on
    prev_retries = 0 if rows[0].get("step") == 0 \
        else rows[0].get("retries", 0)
    for rec in rows:
        acc = rec.get("accept")
        clip = rec.get("clip_frac")
        d_retry = rec.get("retries", 0) - prev_retries
        prev_retries = rec.get("retries", 0)
        mark = ""
        if rec["step"] in fired:
            mark = "  << " + ",".join(fired[rec["step"]])
        print(f"  {rec['step']:>5} {rec.get('step_s', 0) * 1e3:>8.2f} "
              f"{rec.get('queue', 0):>3} {rec.get('rung', 0):>4} "
              f"{'+' + str(d_retry) if d_retry else '.':>5} "
              f"{rec.get('quarantined', 0):>4} "
              f"{'-' if acc is None else f'{acc:.2f}':>5} "
              f"{'-' if clip is None else f'{clip:.2f}':>5}  "
              f"{rec.get('uids', [])}{mark}")


def print_uid_story(uid, stories: dict, residency: dict,
                    trace_records: list[dict]) -> None:
    print(f"\nuid {uid}:")
    if uid in residency:
        a, b = residency[uid]
        print(f"  slot residency: steps {a}..{b} (flight window)")
    evs = stories.get(uid, [])
    if evs:
        for r in evs:
            extra = {k: v for k, v in r.items()
                     if k in ("reason", "slot", "n_out", "step")}
            print(f"  journal {r.get('ts', 0):9.3f}s  "
                  f"{r.get('name', '?'):<12} {extra}")
    else:
        print("  no journal events (outside tail window — pass "
              "--journal for the full WAL)")
    if trace_records:
        mine = [r for r in trace_records if r.get("uid") == uid]
        if mine:
            names = sorted({r.get("name") for r in mine})
            print(f"  trace: {len(mine)} records ({', '.join(names)})")


def root_cause_hints(bundle: dict) -> list[str]:
    """Rule-based hints from the trigger + flight window — named causal
    reads of the signals, not guesses presented as facts."""
    trig_doc = bundle["trigger.json"]
    trig = trig_doc["trigger"]
    det, uid, step = trig["detector"], trig.get("uid"), trig.get("step")
    flight = bundle["flight.json"].get("records", [])
    reqs = bundle.get("requests.json", {}) or {}
    poison = set(reqs.get("poison_uids", []) or [])
    counts = trig_doc.get("faults_injected") or {}
    hints: list[str] = []

    def rung_ascent_before(s):
        prev = 0
        for rec in flight:
            if rec["step"] >= s:
                break
            if rec.get("rung", 0) > prev:
                prev = rec["rung"]
                yield rec["step"], rec["rung"]

    if det == "step_retry":
        hints.append(
            f"step retry at step {step}"
            + (f" attributed to uid {uid}" if uid is not None else
               " (unattributable — raised exception, not corrupt output)")
            + ": all active slots rolled back and re-executed "
              "bit-identically (greedy purity).")
        if uid is not None and uid in poison:
            hints.append(f"uid {uid} is in the injector's poison set — "
                         f"corruption will recur until quarantine.")
        if any(counts.get(k) for k in ("step_exceptions",
                                       "token_corruptions")):
            hints.append(f"seeded fault injector was active "
                         f"({counts}) — injected, not organic.")
    elif det == "quarantine":
        hints.append(
            f"uid {uid} retired 'failed' after exhausting max_retries — "
            f"its output stayed corrupt across rollback re-executions.")
        if uid in poison:
            hints.append(f"uid {uid} is in the injector's poison set: "
                         f"quarantine is the designed containment.")
    elif det == "accept_collapse":
        ascents = list(rung_ascent_before(step))
        if ascents:
            s_r, rung = ascents[-1]
            hints.append(
                f"acceptance collapsed {step - s_r} steps after rung-"
                f"{rung} suspended speculation at step {s_r} — suspended "
                f"steps leave draft-cache holes that cost acceptance on "
                f"resume.")
        else:
            hints.append(
                "acceptance collapsed with no rung ascent in the window "
                "— draft/target divergence (recipe drift?), not ladder "
                "suspension.")
    elif det == "kv_clip_spike":
        later = [r for r in flight if r["step"] > step]
        base = next((r.get("retries", 0) for r in flight
                     if r["step"] == step), 0)
        if any(r.get("retries", 0) > base for r in later):
            hints.append(
                f"clip-frac spike at step {step} preceded retry "
                f"activity — saturating KV codes degrade logits before "
                f"they corrupt them.")
        hints.append(
            "clip fraction trending up means the static scales drifted "
            "narrow for live data — recalibrate the KV recipe "
            "(launch.serve --save-recipe) or switch the cache to dynamic "
            "scales.")
    elif det == "queue_runaway":
        if all(r.get("rung", 0) == 0 for r in flight):
            hints.append(
                "queue exceeded the admission set point with the "
                "degradation ladder flat at rung 0 — run with --degrade "
                "or lower --max-queue to shed earlier.")
        else:
            hints.append(
                "queue exceeded the set point despite ladder activity — "
                "offered load is beyond the shed thresholds.")
    elif det == "rung_ascent":
        hints.append(
            f"pressure (queue + prefill backlog) crossed a ladder "
            f"threshold at step {step}: rung 1 suspends speculation, "
            f"rung 2 defers batch admissions, rung 3 sheds queued load.")
    elif det == "step_latency_spike":
        hints.append(
            f"step wall spiked vs the rolling baseline at step {step} — "
            f"usual suspects: a first call at a new shape (kernel build, "
            f"allocator growth), an injected slow step, or host "
            f"contention.")
        if counts.get("slow_steps"):
            hints.append(f"injector reports {counts['slow_steps']} "
                         f"slow step(s) — injected straggler.")
    elif det == "integrity_error":
        hints.append(
            f"artifact failed integrity validation and was refused: "
            f"{trig.get('reason', '')} — regenerate the snapshot/recipe; "
            f"the engine never serves a corrupt artifact.")
    elif det == "injected_crash":
        hints.append(
            "process died at a step boundary (chaos crash injection); "
            "the journal tail ends at the crash horizon and the "
            "supervisor restarted + recovered from snapshot + WAL "
            "replay. Recovered outputs are bit-identical by greedy "
            "purity.")
    return hints


def validate_bundle(bundle: dict) -> list[str]:
    """Structural checks beyond load_incident_bundle's parse pass."""
    errs: list[str] = []
    trig_doc = bundle.get("trigger.json", {})
    trig = trig_doc.get("trigger") or {}
    if trig.get("detector") not in DETECTORS:
        errs.append(f"trigger detector {trig.get('detector')!r} not in "
                    f"catalog {DETECTORS}")
    if not trig_doc.get("firings"):
        errs.append("trigger.json lists no firings")
    flight = bundle.get("flight.json", {}).get("records", [])
    steps = [r.get("step") for r in flight]
    if steps != sorted(steps):
        errs.append("flight records out of step order")
    for i, rec in enumerate(flight):
        if "step_s" not in rec or "uids" not in rec:
            errs.append(f"flight record {i} missing step_s/uids")
            break
    for r in bundle.get("journal_tail.jsonl", []) or []:
        if r.get("kind") not in ("header", "event", "counter", "span"):
            errs.append(f"journal tail record kind {r.get('kind')!r} "
                        f"unknown")
            break
    reqs = bundle.get("requests.json", {})
    if not isinstance(reqs.get("active"), list) \
            or not isinstance(reqs.get("queued"), list):
        errs.append("requests.json lacks active/queued lists")
    fp = bundle.get("fingerprint.json", {})
    if not fp.get("arch"):
        errs.append("fingerprint.json lacks arch")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merge an incident bundle + journal + trace into a "
                    "uid/step-keyed postmortem timeline")
    ap.add_argument("bundle", help="incident bundle directory")
    ap.add_argument("--validate", action="store_true",
                    help="structural validation for CI; exit 1 on error")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="full request journal (supersedes bundle tail)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="tracer JSONL to correlate per uid")
    ap.add_argument("--window", type=int, default=30,
                    help="trailing flight rows to print (default 30)")
    args = ap.parse_args(argv)

    try:
        bundle = load_incident_bundle(args.bundle)
    except ValueError as e:
        print(f"{args.bundle}: INVALID bundle — {e}")
        return 1
    errs = validate_bundle(bundle)

    trig_doc = bundle["trigger.json"]
    trig = trig_doc["trigger"]
    fp = bundle.get("fingerprint.json", {})
    print(f"{args.bundle}: trigger {trig['detector']} at step "
          f"{trig.get('step')}"
          + (f" (uid {trig['uid']})" if trig.get("uid") is not None
             else ""))
    print(f"  reason: {trig.get('reason', '')}")
    print(f"  engine: arch {fp.get('arch')} slots {fp.get('n_slots')} "
          f"kv {fp.get('kv_mode')} spec_k {fp.get('spec_k')}")
    others = [f for f in trig_doc.get("firings", [])[1:]]
    if others:
        print(f"  co-firings: "
              + ", ".join(f"{f['detector']}@{f['step']}" for f in others))

    if errs:
        print(f"\nvalidation: {len(errs)} error(s)")
        for e in errs:
            print(f"  {e}")
        if args.validate:
            return 1
    else:
        print("validation: ok")

    flight = bundle["flight.json"].get("records", [])
    print_timeline(flight, trig_doc, args.window)

    events = _journal_events(bundle, args.journal)
    stories = _uid_stories(events)
    residency = _uid_steps(flight)
    trace_records: list[dict] = []
    if args.trace:
        from ..obs.tracer import load_jsonl
        try:
            trace_records = load_jsonl(args.trace)
        except (OSError, json.JSONDecodeError) as e:
            print(f"warning: --trace {args.trace} unreadable ({e})")
    # the trigger's uid first, then every uid active at the trigger step
    focus: list = []
    if trig.get("uid") is not None:
        focus.append(trig["uid"])
    at_trigger = next((r.get("uids", []) for r in flight
                       if r.get("step") == trig.get("step")), [])
    focus += [u for u in at_trigger if u not in focus]
    for uid in focus[:8]:
        print_uid_story(uid, stories, residency, trace_records)

    hints = root_cause_hints(bundle)
    if hints:
        print("\nroot-cause hints:")
        for h in hints:
            print(f"  * {h}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
