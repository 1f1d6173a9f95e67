"""Trace event schema (port of ``repro.obs.schema``): the phase taxonomy,
lifecycle vocabulary, and a dependency-free validator. The request
journal (``engine/recovery.py``) is written in this record format, so a
merged crash + recovery journal validates as one trace (DESIGN.md §10).

Phase taxonomy (``span`` names) — each engine step tiles into these:

* ``step``            — the whole `Engine.step()` (the coverage
                        denominator; every other phase nests inside it)
* ``prefill_oneshot`` — legacy dense per-request prefill + slot write
* ``prefill_chunk``   — one fused chunked-prefill dispatch (slot, uid,
                        pos_start, n)
* ``draft``           — the speculative draft pass over all slots
                        (aggregated per-iteration dispatch/wait fields)
* ``verify``          — ONE slot's fused verify dispatch + device wait +
                        accept-length computation
* ``rollback``        — target + draft cache rollback for one slot
* ``accept_commit``   — host-side token commit loop (spec and plain
                        decode share the name; eos/budget retire runs
                        inside it)
* ``decode``          — one batched plain decode dispatch + device wait
* ``kv_sample``       — the periodic KV quality-counter sample (its
                        cache→host transfer is traced-mode-only cost)

Lifecycle vocabulary (``event`` names): ``submit``, ``admit``,
``first_token``, ``retire`` (with ``reason``), ``rollback``,
``cancel`` (the Engine.cancel call site; the matching retire carries
reason "cancelled"), ``degrade`` (a degradation-ladder rung change —
engine-scoped, so it carries ``rung``/``pressure`` instead of a uid),
``snapshot`` / ``restore`` (crash-safety boundaries, DESIGN.md §13 —
engine-scoped like ``degrade``; the request journal shares this schema,
so a merged crash + recovery journal validates as one trace).

Retire reasons split into the NORMAL terminals (eos / budget / max_len /
zero_budget) and the POLICY terminals introduced by fault tolerance
(DESIGN.md §12): ``cancelled`` (client withdrew), ``deadline_exceeded``
(TTFT or total-wall deadline passed at a step boundary), ``shed``
(admission control or ladder rung 3 dropped it unserved), ``failed``
(quarantined after exhausting step retries, or force-failed by the
drain watchdog). Together they partition every submission: each request
retires exactly once with exactly one reason (the chaos harness'
core invariant).
"""
from __future__ import annotations

PHASES = ("step", "prefill_oneshot", "prefill_chunk", "draft", "verify",
          "rollback", "accept_commit", "decode", "kv_sample")

LIFECYCLE = ("submit", "admit", "first_token", "retire", "rollback",
             "cancel", "degrade", "snapshot", "restore")

RETIRE_REASONS = ("eos", "budget", "max_len", "zero_budget",
                  "cancelled", "deadline_exceeded", "shed", "failed")

KINDS = ("header", "span", "event", "counter")

#: per-kind required fields (beyond "kind")
_REQUIRED = {
    "header": ("schema",),
    "span": ("name", "ts", "dur"),
    "event": ("name", "ts"),
    "counter": ("name", "ts", "value"),
}


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_events(records: list[dict]) -> list[str]:
    """Validate a record list (as loaded from `tracer.load_jsonl`).
    Returns a list of human-readable errors — empty means valid."""
    from .tracer import SCHEMA_VERSION

    errs = []
    if not records:
        return ["empty trace (no header record)"]
    head = records[0]
    if head.get("kind") != "header":
        errs.append(f"record 0: expected header, got {head.get('kind')!r}")
    elif head.get("schema") != SCHEMA_VERSION:
        errs.append(f"header: schema {head.get('schema')!r} != "
                    f"{SCHEMA_VERSION}")
    for i, rec in enumerate(records):
        kind = rec.get("kind")
        if kind not in KINDS:
            errs.append(f"record {i}: unknown kind {kind!r}")
            continue
        for f in _REQUIRED[kind]:
            if f not in rec:
                errs.append(f"record {i} ({kind}): missing field {f!r}")
        if kind == "header":
            if i != 0:
                errs.append(f"record {i}: header not first")
            continue
        if not _is_num(rec.get("ts")) or rec.get("ts", 0) < 0:
            errs.append(f"record {i} ({kind}): bad ts {rec.get('ts')!r}")
        if kind == "span":
            if rec.get("name") not in PHASES:
                errs.append(f"record {i}: unknown phase {rec.get('name')!r}")
            if not _is_num(rec.get("dur")) or rec.get("dur", 0) < 0:
                errs.append(f"record {i}: bad dur {rec.get('dur')!r}")
            for f in ("dispatch_s", "wait_s"):
                if f in rec and (not _is_num(rec[f]) or rec[f] < 0):
                    errs.append(f"record {i}: bad {f} {rec[f]!r}")
        elif kind == "event":
            name = rec.get("name")
            if name not in LIFECYCLE:
                errs.append(f"record {i}: unknown lifecycle event {name!r}")
            if name in ("submit", "admit", "first_token", "retire",
                        "cancel") \
                    and not isinstance(rec.get("uid"), int):
                errs.append(f"record {i} ({name}): missing/bad uid")
            if name == "retire" \
                    and rec.get("reason") not in RETIRE_REASONS:
                errs.append(f"record {i}: bad retire reason "
                            f"{rec.get('reason')!r}")
        elif kind == "counter":
            val = rec.get("value")
            if not (_is_num(val) or (isinstance(val, dict)
                                     and all(_is_num(v) or v is None
                                             or isinstance(v, (list, str))
                                             for v in val.values()))):
                errs.append(f"record {i}: bad counter value {val!r}")
    return errs
