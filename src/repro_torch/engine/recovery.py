"""Crash-safe serving (port of ``repro.engine.recovery``, DESIGN.md §13):
the request journal, engine snapshot and restore, and the integrity
checks every loaded artifact passes.

1. :class:`RequestJournal` — an append-only JSONL write-ahead log of
   request lifecycle transitions (submit / admit / first_token / retire,
   and the engine's snapshot / restore marks), in the trace record
   format (``obs/tracer.py``), record for record the JAX package's.
   Appends are buffered and made durable once per engine step by
   ``sync()`` (write + flush + fsync): the durability horizon is the
   step boundary, which is where the injected crash fires.
2. :func:`snapshot_engine` / :func:`restore_engine` — the live engine's
   state (the quantized slot cache, the draft's twin, the scheduler's
   queue and slot table, the host decode state and the sampler's
   generator) in a directory written atomically (``obs.atomic``):
   ``arrays.npz`` + ``manifest.json`` with per-array CRC32 checksums, the
   provenance header and the engine's geometry fingerprint. The format
   is the JAX package's (keys ``cache/``, ``draft/``, ``host/``; dtypes
   by numpy name, bf16 widened to fp32; ``host/last_tok`` and
   ``host/pos`` int32), so each package restores the other's snapshot.
3. :class:`IntegrityError` and the validators shared with checkpoint
   restore and recipe load: byte checksums, the code range of quantized
   weights and of the int8 cache, finite and positive scales, and the
   ``kv_pos`` invariant (every entry is -1 or exactly its own row index).
   SplitQuant's compact storage makes each check exact: any drift is
   corruption, never quantization slop.

:func:`recover_engine` composes them: restore the snapshot (if any), then
replay the journal against it — requests retired after the snapshot are
evicted (their output lives in the journal: exactly once across the
crash), requests alive in the snapshot resume from their quantized KV
state, and requests submitted past the snapshot horizon are re-enqueued
from their submit record and re-prefill from scratch. Greedy decoding is
a pure function of the committed prefix and the kernels give the same
bytes on a re-run, so resumed requests regenerate the post-snapshot
tokens bit-identically.
"""
from __future__ import annotations

import json
import os
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

SNAPSHOT_SCHEMA = 1

# arrays.npz key prefixes
_CACHE = "cache/"
_DRAFT = "draft/"
_HOST = "host/"

#: bits of the int8 slot cache's codes
_KV_BITS = 8


class IntegrityError(RuntimeError):
    """A loaded artifact failed validation and must not be served.

    ``reason`` is a stable machine-readable tag: one of ``checksum``,
    ``missing_array``, ``schema``, ``config_mismatch``, ``code_range``,
    ``nonfinite``, ``nonpositive_scale``, ``kv_pos_invalid``.
    """

    def __init__(self, reason: str, msg: str):
        super().__init__(f"[{reason}] {msg}")
        self.reason = reason


def array_checksum(a: np.ndarray) -> str:
    """CRC32 over repr((dtype.str, shape)) and then the raw C-order bytes,
    as ``crc32:xxxxxxxx``."""
    a = np.ascontiguousarray(a)
    h = zlib.crc32(repr((a.dtype.str, a.shape)).encode())
    # the array's own buffer: the bytes ``tobytes()`` would copy
    h = zlib.crc32(a.reshape(-1).view(np.uint8), h)
    return f"crc32:{h:08x}"


def checksum_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, str]:
    return {k: array_checksum(np.asarray(v)) for k, v in arrays.items()}


def _ctx(context: str) -> str:
    return f"{context}: " if context else ""


def verify_checksums(arrays: Dict[str, np.ndarray],
                     want: Dict[str, str], context: str = "") -> None:
    """Compare stored checksums against the loaded arrays; loud on drift."""
    for name, expect in want.items():
        if name not in arrays:
            raise IntegrityError("missing_array",
                                 f"{_ctx(context)}array {name!r} in manifest "
                                 f"but missing from archive")
        got = array_checksum(np.asarray(arrays[name]))
        if got != expect:
            raise IntegrityError("checksum",
                                 f"{_ctx(context)}{name}: stored {expect}, "
                                 f"recomputed {got} — artifact corrupt")


def check_finite(name: str, a: np.ndarray, context: str = "") -> None:
    a = np.asarray(a)
    if a.size and not np.all(np.isfinite(a)):
        n = int(np.sum(~np.isfinite(a)))
        raise IntegrityError("nonfinite",
                             f"{_ctx(context)}{name} has {n} non-finite "
                             f"entries")


def check_positive(name: str, a: np.ndarray, context: str = "") -> None:
    check_finite(name, a, context)
    a = np.asarray(a)
    if a.size and not np.all(a > 0):
        raise IntegrityError("nonpositive_scale",
                             f"{_ctx(context)}{name} has entries <= 0 "
                             f"(min {float(a.min())})")


def check_code_range(name: str, codes: np.ndarray, bits: int,
                     context: str = "") -> None:
    """Quantized codes must lie within the signed ``bits``-bit levels."""
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    c = np.asarray(codes)
    if c.size == 0:
        return
    lo, hi = int(c.min()), int(c.max())
    if lo < qmin or hi > qmax:
        raise IntegrityError("code_range",
                             f"{_ctx(context)}{name} codes span [{lo}, "
                             f"{hi}], outside int{bits} range [{qmin}, "
                             f"{qmax}]")


def validate_cache_arrays(arrays: Dict[str, np.ndarray], mode: str,
                          prefix: str = _CACHE, context: str = "") -> None:
    """Invariant checks for a (snapshotted) SlotKVCache's arrays.

    - ``kv_pos[l, n, t]`` is either -1 (empty) or exactly ``t``: the
      engine writes position t at row t and never wraps, so any other
      value is corruption.
    - int8 mode: codes within the 8-bit levels, scales finite and
      positive, zero-points finite.
    """
    pos = np.asarray(arrays[prefix + "kv_pos"])
    T = pos.shape[-1]
    t = np.arange(T, dtype=pos.dtype)
    bad = ~((pos == -1) | (pos == t))
    if bad.any():
        l, n, tt = (int(x[0]) for x in np.nonzero(bad))
        raise IntegrityError("kv_pos_invalid",
                             f"{_ctx(context)}kv_pos[{l},{n},{tt}] = "
                             f"{int(pos[l, n, tt])}, expected -1 or {tt}")
    if mode == "int8":
        for kk in ("k", "v"):
            check_code_range(prefix + kk, arrays[prefix + kk], _KV_BITS,
                             context)
        for kk in ("k_scale", "v_scale"):
            check_positive(prefix + kk, arrays[prefix + kk], context)
        for kk in ("k_zero", "v_zero"):
            check_finite(prefix + kk, arrays[prefix + kk], context)


# --------------------------------------------------------------------------
# durable request journal
# --------------------------------------------------------------------------

class RequestJournal:
    """Append-only JSONL WAL of request lifecycle transitions.

    The record format is the tracer's (``obs/tracer.py``): one header line
    (``kind=header``, ``schema=1``, ``journal=true`` and ``meta``) and then
    event lines (``kind=event``, ``name`` in the ``obs/schema.py``
    lifecycle vocabulary, ``ts`` in seconds since the journal opened).
    Submit records hold the full prompt, budget, class and deadlines;
    retire records the output tokens.

    ``event()`` buffers; ``sync()`` writes, flushes and fsyncs — the
    engine calls it once per step, making the step boundary the
    durability horizon. ``resume=True`` appends to an existing journal
    without a second header, so the merged crash + recovery file stays one
    valid trace.
    """

    def __init__(self, path: str, clock=time.perf_counter,
                 meta: Optional[dict] = None, resume: bool = False):
        self.path = path
        self.clock = clock
        self.t0 = clock()
        self._buf: List[str] = []
        append = resume and _has_journal_header(path)
        self._f = open(path, "a" if append else "w")
        if not append:
            from ..obs.tracer import SCHEMA_VERSION
            header = {"kind": "header", "schema": SCHEMA_VERSION,
                      "journal": True, **(meta or {})}
            self._f.write(json.dumps(header) + "\n")
            self._flush_fsync()

    def event(self, name: str, **fields) -> None:
        rec = {"kind": "event", "name": name,
               "ts": self.clock() - self.t0, **fields}
        self._buf.append(json.dumps(rec))

    def sync(self) -> None:
        """Make every buffered record durable (write + flush + fsync)."""
        if self._buf:
            self._f.write("\n".join(self._buf) + "\n")
            self._buf.clear()
        self._flush_fsync()

    def _flush_fsync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self.sync()
            self._f.close()

    def __del__(self):  # best effort; sync() per step is the real contract
        try:
            self.close()
        except Exception:
            pass


def _has_journal_header(path: str) -> bool:
    try:
        with open(path) as f:
            first = f.readline()
        rec = json.loads(first)
        return rec.get("kind") == "header"
    except (OSError, ValueError):
        return False


def load_journal(path: str) -> List[dict]:
    from ..obs.tracer import load_jsonl
    return load_jsonl(path)


def replay_journal(records: List[dict]) -> Tuple[Dict[int, dict],
                                                 Dict[int, dict]]:
    """Fold journal records into (submitted, retired) maps keyed by uid:
    ``submitted[uid]`` is the submit record (enough to re-enqueue),
    ``retired[uid]`` the retire record (reason + output tokens). A uid in
    both finished before the crash and must not run again."""
    submitted: Dict[int, dict] = {}
    retired: Dict[int, dict] = {}
    for rec in records:
        if rec.get("kind") != "event":
            continue
        name, uid = rec.get("name"), rec.get("uid")
        if uid is None:
            continue
        if name == "submit":
            submitted[int(uid)] = rec
        elif name == "retire":
            retired[int(uid)] = rec
    return submitted, retired


def compact_journal(path: str) -> Tuple[int, int]:
    """Rewrite the journal without the records a retire made redundant.

    Keeps the header, every record of un-retired uids (still needed for
    replay), the retire records themselves (they carry the output and pin
    exactly-once across restarts) and the engine-scoped records (snapshot
    and restore marks). Atomic via tmp + ``os.replace``. Returns
    (n_records_before, n_records_after).
    """
    records = load_journal(path)
    _, retired = replay_journal(records)
    kept = []
    for rec in records:
        if rec.get("kind") != "event":
            kept.append(rec)
            continue
        uid = rec.get("uid")
        if uid is not None and int(uid) in retired \
                and rec.get("name") != "retire":
            continue
        kept.append(rec)
    from ..obs.atomic import atomic_write_text
    atomic_write_text(path, "".join(json.dumps(rec) + "\n" for rec in kept))
    return len(records), len(kept)


# --------------------------------------------------------------------------
# snapshot / restore
# --------------------------------------------------------------------------

def _req_doc(req) -> dict:
    return {"uid": int(req.uid),
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "out": [int(t) for t in req.out],
            "cls": req.cls,
            "ttft_deadline_s": req.ttft_deadline_s,
            "deadline_s": req.deadline_s,
            "has_first_token": req.t_first_token is not None}


def _req_from_doc(doc: dict, clock) -> Any:
    """An EngineRequest from a snapshot or journal document; the prompt
    comes back as the port's int64 array."""
    from .scheduler import EngineRequest
    req = EngineRequest(uid=int(doc["uid"]),
                        prompt=np.asarray(doc["prompt"], np.int64),
                        max_new_tokens=int(doc["max_new_tokens"]),
                        cls=doc.get("cls", "interactive"),
                        ttft_deadline_s=doc.get("ttft_deadline_s"),
                        deadline_s=doc.get("deadline_s"))
    req.out = [int(t) for t in doc.get("out", [])]
    # wall-clock state does not survive a process: deadlines restart at
    # restore time (DESIGN.md §13)
    req.t_submit = clock()
    if doc.get("has_first_token"):
        req.t_first_token = req.t_submit
    return req


def _engine_fingerprint(eng) -> dict:
    ecfg = eng.ecfg
    return {"arch": eng.cfg.name,
            "n_slots": ecfg.n_slots,
            "max_len": ecfg.max_len,
            "kv_mode": eng.cache.mode,
            "kv_static": bool(eng.cache.static),
            "kv_qchunks": eng.cache.qchunks,
            "spec_k": ecfg.spec_k,
            "draft_mode": (eng._spec.cache.mode
                           if eng._spec is not None else None),
            "vocab": eng.cfg.vocab}


def _dtype_name(dtype) -> str:
    """A torch dtype by its numpy name (``torch.int8`` → ``"int8"``), as
    the JAX package records dtypes."""
    return str(dtype).removeprefix("torch.")


def _store_cache(cache, prefix: str) -> Tuple[Dict[str, np.ndarray],
                                              Dict[str, str]]:
    """(arrays on the host, original dtypes) — bf16 widened to fp32."""
    import torch
    from .kvcache import CACHE_DATA_FIELDS
    arrays, dtypes = {}, {}
    for name in CACHE_DATA_FIELDS:
        x = getattr(cache, name)
        dtypes[prefix + name] = _dtype_name(x.dtype)
        if x.dtype == torch.bfloat16:
            x = x.float()
        arrays[prefix + name] = x.cpu().numpy()
    return arrays, dtypes


def _check_cache(cache, arrays: Dict[str, np.ndarray],
                 dtypes: Dict[str, str], prefix: str) -> None:
    """Every array of ``cache`` is in the snapshot, with its shape and
    dtype; raises before any byte is copied."""
    from .kvcache import CACHE_DATA_FIELDS
    for name in CACHE_DATA_FIELDS:
        key = prefix + name
        if key not in arrays:
            raise IntegrityError("missing_array",
                                 f"snapshot missing {key!r}")
        want = getattr(cache, name)
        if tuple(arrays[key].shape) != tuple(want.shape):
            raise IntegrityError("config_mismatch",
                                 f"{key}: snapshot shape "
                                 f"{tuple(arrays[key].shape)} != engine "
                                 f"shape {tuple(want.shape)}")
        if dtypes.get(key) != _dtype_name(want.dtype):
            raise IntegrityError("config_mismatch",
                                 f"{key}: snapshot dtype {dtypes.get(key)}"
                                 f" != engine dtype "
                                 f"{_dtype_name(want.dtype)}")


def _load_cache(cache, arrays: Dict[str, np.ndarray], prefix: str) -> None:
    """Copy the snapshot's arrays into ``cache``'s preallocated tensors,
    in place, on their device (bf16 narrowed back exactly)."""
    import torch
    from .kvcache import CACHE_DATA_FIELDS
    for name in CACHE_DATA_FIELDS:
        dst = getattr(cache, name)
        dst.copy_(torch.from_numpy(np.ascontiguousarray(
            arrays[prefix + name])).to(dst.dtype))


def snapshot_engine(eng, path: str) -> str:
    """Write the engine's full serving state to ``path``, atomically.

    A tmp directory holding ``arrays.npz`` + ``manifest.json`` (fsync'd)
    is renamed over ``path`` (``obs.atomic.atomic_dir``): a crash
    mid-write leaves the old snapshot or none, never a torn one. The
    caches are copied to the host first (one copy of each tensor).
    ``host/rng`` holds the sampler's ``torch.Generator`` state (uint8),
    where the JAX package stores its PRNG key.
    """
    from ..obs.atomic import atomic_dir
    from ..obs.provenance import provenance

    arrays, dtypes = _store_cache(eng.cache, _CACHE)
    if eng._spec is not None:
        d_arrays, d_dtypes = _store_cache(eng._spec.cache, _DRAFT)
        arrays.update(d_arrays)
        dtypes.update(d_dtypes)
    arrays[_HOST + "last_tok"] = eng._last_tok.astype(np.int32)
    arrays[_HOST + "pos"] = eng._pos.astype(np.int32)
    arrays[_HOST + "prefill_prog"] = eng._prefill_prog.astype(np.int64)
    arrays[_HOST + "fail_streak"] = eng._fail_streak.astype(np.int64)
    arrays[_HOST + "rng"] = eng.generator.get_state().numpy()
    for k in ("last_tok", "pos", "prefill_prog", "fail_streak", "rng"):
        dtypes[_HOST + k] = str(arrays[_HOST + k].dtype)

    sched = eng.sched
    manifest = {
        "schema": SNAPSHOT_SCHEMA,
        "provenance": provenance(),
        "engine": _engine_fingerprint(eng),
        "checksums": checksum_arrays(arrays),
        "dtypes": dtypes,
        "step": len(eng.step_s),
        "uid_next": int(eng._uid),
        "any_deadlines": bool(eng._any_deadlines),
        "n_submitted": int(sched.n_submitted),
        "n_admitted": int(sched.n_admitted),
        "queue": [_req_doc(r) for r in sched.queue],
        "slots": [None if r is None else _req_doc(r) for r in sched.slots],
        "prefilling": [int(s) for s in sched._prefilling],
    }
    final = os.path.abspath(path)
    with atomic_dir(final) as tmp:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
    return final


def read_snapshot(path: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Load and integrity-check a snapshot directory (no engine needed):
    schema version, per-array checksums and the cache invariants; raises
    ``IntegrityError`` before any array could reach an engine."""
    mpath = os.path.join(path, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise IntegrityError("schema", f"{path}: no manifest.json — "
                             f"not a snapshot directory")
    except ValueError as e:
        raise IntegrityError("schema", f"{mpath}: corrupt JSON ({e})")
    if manifest.get("schema") != SNAPSHOT_SCHEMA:
        raise IntegrityError("schema",
                             f"{mpath}: snapshot schema "
                             f"{manifest.get('schema')!r}, expected "
                             f"{SNAPSHOT_SCHEMA}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    verify_checksums(arrays, manifest["checksums"], context=path)
    eng_meta = manifest["engine"]
    validate_cache_arrays(arrays, eng_meta["kv_mode"],
                          prefix=_CACHE, context=path)
    if _DRAFT + "kv_pos" in arrays:
        validate_cache_arrays(arrays, eng_meta.get("draft_mode") or "fp",
                              prefix=_DRAFT, context=path)
    return manifest, arrays


def restore_engine(eng, path: str) -> dict:
    """Restore ``eng`` (freshly constructed, idle) from a snapshot.

    The caller builds the engine with the config the snapshot was taken
    under (the manifest's fingerprint, every array's shape and dtype, and
    the host state's shapes are checked before anything is copied); this
    then copies the cache(s) into the engine's tensors on its device and
    replaces the host decode state, the scheduler's queue and slot table
    and the uid counter. Returns the manifest.

    The sampler's state: a port snapshot carries the ``torch.Generator``
    state, restored so that a sampling engine resumes the same draws. A
    snapshot of the JAX package carries a JAX PRNG key instead (and a
    card's generator state does not fit a CPU generator): a greedy engine
    never draws and ignores it, an engine with ``temperature > 0`` raises
    ``IntegrityError("config_mismatch")`` rather than draw from another
    stream. Across the packages, compare greedy engines only.
    """
    import torch

    manifest, arrays = read_snapshot(path)
    want = _engine_fingerprint(eng)
    got = manifest["engine"]
    if got != want:
        diff = {k: (got.get(k), want[k]) for k in want
                if got.get(k) != want[k]}
        raise IntegrityError("config_mismatch",
                             f"{path}: snapshot engine geometry differs "
                             f"from this engine: {diff} "
                             f"(snapshot, engine)")
    has_draft = _DRAFT + "kv_pos" in arrays
    if has_draft != (eng._spec is not None):
        raise IntegrityError("config_mismatch",
                             f"{path}: snapshot draft-cache presence "
                             f"({has_draft}) does not match engine "
                             f"spec_k={eng.ecfg.spec_k}")
    dtypes = manifest["dtypes"]
    _check_cache(eng.cache, arrays, dtypes, _CACHE)
    if has_draft:
        _check_cache(eng._spec.cache, arrays, dtypes, _DRAFT)
    N = eng.ecfg.n_slots
    for k in ("last_tok", "pos", "prefill_prog", "fail_streak"):
        if arrays[_HOST + k].shape != (N,):
            raise IntegrityError("config_mismatch",
                                 f"{path}: host/{k} has shape "
                                 f"{arrays[_HOST + k].shape}, expected "
                                 f"({N},)")
    rng = arrays[_HOST + "rng"]
    state = None
    if dtypes[_HOST + "rng"] == "uint8" and \
            rng.size == eng.generator.get_state().numel():
        state = torch.from_numpy(rng.copy())
    elif eng.ecfg.temperature > 0:
        raise IntegrityError("config_mismatch",
                             f"{path}: host/rng ({dtypes[_HOST + 'rng']} "
                             f"{rng.shape}) is not this engine's "
                             f"torch.Generator state; a sampling engine "
                             f"cannot resume its draws from it")

    _load_cache(eng.cache, arrays, _CACHE)
    if has_draft:
        _load_cache(eng._spec.cache, arrays, _DRAFT)
    eng._last_tok = arrays[_HOST + "last_tok"].astype(np.int64)
    eng._pos = arrays[_HOST + "pos"].astype(np.int64)
    eng._prefill_prog = arrays[_HOST + "prefill_prog"].astype(np.int64)
    eng._fail_streak = arrays[_HOST + "fail_streak"].astype(np.int64)
    if state is not None:
        eng.generator.set_state(state)
    eng._uid = int(manifest["uid_next"])
    eng._any_deadlines = bool(manifest["any_deadlines"])

    sched = eng.sched
    sched.queue = deque(_req_from_doc(d, eng.clock)
                        for d in manifest["queue"])
    sched.slots = [None if d is None else _req_from_doc(d, eng.clock)
                   for d in manifest["slots"]]
    sched._prefilling = [int(s) for s in manifest["prefilling"]]
    sched.n_submitted = int(manifest["n_submitted"])
    sched.n_admitted = int(manifest["n_admitted"])
    return manifest


def recover_engine(eng, snapshot_path: Optional[str],
                   journal_path: Optional[str]) -> dict:
    """Restore a snapshot and reconcile it against the journal.

    Per journal uid:
      - retired            -> finished before the crash: its output lives
                              in the retire record; if the snapshot still
                              holds it (retired after the snapshot was
                              taken), it is evicted so it cannot run
                              twice.
      - alive in snapshot  -> resumes from its quantized KV state; tokens
                              generated between snapshot and crash are
                              regenerated identically.
      - past the horizon   -> submitted after the snapshot: re-enqueued
                              from the journal's submit record, re-prefills
                              from scratch.

    Returns ``{"manifest", "retired", "n_restored", "n_requeued"}`` —
    ``retired`` maps uid -> retire record, so a supervisor can fold
    pre-crash finishers into its report (those uids never re-enter the
    engine).
    """
    manifest = None
    if snapshot_path and os.path.isdir(snapshot_path):
        manifest = restore_engine(eng, snapshot_path)

    submitted: Dict[int, dict] = {}
    retired: Dict[int, dict] = {}
    if journal_path and os.path.exists(journal_path):
        submitted, retired = replay_journal(load_journal(journal_path))

    sched = eng.sched
    # evict anything the journal says already retired (exactly-once)
    for uid in retired:
        for slot, req in enumerate(sched.slots):
            if req is not None and req.uid == uid:
                eng._evict_slot(slot)
        sched.queue = deque(r for r in sched.queue if r.uid != uid)

    n_restored = sum(1 for r in sched.slots if r is not None) \
        + len(sched.queue)

    # re-enqueue post-horizon submissions, in original uid order
    present = {r.uid for r in sched.slots if r is not None} \
        | {r.uid for r in sched.queue}
    n_requeued = 0
    for uid in sorted(submitted):
        if uid in retired or uid in present:
            continue
        rec = submitted[uid]
        req = _req_from_doc({"uid": uid, "prompt": rec["prompt"],
                             "max_new_tokens": rec["budget"],
                             "cls": rec.get("cls", "interactive"),
                             "ttft_deadline_s": rec.get("ttft_deadline_s"),
                             "deadline_s": rec.get("deadline_s")},
                            eng.clock)
        # straight onto the queue: already journaled at its first submit,
        # so no second submit record and no overload policy re-applied
        sched.queue.append(req)
        if req.ttft_deadline_s is not None or req.deadline_s is not None:
            eng._any_deadlines = True
        n_requeued += 1

    # fresh uids never collide with journaled ones
    eng._uid = max(eng._uid, max(submitted, default=-1) + 1)

    if eng.journal is not None:
        eng.journal.event("restore",
                          snapshot_step=(manifest or {}).get("step"),
                          n_restored=n_restored, n_requeued=n_requeued,
                          n_retired_in_journal=len(retired))
        eng.journal.sync()
    return {"manifest": manifest, "retired": retired,
            "n_restored": n_restored, "n_requeued": n_requeued}
