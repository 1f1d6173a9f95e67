"""Always-on flight recorder + incident bundles (port of
``repro.obs.flight``, DESIGN.md §14), in the JAX package's formats: each
package loads the other's bundles.

The tracer is default-off and the metrics registry is a point-in-time
aggregate; neither answers "what happened in the 200 steps before the
engine quarantined slot 3" on a box where nobody thought to pass
``--trace``. The flight recorder is the black box: a small bounded ring
of coarse per-step records that is *always* recording, one dict and a
ring append a step.

One record per engine step, one flat dict per record:

  step        engine step index (monotone)
  ts          seconds since recorder start
  step_s      step wall-clock seconds
  decode_s    wall of the decode/verify pass inside the step (coarse
              launch + device time; host-side work is step_s - decode_s;
              the fine dispatch/wait split needs --trace)
  draft_s     wall of the draft pass (spec mode; 0.0 otherwise)
  queue       admission queue depth at end of step
  backlog     queued prefill tokens (admission set-point signal)
  occupied    slots holding a request
  decoding    slots actively decoding at step start
  rung        degradation rung (0 = full fidelity)
  retries     cumulative injected-step retries
  quarantined cumulative requests retired as "failed"
  accept      scheduler speculative-acceptance EWMA (None w/o spec)
  spec_off    True when the ladder has suspended speculation this step
  clip_frac   latest KV clip-fraction sample (None until first sample)
  span_frac   latest KV outlier-span sample (None until first sample)
  uids        uids active in slots this step

Incident bundles snapshot the ring plus everything else a postmortem
needs (metrics, journal tail, fingerprint, provenance, request docs)
into a directory written with the tmp+fsync+rename protocol
(``obs.atomic``) — a crash mid-dump never leaves a half bundle.
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Callable, Deque, Dict, List, Optional

from .atomic import atomic_dir

__all__ = [
    "FLIGHT_SCHEMA",
    "BUNDLE_SCHEMA",
    "FlightRecorder",
    "write_incident_bundle",
    "load_incident_bundle",
    "tail_lines",
]

FLIGHT_SCHEMA = 1
BUNDLE_SCHEMA = 1

#: Files every bundle must contain (beyond MANIFEST.json).
BUNDLE_FILES = (
    "trigger.json",
    "flight.json",
    "metrics.json",
    "fingerprint.json",
    "provenance.json",
    "requests.json",
)


class FlightRecorder:
    """Bounded ring of per-step records; always on, never exported unless
    an incident (or the operator) asks for the window."""

    def __init__(self, capacity: int = 512,
                 clock: Callable[[], float] = time.perf_counter,
                 meta: Optional[Dict[str, Any]] = None):
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self.meta = dict(meta or {})
        self.t0 = clock()
        self.records: Deque[Dict[str, Any]] = collections.deque(
            maxlen=self.capacity)
        self.n_recorded = 0

    def record(self, **fields: Any) -> Dict[str, Any]:
        """Append one per-step record; returns it (for the detector sweep)."""
        rec = {"ts": round(self.clock() - self.t0, 6)}
        rec.update(fields)
        self.records.append(rec)
        self.n_recorded += 1
        return rec

    @property
    def dropped(self) -> int:
        return self.n_recorded - len(self.records)

    def window(self) -> List[Dict[str, Any]]:
        """Oldest-to-newest copy of the retained ring."""
        return list(self.records)

    def header(self) -> Dict[str, Any]:
        return {"schema": FLIGHT_SCHEMA, "capacity": self.capacity,
                "recorded": self.n_recorded, "dropped": self.dropped,
                **self.meta}


def tail_lines(path: str, n: int = 200) -> List[str]:
    """Last ``n`` lines of a text file ('' -> []); missing file -> []."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    return lines[-n:] if n >= 0 else lines


def write_incident_bundle(incident_dir: str, name: str,
                          docs: Dict[str, Any]) -> str:
    """Atomically write one incident bundle directory.

    ``docs`` maps file names to content: ``.json`` values are serialized
    with ``json.dump``; ``.jsonl`` values must be lists of pre-rendered
    lines. A MANIFEST.json listing every file is written last and
    fsynced, then the whole directory is renamed into place — the
    snapshot protocol, so a bundle either exists completely or not at
    all. Returns the final bundle path.
    """
    os.makedirs(incident_dir, exist_ok=True)
    final = os.path.join(os.path.abspath(incident_dir), name)
    with atomic_dir(final) as tmp:
        files = []
        for fname, content in docs.items():
            fpath = os.path.join(tmp, fname)
            with open(fpath, "w") as f:
                if fname.endswith(".jsonl"):
                    for line in content:
                        f.write(line.rstrip("\n") + "\n")
                else:
                    json.dump(content, f, indent=1, sort_keys=True,
                              default=str)
            files.append(fname)
        manifest = {"schema": BUNDLE_SCHEMA, "name": name,
                    "files": sorted(files)}
        mpath = os.path.join(tmp, "MANIFEST.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
    return final


def load_incident_bundle(path: str) -> Dict[str, Any]:
    """Load a bundle directory into ``{file name: parsed content}``.

    Raises ``ValueError`` on a structurally broken bundle (missing
    manifest, wrong schema, listed file absent or unparseable) so
    ``incident_report --validate`` can turn it into a nonzero exit.
    """
    mpath = os.path.join(path, "MANIFEST.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except OSError as e:
        raise ValueError(f"bundle manifest missing: {mpath} ({e})")
    except json.JSONDecodeError as e:
        raise ValueError(f"bundle manifest corrupt: {mpath} ({e})")
    if manifest.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(
            f"bundle schema {manifest.get('schema')!r} != {BUNDLE_SCHEMA}")
    out: Dict[str, Any] = {"MANIFEST.json": manifest}
    for fname in manifest.get("files", []):
        fpath = os.path.join(path, fname)
        try:
            with open(fpath) as f:
                if fname.endswith(".jsonl"):
                    out[fname] = [json.loads(ln) for ln in f
                                  if ln.strip()]
                else:
                    out[fname] = json.load(f)
        except OSError as e:
            raise ValueError(f"bundle file missing: {fname} ({e})")
        except json.JSONDecodeError as e:
            raise ValueError(f"bundle file corrupt: {fname} ({e})")
    for fname in BUNDLE_FILES:
        if fname not in out:
            raise ValueError(f"bundle lacks required file: {fname}")
    return out
