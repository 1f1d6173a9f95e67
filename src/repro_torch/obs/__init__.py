"""Observability of the port (its own copies of ``repro.obs``): the
tmp + fsync + rename protocol every artifact is written through
(``atomic``), the provenance header (``provenance``), the default-off
tracer and its record format (``tracer``; the request journal is written
in it too) with the validator (``schema``) and the phase-breakdown /
waterfall aggregation (``report``), the empty-guarded summary math
(``summary``), the quantization-quality counters (``quality``), the
always-on metrics registry (``metrics``) with its act-quant probe
(``RegistryQuantProbe``) and JSONL snapshots (``SnapshotWriter``,
``load_snapshots``), and the always-on flight
recorder and incident bundles (``flight``) with the anomaly detectors
that trigger them (``detect``).
"""
from .atomic import atomic_dir, atomic_write_text
from .detect import DETECTORS, AnomalyDetector, Firing
from .flight import (FlightRecorder, load_incident_bundle, tail_lines,
                     write_incident_bundle)
from .metrics import (DEPTH_BUCKETS, LATENCY_BUCKETS_S, RESTORE_BUCKETS_S,
                      Counter, Gauge, Histogram, MetricsRegistry,
                      RegistryQuantProbe, SnapshotWriter, default_registry,
                      load_snapshots)
from .provenance import git_revision, provenance
from .quality import ActQuantProbe, code_stats, span_stats
from .report import lifecycle_summary, phase_breakdown, request_waterfalls
from .schema import KINDS, LIFECYCLE, PHASES, RETIRE_REASONS, \
    validate_events
from .summary import mean, pct, summarize, token_agreement
from .tracer import SCHEMA_VERSION, Tracer, chrome_trace, load_jsonl

__all__ = [
    "Tracer", "SCHEMA_VERSION", "chrome_trace", "load_jsonl",
    "PHASES", "LIFECYCLE", "RETIRE_REASONS", "KINDS", "validate_events",
    "phase_breakdown", "request_waterfalls", "lifecycle_summary",
    "pct", "mean", "summarize", "token_agreement",
    "ActQuantProbe", "code_stats", "span_stats",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "default_registry",
    "RegistryQuantProbe", "SnapshotWriter", "load_snapshots",
    "LATENCY_BUCKETS_S", "DEPTH_BUCKETS", "RESTORE_BUCKETS_S",
    "provenance", "git_revision",
    "atomic_write_text", "atomic_dir",
    "FlightRecorder", "write_incident_bundle", "load_incident_bundle",
    "tail_lines", "AnomalyDetector", "Firing", "DETECTORS",
]
