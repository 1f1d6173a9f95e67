"""Observability of the port (its own copies of ``repro.obs``): the
tmp + fsync + rename protocol every artifact is written through
(``atomic``), the provenance header (``provenance``), the trace record
format and its validator (``tracer``, ``schema``) that the request
journal is written in, the empty-guarded summary math (``summary``) and
the always-on metrics registry (``metrics``).
"""
from .atomic import atomic_dir, atomic_write_text
from .metrics import (DEPTH_BUCKETS, LATENCY_BUCKETS_S, RESTORE_BUCKETS_S,
                      Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .provenance import git_revision, provenance
from .schema import KINDS, LIFECYCLE, PHASES, RETIRE_REASONS, \
    validate_events
from .summary import mean, pct, summarize, token_agreement
from .tracer import SCHEMA_VERSION, load_jsonl

__all__ = [
    "atomic_write_text", "atomic_dir", "provenance", "git_revision",
    "SCHEMA_VERSION", "load_jsonl",
    "PHASES", "LIFECYCLE", "RETIRE_REASONS", "KINDS", "validate_events",
    "pct", "mean", "summarize", "token_agreement",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "default_registry",
    "LATENCY_BUCKETS_S", "DEPTH_BUCKETS", "RESTORE_BUCKETS_S",
]
