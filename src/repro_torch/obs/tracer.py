"""The trace record format (port of the format half of
``repro.obs.tracer``): JSONL, one ``header`` record (``schema`` =
:data:`SCHEMA_VERSION`) and then one ``span``, ``event`` or ``counter``
record a line (``obs/schema.py``). The request journal
(``engine/recovery.RequestJournal``) writes it, and each package reads
the other's journal. The ``Tracer`` itself is not ported yet.
"""
from __future__ import annotations

import json

SCHEMA_VERSION = 1


def load_jsonl(path: str) -> list[dict]:
    """Load a JSONL event log (header record first)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
