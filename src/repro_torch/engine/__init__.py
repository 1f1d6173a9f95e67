"""Continuous-batching engine of the port."""
from .engine import Engine, EngineConfig, bucket_len
from .faults import (DegradationLadder, FaultInjector, FaultSpec,
                     InjectedCrash, StepFailure)
from .kvcache import kv_quality_counters, occupied_slots
from .recovery import (IntegrityError, RequestJournal, compact_journal,
                       read_snapshot)
from .scheduler import (EngineRequest, Scheduler, SubmitError,
                        admission_set_point)

__all__ = ["Engine", "EngineConfig", "EngineRequest", "Scheduler",
           "SubmitError", "bucket_len", "admission_set_point", "FaultSpec",
           "FaultInjector", "DegradationLadder", "StepFailure",
           "InjectedCrash", "IntegrityError", "RequestJournal",
           "compact_journal", "read_snapshot", "occupied_slots",
           "kv_quality_counters"]
