"""Continuous-batching engine of the port."""
from .engine import Engine, EngineConfig, bucket_len
from .scheduler import EngineRequest, Scheduler, SubmitError

__all__ = ["Engine", "EngineConfig", "EngineRequest", "Scheduler",
           "SubmitError", "bucket_len"]
