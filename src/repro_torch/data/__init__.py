"""Data of the port: the stateless synthetic LM pipeline
(:mod:`.pipeline`) and the synthetic classification tasks of the paper's
Table 1 (:mod:`.classification`)."""
from .pipeline import DataConfig, Prefetcher, synthetic_lm_batch
from . import classification

__all__ = ["DataConfig", "Prefetcher", "classification",
           "synthetic_lm_batch"]
