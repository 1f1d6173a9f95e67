"""Calibration of the port: the KV part of ``repro.calib`` (static
per-layer K/V scales for the engine's int8 slot cache)."""
from .stats import collect_kv_stats, kv_static_scales, static_qparams

__all__ = ["collect_kv_stats", "kv_static_scales", "static_qparams"]
