"""Integrity primitives shared by checkpoint restore and recipe load (port
of the integrity part of ``repro.engine.recovery``).

One set of checks: byte checksums, the code range of quantized weights,
finite scales, and strictly positive KV scales. A failed check raises
:class:`IntegrityError` with the JAX package's ``reason`` tags, and the
checksums are the JAX package's strings for the same numpy arrays, so
each package verifies the other's artifacts. SplitQuant's compact storage
makes every check exact: any drift is corruption, never quantization
slop.

The journal, the engine snapshot and ``validate_cache_arrays`` are not
ported yet.
"""
from __future__ import annotations

import zlib
from typing import Dict

import numpy as np


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
