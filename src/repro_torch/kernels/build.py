"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, then linked into one shared library under the repository's
``build/`` directory. The library's name carries a hash of the sources,
so an edited kernel is rebuilt and a stale one is never loaded. Objects
and the library are written under temporary names and moved into place
with ``os.replace``, so several processes building at once (pytest
workers on the card) never load a half-written file.

Nothing is built or loaded when this module is imported: the first
kernel launch calls :func:`library`. There is no fallback: a failed
build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile (if needed) and return the path of the shared library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"--- {src.name} (rc {p.returncode})\n{out}")
            elif verbose:
                print(f"--- nvcc {src.name}\n{out}", flush=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / target.name
        link = [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp_so)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_so, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C signature of every exported function; each launcher returns
#: cudaError_t.
SIGNATURES = {
    # x, qp, cp, recip, shift, y, ws, M, K, N, bits, k, x_is_bf16, bm,
    # splits, k_per_split, stream
    "splitquant_matmul": [_P] * 7 + [_I] * 9 + [_P],
    # q, k, v, kv_pos, q_pos, ks, kz, vs, vz, o, part_o, part_ml, counter,
    # N, T, Hq, Hkv, D, C, kv_bytes, kv_f16, stat, q_is_bf16, group, rows,
    # splits, warps, qscale, stream
    "decode_attention": [_P] * 13 + [_I] * 14 + [_F, _P],
    # q, k_new, v_new, ck, cv, kv_pos, ks, kz, vs, vz, wk, wv, wks, wkz,
    # wvs, wvz, o, part_o, part_ml, counter, Sq, T, Hq, Hkv, D, C,
    # pos_start, length, kv_bytes, kv_f16, stat, verify, x_is_bf16,
    # cache_rows, cache_splits, qscale, stream
    "prefill_attention": [_P] * 20 + [_I] * 15 + [_F, _P],
    # k, v, dk, dv, kv_pos, pos, ks, kz, vs, vz, rows, T, Hkv, D, C, slot,
    # pos_start, length, mode, x_is_bf16, dst16 (1 bf16, 2 float16), stream
    "kv_write": [_P] * 10 + [_I] * 11 + [_P],
    # r, k, v, w, u, s0, y, s_out, BH, T, K, V, VS, x_is_bf16, stream
    "wkv_chunked": [_P] * 8 + [_I] * 6 + [_P],
    # r, k, v, w, u, s0, y_bar, s_bar, dr, dk, dv, dw, du, ds0, s_chunk,
    # part, part_u, BH, T, K, V, VS, x_is_bf16, stream
    "wkv_chunked_bwd": [_P] * 17 + [_I] * 6 + [_P],
    # x, qp, cp, recip, shift, offsets, y, R, K, N, E, m_tiles, bits, k,
    # x_is_bf16, stream
    "grouped_splitquant_matmul": [_P] * 7 + [_I] * 8 + [_P],
    # x, q, scale, zero, R, N, n_chunks, bits, x_is_bf16, warps, vecs,
    # stream
    "act_quant_dynamic": [_P] * 4 + [_I] * 7 + [_P],
    # x, scale, zero, q, R, N, n_chunks, bits, x_is_bf16, stream
    "act_quant_static": [_P] * 4 + [_I] * 5 + [_P],
    # bits, bm -> bytes (not an error code)
    "splitquant_matmul_smem": [_I] * 2,
    # D, C, kv_bytes, stat, group, warps -> bytes (not an error code)
    "decode_attention_smem": [_I] * 6,
    # D, C, kv_bytes, T -> bytes (not an error code)
    "prefill_attention_smem": [_I] * 4,
    # K, x_is_bf16 -> bytes (not an error code)
    "wkv_chunked_smem": [_I] * 2,
    # K, VS -> bytes (not an error code)
    "wkv_chunked_bwd_smem": [_I] * 2,
}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.error_string(err).decode()}")


def check_cuda_operands(*tensors) -> None:
    """Every operand of a kernel launch lies on the first one's CUDA
    device (``None`` marks an unused optional operand)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors, got {dev}")
    for t in tensors[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"operand on {t.device}, expected {dev}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


_counters: dict = {}


def merge_counters(kernel: str, device, n: int):
    """``n`` int32 counters of ``kernel`` on ``device`` for the
    last-block merge of a split launch: zeroed once when allocated; the
    kernel sets each one it uses back to 0, so a call leaves them zeroed.
    Launches that share them run in stream order: the port launches every
    kernel on the device's current stream."""
    import torch
    buf = _counters.get((kernel, device))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[(kernel, device)] = buf
    return buf


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device, read as
    PyTorch's own kernel launchers read it: ``torch.cuda.current_stream``
    builds a ``Stream`` object on every call, several µs of host time a
    launch."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)
