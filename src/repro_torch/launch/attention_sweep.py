"""Time the two attention kernels at the serving shapes, for several split
plans, on the card.

    python -m repro_torch.launch.attention_sweep [--out chiprun_out]
    PYTHONPATH=<other tree>/src python <this file> --default-only --out DIR

Decode: 8 slots at max_len 1024 (depths 1000, 513, 0, 17, 256, 777, 64,
1023) and stablelm-1.6b at max_len 4096 (the same depths times 4), int8
cache with 4 scales a head vector, bf16 q, for stablelm-1.6b (32
kv-heads of 64) and chatglm3-6b (2 kv-heads of 128, 16 query heads each).
Prefill: a 96-token chunk at pos_start 384 of a 1024-row slot, same
archs, with the wrapper's two ``quantize_kv`` launches (the K/V write
kernel with a dense destination). For each plan setting
(``BLOCKS_PER_SM``, ``MIN_SPLIT_TILES`` and ``MAX_SPLIT_TILES``
of ``kernels.decode_attention``, ``BLOCKS_PER_SM`` of
``kernels.prefill_attention``) it reports the device time of one call by
kernel (``torch.profiler`` kernel events, the flush's fill kernel left
out, L2 flushed before each of 20 calls after 3 warm-ups), the call's
device time from CUDA events (the host let run ahead of the card by a
sleep on the stream), and the host time of one wrapper call (a loop of
200 calls without a synchronize).
This is the measurement behind the plans' constants.

``--default-only`` times each shape once with the package's own plan and
uses only the wrappers' public signatures, so the same file can time an
older tree of the port (put its ``src`` on ``PYTHONPATH`` and run this
file by path). It also times the K/V cache write at its main-path rows
(a 96-row chunk, the 8-slot decode write, a 4-row verify window; dynamic
and static scales): the two standalone quantizes of K and V, and the
one-launch ``write_kv_rows`` where the tree has it. Writes
``attention_sweep.json`` (``--default-only``:
``attention_default_<label>.json``) under ``--out``.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import prefill_attention as pa

ARCHS = {"stablelm-1.6b": (32, 32, 64), "chatglm3-6b": (32, 2, 128)}
DEPTHS = (1000, 513, 0, 17, 256, 777, 64, 1023)
#: (arch, T) of the decode cases
DECODE_SHAPES = (("stablelm-1.6b", 1024), ("chatglm3-6b", 1024),
                 ("stablelm-1.6b", 4096))
#: (BLOCKS_PER_SM, MIN_SPLIT_TILES, MAX_SPLIT_TILES) of the decode plan
DECODE = ((2, 4, 32), (2, 4, 256), (2, 4, 16), (1, 4, 32), (3, 4, 32),
          (4, 4, 32), (2, 2, 32), (2, 8, 32))
#: BLOCKS_PER_SM of the prefill plan
PREFILL = (1, 2, 3)
SLEEP_CYCLES = 2_000_000           # ~1 ms at the H100's 1.98 GHz


def device_ms(fn, flush: torch.Tensor, reps: int = 20) -> dict:
    """Mean device ms of one call of ``fn`` by kernel (the flush's fill
    kernel left out)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    by = collections.defaultdict(float)
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e and \
                "FillFunctor" not in e["name"]:
            by[kernel_name(e["name"])] += e["dur"] * 1e-3 / reps
    return dict(by)


def kernel_name(full: str) -> str:
    """``void (anonymous namespace)::decode_split_kernel<1, 64, ...>(...)``
    -> ``decode_split_kernel``."""
    name = full.replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split()[-1].split("::")[-1]


def call_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Mean device time of one call from CUDA events, the L2 flushed and
    the host let run ahead (a sleep on the stream) before each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def host_us(fn, reps: int = 200) -> float:
    """Host time of one call, the device left to catch up after."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def _cases(gen):
    """(kernel, arch, T, Hkv, G, wrapper arguments) of every shape."""
    C = 4
    f = lambda *s: torch.randn(s, generator=gen, device="cuda")
    for arch, T in DECODE_SHAPES:
        Hq, Hkv, D = ARCHS[arch]
        q = f(8, Hq, D).to(torch.bfloat16)
        qk, ks, kz = pa.quantize_kv_ref(f(8, T, Hkv, D).to(torch.bfloat16), C)
        qv, vs, vz = pa.quantize_kv_ref(f(8, T, Hkv, D).to(torch.bfloat16), C)
        depths = [d * T // 1024 for d in DEPTHS]
        kv_pos = torch.full((8, T), -1, dtype=torch.int32, device="cuda")
        for n, d in enumerate(depths):
            kv_pos[n, :d] = torch.arange(d, device="cuda", dtype=torch.int32)
        q_pos = torch.tensor([max(d - 1, 0) for d in depths],
                             dtype=torch.int32, device="cuda")
        yield ("decode_attention", arch, T, Hkv, Hq // Hkv,
               (q, qk, qv, kv_pos, q_pos, ks, kz, vs, vz))
    for arch, (Hq, Hkv, D) in ARCHS.items():
        T = 1024
        qp, kn, vn = (f(96, h, D).to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        ck, ks, kz = pa.quantize_kv_ref(f(T, Hkv, D).to(torch.bfloat16), C)
        cv, vs, vz = pa.quantize_kv_ref(f(T, Hkv, D).to(torch.bfloat16), C)
        pos = torch.full((T,), -1, dtype=torch.int32, device="cuda")
        pos[:385] = torch.arange(385, device="cuda", dtype=torch.int32)
        yield ("prefill_attention", arch, T, Hkv, Hq // Hkv,
               (qp, kn, vn, ck, cv, pos, 384, 96, ks, kz, vs, vz))


def _row(kernel, arch, T, fn, flush, **extra) -> dict:
    row = {"kernel": kernel, "arch": arch, "T": T, **extra,
           "device_ms": device_ms(fn, flush), "call_ms": call_ms(fn, flush),
           "host_us": host_us(fn)}
    print(json.dumps(row), flush=True)
    return row


def _wrapper(kernel):
    return da.decode_attention if kernel == "decode_attention" else \
        pa.prefill_attention


def _static_scales(x, C):
    """Static (S, Z) (Hkv, C) of x (R, Hkv, D) from its own range."""
    H, D = x.shape[-2:]
    xc = x.float().reshape(-1, H, C, D // C)
    lo, hi = xc.amin(dim=(0, 3)), xc.amax(dim=(0, 3))
    scale = 255.0 / (hi - lo)
    return scale, -128.0 - scale * lo


def _kv_cases(gen):
    """(call, arch, shape, mode, fn) of the K/V cache write at its
    main-path rows, bf16 K/V: a 96-row chunk at 384 (length 90), the
    8-slot decode write and a 4-row verify window at T - 2 of a layer of
    8 slots x 1024 rows. ``"quantize x2"`` is the two standalone
    quantizes of K and V, through the public ``quantize_kv`` /
    ``quantize_kv_static`` of every tree of the port; ``"write_kv_rows"``
    the one-launch write, where the tree has it."""
    N, T, C = 8, 1024, 4
    f = lambda *s: torch.randn(s, generator=gen, device="cuda")
    depths = torch.tensor(DEPTHS, dtype=torch.int32, device="cuda")
    for arch, (_, Hkv, D) in ARCHS.items():
        for shape, R, kw in (
                ("chunk", 96, dict(slot=3, pos_start=384, length=90)),
                ("decode", N, dict(positions=depths)),
                ("verify window", 4, dict(slot=N - 1, pos_start=T - 2,
                                          length=2))):
            k = (f(R, Hkv, D) * 2).to(torch.bfloat16)
            v = f(R, Hkv, D).to(torch.bfloat16)
            ks, kz = _static_scales(k, C)
            vs, vz = _static_scales(v, C)
            kv_pos = torch.full((N, T), -1, dtype=torch.int32, device="cuda")
            codes = [torch.zeros((N, T, Hkv, D), dtype=torch.int8,
                                 device="cuda") for _ in range(2)]
            dyn = [torch.ones((N, T, Hkv, C), device="cuda")
                   for _ in range(4)]
            for mode in ("dynamic", "static"):
                if mode == "dynamic":
                    quant = lambda k=k, v=v: (pa.quantize_kv(k, C),
                                              pa.quantize_kv(v, C))
                    dst = [*codes, kv_pos, *dyn]
                else:
                    quant = lambda k=k, v=v, s=(ks, kz, vs, vz): (
                        pa.quantize_kv_static(k, *s[:2]),
                        pa.quantize_kv_static(v, *s[2:]))
                    dst = [*codes, kv_pos, ks, kz, vs, vz]
                yield "quantize x2", arch, shape, mode, quant
                if hasattr(pa, "write_kv_rows"):
                    yield ("write_kv_rows", arch, shape, mode,
                           lambda k=k, v=v, dst=dst, kw=kw:
                           pa.write_kv_rows(k, v, *dst, **kw))


def default_only() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    rows = [_row(kernel, arch, T, lambda: _wrapper(kernel)(*args), flush)
            for kernel, arch, T, _, _, args in _cases(gen)]
    rows += [_row(call, arch, 1024, fn, flush, shape=shape, mode=mode)
             for call, arch, shape, mode, fn in _kv_cases(gen)]
    return rows


def sweep() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = (da.BLOCKS_PER_SM, da.MIN_SPLIT_TILES, da.MAX_SPLIT_TILES,
              pa.BLOCKS_PER_SM)
    rows = []
    try:
        for kernel, arch, T, Hkv, G, args in _cases(gen):
            fn = lambda: _wrapper(kernel)(*args)
            if kernel == "decode_attention":
                for bps, lo, hi in DECODE:
                    da.BLOCKS_PER_SM, da.MIN_SPLIT_TILES = bps, lo
                    da.MAX_SPLIT_TILES = hi
                    da.decode_plan.cache_clear()
                    rows.append(_row(
                        kernel, arch, T, fn, flush, blocks_per_sm=bps,
                        min_split_tiles=lo, max_split_tiles=hi,
                        chosen=(bps, lo, hi) == chosen[:3],
                        plan=da.decode_plan(8, T, Hkv, G, sms)._asdict()))
            else:
                for bps in PREFILL:
                    pa.BLOCKS_PER_SM = bps
                    pa.prefill_plan.cache_clear()
                    rows.append(_row(
                        kernel, arch, T, fn, flush, blocks_per_sm=bps,
                        chosen=bps == chosen[3],
                        plan=pa.prefill_plan(96, T, Hkv, G, 384,
                                             sms)._asdict()))
    finally:
        (da.BLOCKS_PER_SM, da.MIN_SPLIT_TILES, da.MAX_SPLIT_TILES,
         pa.BLOCKS_PER_SM) = chosen
        da.decode_plan.cache_clear()
        pa.prefill_plan.cache_clear()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--default-only", action="store_true",
                    help="each shape once, with the package's own plan")
    ap.add_argument("--label", default="this",
                    help="name of the tree in the --default-only file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_sweep needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    rows = default_only() if args.default_only else sweep()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    name = f"attention_default_{args.label}.json" if args.default_only \
        else "attention_sweep.json"
    (out / name).write_text(json.dumps({"card": smi, "rows": rows},
                                       indent=1))


if __name__ == "__main__":
    main()
