#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. set-up: the card's name and power limit, torch and CUDA versions, and
   the build of every kernel from ``src/repro_torch/kernels/csrc``;
2. kernels: each CUDA kernel of the serving path against its plain
   PyTorch version on the card, at the shapes the main path gives it,
   with its time (CUDA events, warmed up, L2 flushed between launches),
   the plain version's time, a one-call PyTorch yardstick where one
   exists, and the least time the card could take (the larger of bytes
   over 3.35 TB/s and operations over the bf16 tensor-core rate,
   989 TFLOP/s: every kernel's inputs are bf16 or int8). The attention
   kernels do their work as fp32 FMAs on the CUDA cores; the time that
   work needs at 67 TFLOP/s is printed beside the bound as ``fp32_core_ms``
   (in the per-case details), not as the bound;
3. engine: stablelm-1.6b at its published widths (seeded random bf16
   weights, SplitQuant INT4 k=3, quantized on the card) served by the
   continuous-batching engine over an int8 slot cache: 8 slots,
   max_len 1024, 96-token prefill chunks, 16 seeded requests of 16-512
   prompt tokens and 32 new tokens each. Every kernel's launch count is
   set to 0 just before the run and read just after; each must be > 0;
4. cross-check: stablelm-1.6b ``.reduced()`` in fp32 through the engine
   on the card and on the CPU with the same weights: identical greedy
   tokens.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = 989e12                  # dense bf16 tensor-core rate
FP32_CORE_OPS = 67e12              # fp32 outside the tensor cores
TPU_KERNELS = {
    "splitquant_matmul": "src/repro/kernels/splitquant_matmul.py:83",
    "decode_attention": "src/repro/kernels/decode_attention.py:164",
    "prefill_attention": "src/repro/kernels/prefill_attention.py:299",
    "quantize_kv": "src/repro/kernels/prefill_attention.py:232",
}
SOURCES = {
    "splitquant_matmul": "src/repro_torch/kernels/csrc/splitquant_matmul.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "prefill_attention": "src/repro_torch/kernels/csrc/prefill_attention.cu",
    "quantize_kv": "src/repro_torch/kernels/csrc/prefill_attention.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------- timing ---
class Timer:
    """Mean device time of one call: CUDA events around each launch,
    after warm-up, with the L2 cache flushed between launches (the
    serving path meets every weight and cache row cold). The flush is
    large enough (512 MiB, ~0.2 ms of writes) that the host has queued
    the call before the start event fires, so the interval holds the
    call's device time and not the wrapper's host overhead."""

    def __init__(self, torch, reps: int = 10, warmup: int = 2):
        self.torch = torch
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class KernelReport:
    """Per-kernel sums over its cases (same work for every time)."""

    def __init__(self, name: str):
        self.name = name
        self.cases = []

    def add(self, case: str, err: float, tol: float, ms: float,
            plain_ms: float, library_ms, nbytes: float, ops: float):
        b, by = bound_ms(nbytes, ops)
        fp32 = ops / FP32_CORE_OPS * 1e3
        self.cases.append(dict(case=case, max_abs_err=err, tol=tol, ms=ms,
                               plain_ms=plain_ms, library_ms=library_ms,
                               bound_ms=b, bound_by=by, bytes=nbytes,
                               ops=ops, fp32_core_ms=fp32))
        log(f"  {self.name:18s} {case:44s} err {err:.3e} (tol {tol:.1e}) "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
            f"{'-' if library_ms is None else f'{library_ms:.4f}'} ms  "
            f"bound {b:.5f} ms ({by})  fp32-core ops time {fp32:.5f} ms")
        if not err <= tol:
            fail(f"{self.name} {case}: max abs err {err} > tol {tol}")

    def entry(self, launches: int) -> dict:
        tot = lambda k: sum(c[k] for c in self.cases)
        libs = [c["library_ms"] for c in self.cases]
        t_b = sum(c["bytes"] for c in self.cases) / HBM_BYTES_PER_S * 1e3
        t_o = sum(c["ops"] for c in self.cases) / PEAK_OPS * 1e3
        return {"name": self.name, "route": "cuda",
                "source": SOURCES[self.name],
                "replaces": TPU_KERNELS[self.name],
                "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in self.cases),
                "ms": tot("ms"), "plain_ms": tot("plain_ms"),
                "bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "library_ms": None if None in libs else sum(libs),
                "cases": self.cases}


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


# ------------------------------------------------------------ kernels ---
def matmul_cases(torch, timer, rep):
    from repro_torch.kernels.packing import pack_cids
    from repro_torch.kernels.ref import (dequant_weight_ref,
                                         splitquant_matmul_ref)
    from repro_torch.kernels.splitquant_matmul import splitquant_matmul
    gen = torch.Generator(device="cuda").manual_seed(0)
    bits, k = 4, 3
    for K, N in ((2048, 2048), (2048, 5632), (5632, 2048), (2048, 100352)):
        qp = torch.randint(0, 256, (K * bits // 8, N), generator=gen,
                           dtype=torch.uint8, device="cuda")
        cids = torch.randint(0, k, (K, N), generator=gen, device="cuda")
        cp = pack_cids(cids.to(torch.uint8))
        del cids
        recip = (torch.rand((k, N), generator=gen, device="cuda") + 0.5) / 16
        shift = torch.randn((k, N), generator=gen, device="cuda") * 0.05
        w = dequant_weight_ref(qp, cp, recip, shift, bits, torch.bfloat16)
        for M in (8, 96):
            x = torch.randn((M, K), generator=gen,
                            device="cuda").to(torch.bfloat16)
            got = splitquant_matmul(x, qp, cp, recip, shift, bits=bits, k=k)
            want = splitquant_matmul_ref(x, qp, cp, recip, shift, bits)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                fail(f"matmul M={M} K={K} N={N}: non-finite output")
            # bf16 output: one bf16 rounding of an fp32 sum whose order
            # differs from torch's ⇒ ≲ 2^-8 relative to the output scale
            tol = 2 ** -7 * max(1.0, float(want.float().abs().max()))
            nbytes = M * K * 2 + K * N * bits / 8 + K * N / 4 + \
                2 * k * N * 4 + M * N * 2
            rep.add(f"M={M} K={K} N={N} bf16 int4 k=3", max_err(got, want),
                    tol,
                    timer(lambda: splitquant_matmul(x, qp, cp, recip, shift,
                                                    bits=bits, k=k)),
                    timer(lambda: splitquant_matmul_ref(x, qp, cp, recip,
                                                        shift, bits)),
                    timer(lambda: torch.matmul(x, w)),
                    nbytes, 2 * M * K * N)
        del qp, cp, w


def _decode_inputs(torch, gen, N, T, Hq, Hkv, D, C):
    from repro_torch.kernels.prefill_attention import quantize_kv_ref
    q = torch.randn((N, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((N, T, Hkv, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn((N, T, Hkv, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    qk, ks, kz = quantize_kv_ref(k, C)
    qv, vs, vz = quantize_kv_ref(v, C)
    # ragged depths, slot 2 empty
    depths = [1000, 513, 0, 17, 256, 777, 64, 1023][:N]
    kv_pos = torch.full((N, T), -1, dtype=torch.int32, device="cuda")
    for n, d in enumerate(depths):
        kv_pos[n, :d] = torch.arange(d, device="cuda", dtype=torch.int32)
    q_pos = torch.tensor([max(d - 1, 0) for d in depths], dtype=torch.int32,
                         device="cuda")
    return q, qk, qv, kv_pos, q_pos, (ks, kz, vs, vz)


def decode_cases(torch, timer, rep):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref,
                                                      dequant_chunk)
    gen = torch.Generator(device="cuda").manual_seed(1)
    N, T, C = 8, 1024, 4
    for arch, Hq, Hkv, D in (("stablelm-1.6b", 32, 32, 64),
                             ("chatglm3-6b", 32, 2, 128)):
        q, qk, qv, kv_pos, q_pos, sc = _decode_inputs(torch, gen, N, T, Hq,
                                                      Hkv, D, C)
        got = decode_attention(q, qk, qv, kv_pos, q_pos, *sc)
        want = decode_attention_ref(q, qk, qv, kv_pos, q_pos, *sc)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()) or \
                not bool((got[2] == 0).all()):
            fail(f"decode {arch}: non-finite output or non-zero empty slot")
        tol = 2 ** -7 * max(1.0, float(want.float().abs().max()))
        # yardstick: SDPA over the dequantized cache with the same mask
        kd = dequant_chunk(qk, sc[0], sc[1]).to(torch.bfloat16)
        vd = dequant_chunk(qv, sc[2], sc[3]).to(torch.bfloat16)
        valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
        G = Hq // Hkv                 # heads expanded before timing
        qs = q[:, :, None]
        ks_ = kd.transpose(1, 2).repeat_interleave(G, 1)
        vs_ = vd.transpose(1, 2).repeat_interleave(G, 1)
        mask = valid[:, None, None, :]
        lib = timer(lambda: F.scaled_dot_product_attention(
            qs, ks_, vs_, attn_mask=mask))
        E = int(valid.sum())          # live (slot, row) entries this run
        nbytes = E * Hkv * (2 * D + 2 * 2 * C * 4) + N * T * 4 + N * 4 + \
            2 * N * Hq * D * 2
        rep.add(f"{arch} N={N} T={T} Hq={Hq} Hkv={Hkv} D={D} int8",
                max_err(got, want), tol,
                timer(lambda: decode_attention(q, qk, qv, kv_pos, q_pos,
                                               *sc)),
                timer(lambda: decode_attention_ref(q, qk, qv, kv_pos, q_pos,
                                                   *sc)),
                lib, nbytes, 4 * E * Hq * D)


def prefill_cases(torch, timer, rep, qrep):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import dequant_chunk
    from repro_torch.kernels.prefill_attention import (prefill_attention,
                                                       prefill_attention_ref,
                                                       quantize_kv,
                                                       quantize_kv_ref)
    gen = torch.Generator(device="cuda").manual_seed(2)
    T, C, Sq, pos_start, length = 1024, 4, 96, 384, 96
    for arch, Hq, Hkv, D in (("stablelm-1.6b", 32, 32, 64),
                             ("chatglm3-6b", 32, 2, 128)):
        f = lambda *s: torch.randn(s, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, kn, vn = f(Sq, Hq, D), f(Sq, Hkv, D), f(Sq, Hkv, D)
        ck, ks, kz = quantize_kv_ref(f(T, Hkv, D), C)
        cv, vs, vz = quantize_kv_ref(f(T, Hkv, D), C)
        sc = (ks, kz, vs, vz)
        kv_pos = torch.full((T,), -1, dtype=torch.int32, device="cuda")
        kv_pos[:pos_start + 1] = torch.arange(pos_start + 1, device="cuda",
                                              dtype=torch.int32)
        # row pos_start is the decode ride-along garbage row: masked
        got, gaux = prefill_attention(q, kn, vn, ck, cv, kv_pos, pos_start,
                                      length, *sc)
        want = prefill_attention_ref(q, kn, vn, ck, cv, kv_pos, pos_start,
                                     length, *sc)
        wk, wv = quantize_kv_ref(kn, C), quantize_kv_ref(vn, C)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            fail(f"prefill {arch}: non-finite output")
        for a, b in zip(gaux, (wk[0], wv[0], wk[1], wk[2], wv[1], wv[2])):
            if not torch.equal(a, b):
                fail(f"prefill {arch}: epilogue codes/scales differ from "
                     f"quantize_kv")
        tol = 2 ** -7 * max(1.0, float(want.float().abs().max()))
        kd = dequant_chunk(ck, ks, kz).to(torch.bfloat16)
        vd = dequant_chunk(cv, vs, vz).to(torch.bfloat16)
        G = Hq // Hkv                 # heads expanded before timing
        keys = torch.cat([kd, kn], 0).transpose(0, 1)[None]
        vals = torch.cat([vd, vn], 0).transpose(0, 1)[None]
        keys = keys.repeat_interleave(G, 1)
        vals = vals.repeat_interleave(G, 1)
        cache_ok = (kv_pos >= 0) & (kv_pos < pos_start)
        idx = torch.arange(Sq, device="cuda")
        causal = (idx[None, :] <= idx[:, None]) & (idx[None, :] < length)
        mask = torch.cat([cache_ok[None].expand(Sq, T), causal], 1)[None, None]
        qs = q.transpose(0, 1)[None]
        lib = timer(lambda: F.scaled_dot_product_attention(
            qs, keys, vals, attn_mask=mask))
        Ec = int(cache_ok.sum())
        pairs = sum(min(i + 1, length) for i in range(Sq))
        nbytes = Ec * Hkv * (2 * D + 2 * 2 * C * 4) + T * 4 + \
            (Sq * Hq * D * 2) * 2 + 2 * Sq * Hkv * D * 2 + \
            2 * Sq * Hkv * (D + 2 * C * 4)
        rep.add(f"{arch} Sq={Sq} pos_start={pos_start} T={T} Hkv={Hkv} "
                f"D={D}", max_err(got, want), tol,
                timer(lambda: prefill_attention(q, kn, vn, ck, cv, kv_pos,
                                                pos_start, length, *sc)),
                timer(lambda: prefill_attention_ref(
                    q, kn, vn, ck, cv, kv_pos, pos_start, length, *sc)),
                lib, nbytes, 4 * Hq * D * (Ec * Sq + pairs))
        # the quantize kernel alone, at its two main-path shapes: the
        # prefill epilogue (Sq, Hkv, D) and the decode write (N, Hkv, D)
        for what, x in (("prefill chunk", kn), ("decode write",
                                                f(8, Hkv, D))):
            got_q = quantize_kv(x, C)
            want_q = quantize_kv_ref(x, C)
            torch.cuda.synchronize()
            err = max(max_err(a, b) for a, b in zip(got_q, want_q))
            n = x.numel()
            qrep.add(f"{arch} {what} {tuple(x.shape)}", err, 0.0,
                     timer(lambda: quantize_kv(x, C)),
                     timer(lambda: quantize_kv_ref(x, C)), None,
                     n * 2 + n + 2 * (n // (D // C)) * 4, 4 * n)


# ------------------------------------------------------------- engine ---
def percentile(xs, p):
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p))


def engine_phase(torch, counters):
    from repro_torch.engine import Engine
    from repro_torch.launch.serve import build_params, smoke_workload
    from repro_torch.models import transformer

    cfg, ecfg, quant, warmup, prompts = smoke_workload()
    device = "cuda"
    t0 = time.perf_counter()
    params, report = build_params(cfg, device=device, **quant)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    log(f"engine: stablelm-1.6b full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}), init + SplitQuant INT4 k=3 of "
        f"{len(report['quantized'])} matrices on the card in {t_quant:.2f} s"
        f" ({report['deployed_bytes'] / 2**20:.1f} MiB packed)")
    warm = Engine(cfg, params, ecfg, device=device)
    warm.submit(warmup, 4)
    warm.drain()
    del warm
    eng = Engine(cfg, params, ecfg, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p)
    fin = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(r.out) for r in fin)
    if len(fin) != 16 or any(len(r.out) != 32 for r in fin):
        fail(f"engine: expected 16 requests x 32 tokens, got "
             f"{[len(r.out) for r in fin]}")
    if any(not 0 <= t < cfg.vocab for r in fin for t in r.out):
        fail("engine: token id out of vocab")
    for name, n in launches.items():
        if n <= 0:
            fail(f"engine: kernel {name} was not launched on the main path")
    # the logits the engine samples from are finite at full width
    logits = transformer.decode_step_slots(
        params, cfg, eng.cache,
        torch.tensor([[r.out[-1]] for r in fin[:8]], device=device),
        torch.full((8,), 700, dtype=torch.int32, device=device))
    if logits.shape != (8, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail("engine: non-finite or misshapen logits at full width")
    ttft = [r.ttft for r in fin]
    res = {"arch": cfg.name, "requests": len(fin), "new_tokens": n_tok,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "setup_quantize_s": t_quant, "wall_s": wall,
           "ttft_p50_s": percentile(ttft, 50),
           "ttft_p90_s": percentile(ttft, 90),
           "decode_step_p50_s": percentile(eng.decode_step_s, 50),
           "prefill_chunk_p50_s": percentile(eng.prefill_chunk_s, 50),
           "decode_steps": eng.n_decode_steps,
           "prefill_chunks": eng.n_prefill_chunks,
           "tokens_per_s": n_tok / wall, "peak_mem_bytes": peak,
           "kv_cache_bytes": eng.cache.nbytes(), "launches": launches}
    log(f"engine: {len(fin)} requests, {res['prompt_tokens']} prompt + "
        f"{n_tok} new tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} "
        f"tok/s; TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms; decode step p50 "
        f"{res['decode_step_p50_s'] * 1e3:.2f} ms; prefill chunk p50 "
        f"{res['prefill_chunk_p50_s'] * 1e3:.2f} ms; {eng.n_decode_steps} "
        f"decode steps, {eng.n_prefill_chunks} prefill chunks; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    return res


def cross_check(torch):
    from repro_torch.configs import get_arch
    from repro_torch.core.apply import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg = get_arch("stablelm-1.6b").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", seed=0,
                             device="cpu")
    prompts = seeded_prompts(cfg.vocab, 8, 16, 200, seed=1)
    outs = {}
    for dev, p in (("cpu", params), ("cuda", tree_to(params, "cuda"))):
        eng = Engine(cfg, p, EngineConfig(n_slots=4, max_len=256,
                                          max_new_tokens=16, kv_mode="int8",
                                          prefill_chunk=96), device=dev)
        for pr in prompts:
            eng.submit(pr)
        outs[dev] = [r.out for r in eng.drain()]
    same = outs["cpu"] == outs["cuda"]
    log(f"cross-check: stablelm-1.6b reduced fp32, int8 KV, 8 requests x 16 "
        f"tokens: card tokens {'==' if same else '!='} CPU tokens")
    if not same:
        fail(f"cross-check: card {outs['cuda']} != cpu {outs['cpu']}")
    return {"requests": len(prompts), "identical": same}


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port (src/repro_torch) is not next to chip_smoke.py: {e}")
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.prefill_attention import (prefill_attention,
                                                       quantize_kv)
    from repro_torch.kernels.splitquant_matmul import splitquant_matmul

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"card: {card_line}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.library()
    t_build = time.perf_counter() - t0
    log(f"build: {lib_path.name} in {t_build:.1f} s")

    timer = Timer(torch)
    reps = {n: KernelReport(n) for n in TPU_KERNELS}
    log("kernels vs plain versions (bf16, main-path shapes):")
    matmul_cases(torch, timer, reps["splitquant_matmul"])
    decode_cases(torch, timer, reps["decode_attention"])
    prefill_cases(torch, timer, reps["prefill_attention"],
                  reps["quantize_kv"])

    counters = {"splitquant_matmul": splitquant_matmul,
                "decode_attention": decode_attention,
                "prefill_attention": prefill_attention,
                "quantize_kv": quantize_kv}
    eng = engine_phase(torch, counters)
    xc = cross_check(torch)

    kernels = [reps[n].entry(eng["launches"][n]) for n in TPU_KERNELS]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card_line, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_s": t_build, "engine": eng,
         "cross_check": xc, "kernels": kernels,
         "total_s": time.perf_counter() - t_start}, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line)
    log(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "cases"}
                                for e in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
