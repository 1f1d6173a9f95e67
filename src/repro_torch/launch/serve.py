"""Quantized serving entry point of the port: seeded random weights at an
arch's published shapes, SplitQuant-quantized and packed, served by the
continuous-batching engine over an optionally INT8 slot cache, or, with
``--wave`` or for a family without a slot-cache layout (RWKV6), by the
wave loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --bits 4 --kv-mode int8 --requests 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --reduced --requests 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --spec-k 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --wave --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --method percentile --no-fused-attn --prefill-chunk 0 \
        --device cpu

``--spec-k`` serves with self-speculative decoding, the target drafting
for itself (as the JAX package's ``--spec-k`` without a draft recipe).
``--method percentile`` quantizes with the percentile-clipped baseline
(99%), ``--no-fused-attn`` decodes through the materialize read path and
``--prefill-chunk 0`` prefills each prompt in one shot at admission.

Without ``--device`` it runs on the CUDA card, and fails if there is
none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_arch
from ..core.apply import QuantPolicy, quantize_tree
from ..core.quantize import QuantConfig
from ..device import resolve_device
from ..engine import Engine, EngineConfig
from ..models import get_model
from ..runtime.serve_loop import Request, Server, ServeConfig

#: families the continuous-batching engine serves; the others use the
#: wave loop
ENGINE_FAMILIES = ("dense",)


def seeded_prompts(vocab: int, n: int, lo: int, hi: int, seed: int = 0):
    """``n`` prompts of ``lo``..``hi`` tokens drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def build_params(cfg, *, bits: int, method: str, seed: int = 0,
                 device=None):
    """Seeded init of ``cfg``'s family + quantization (SplitQuant k=3, the
    k=1 baseline, or the k=1 percentile-clipped baseline; ``none`` leaves
    the weights in floating point), packed once, on ``device``."""
    params = get_model(cfg).init(cfg, seed=seed, device=device)
    if method == "none":
        return params, None
    policy = QuantPolicy(cfg=QuantConfig(bits=bits), method=method)
    return quantize_tree(params, policy, seed=seed)


def smoke_workload():
    """The full-width serving workload that ``chip_smoke.py`` drives and
    ``launch.profile_engine`` traces: stablelm-1.6b, SplitQuant INT4 k=3
    weights (seed 0), an int8 slot cache of 8 slots x 1024 rows, 96-token
    prefill chunks, one 100-token warm-up prompt, and 16 seeded requests
    of 16-512 prompt tokens and 32 new tokens each.

    Returns (cfg, ecfg, quant, warmup_prompt, prompts), where ``quant``
    holds the keyword arguments of :func:`build_params`."""
    cfg = get_arch("stablelm-1.6b")
    ecfg = EngineConfig(n_slots=8, max_len=1024, max_new_tokens=32,
                        kv_mode="int8", prefill_chunk=96)
    quant = dict(bits=4, method="splitquant", seed=0)
    warmup = seeded_prompts(cfg.vocab, 1, 100, 100, seed=99)[0]
    prompts = seeded_prompts(cfg.vocab, 16, 16, 512, seed=0)
    return cfg, ecfg, quant, warmup, prompts


def bf16_cache_workload():
    """:func:`smoke_workload` over an fp slot cache in bf16 (the JAX
    engine's ``kv_dtype="bfloat16"``): the same stablelm-1.6b weights,
    8 slots x 1024 rows, 96-token chunks and 16 requests, greedy.

    Returns (cfg, ecfg, quant, warmup_prompt, prompts)."""
    cfg, ecfg, quant, warmup, prompts = smoke_workload()
    ecfg = dataclasses.replace(ecfg, kv_mode="fp", kv_dtype="bfloat16")
    return cfg, ecfg, quant, warmup, prompts


def dense_wave_workload():
    """The full-width dense wave-loop workload that ``chip_smoke.py``
    drives: :func:`smoke_workload`'s stablelm-1.6b weights, warm-up prompt
    and 16 requests (16-512 prompt tokens, 32 new tokens each), served by
    the wave ``Server`` in waves of 8 into a KV cache of 1024 rows.

    Returns (cfg, scfg, quant, warmup_prompt, prompts), where ``quant``
    holds the keyword arguments of :func:`build_params`."""
    cfg, _, quant, warmup, prompts = smoke_workload()
    scfg = ServeConfig(max_batch=8, max_new_tokens=32, max_len=1024)
    return cfg, scfg, quant, warmup, prompts


def rwkv_smoke_workload():
    """The full-width wave-loop workload that ``chip_smoke.py`` drives:
    rwkv6-3b, SplitQuant INT4 k=3 weights (seed 0), waves of up to 8,
    one warm-up wave of 8 prompts of 16 tokens, and 16 seeded requests of
    64-256 prompt tokens, each a multiple of 16 (so every wave's padded
    length is one and the chunked WKV carries every prefill), and 32 new
    tokens each.

    Returns (cfg, scfg, quant, warmup_prompts, prompts), where ``quant``
    holds the keyword arguments of :func:`build_params`."""
    cfg = get_arch("rwkv6-3b")
    scfg = ServeConfig(max_batch=8, max_new_tokens=32)
    quant = dict(bits=4, method="splitquant", seed=0)
    rng = np.random.default_rng(0)
    warmup = [rng.integers(0, cfg.vocab, size=16) for _ in range(8)]
    prompts = [rng.integers(0, cfg.vocab, size=16 * int(rng.integers(4, 17)))
               for _ in range(16)]
    return cfg, scfg, quant, warmup, prompts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--method", default="splitquant",
                    choices=["splitquant", "baseline", "percentile",
                             "none"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--wave", action="store_true",
                    help="serve a dense model with the wave loop, not the "
                         "engine")
    ap.add_argument("--slots", type=int, default=4,
                    help="engine slots, or the wave size of the wave loop")
    ap.add_argument("--kv-mode", default="int8", choices=["fp", "int8"])
    ap.add_argument("--fused-attn", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="decode attention reads the slot cache through the "
                         "fused kernel; --no-fused-attn materializes each "
                         "layer's cache and attends it in plain PyTorch "
                         "(the oracle path)")
    ap.add_argument("--prefill-chunk", type=int,
                    default=EngineConfig.prefill_chunk)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="self-speculative decoding: draft tokens per step "
                         "(the target drafts for itself)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain PyTorch versions; default "
                         "is the CUDA card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    t0 = time.perf_counter()
    params, report = build_params(cfg, bits=args.bits, method=args.method,
                                  device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    if report is not None:
        print(f"quantized {len(report['quantized'])} tensors to "
              f"INT{args.bits} ({args.method}) in "
              f"{time.perf_counter() - t0:.2f} s; deployed "
              f"{report['deployed_bytes'] / 2**20:.1f} MiB")
    # the JAX package's launch/serve.py draws the same prompts
    prompts = seeded_prompts(cfg.vocab, args.requests, 4, 11)
    if cfg.family in ENGINE_FAMILIES and not args.wave:
        eng = Engine(cfg, params, EngineConfig(
            n_slots=args.slots, max_len=256,
            max_new_tokens=args.max_new_tokens, kv_mode=args.kv_mode,
            fused_attn=args.fused_attn, prefill_chunk=args.prefill_chunk,
            spec_k=args.spec_k),
            device=device)
        for p in prompts:
            eng.submit(p)
        t0 = time.perf_counter()
        fin = eng.drain()
        how = (f"{eng.n_decode_steps} decode steps, "
               f"{eng.n_prefill_chunks} prefill chunks, "
               f"{eng.n_prefills} one-shot prefills")
        if args.spec_k:
            how += (f", {eng.n_spec_steps} speculative steps, acceptance "
                    f"{eng.sched.acceptance_rate()}")
    else:
        if cfg.family not in ENGINE_FAMILIES:
            print(f"note: {cfg.family!r} family has no slot-cache layout "
                  f"yet; serving with the wave loop")
        srv = Server(cfg, params, ServeConfig(
            max_batch=args.slots, max_new_tokens=args.max_new_tokens),
            device=device)
        t0 = time.perf_counter()
        fin = srv.serve([Request(uid=i, prompt=p)
                         for i, p in enumerate(prompts)])
        how = (f"{len(srv.wave_prefill_s)} waves, "
               f"{len(srv.decode_step_s)} decode steps")
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in fin)
    for r in fin:
        print(f"req {r.uid}: prompt {len(r.prompt)} → {r.out}")
    print(f"{len(fin)} requests, {n_tok} tokens in {dt:.3f} s on "
          f"{device.type} ({n_tok / dt:.1f} tok/s), {how}")


if __name__ == "__main__":
    main()
