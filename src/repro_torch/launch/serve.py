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

Calibrated serving: ``--save-recipe DIR`` runs the offline step once
(quantize the weights, collect static KV scales over seeded calibration
prompts, write a quantized checkpoint and a QuantRecipe, in the JAX
package's formats) and exits; ``--recipe DIR`` then serves from it: the
weights restore pre-quantized (no k-means at start-up) and the int8 cache
takes the recipe's static scales. ``--ckpt-dir`` restores the params half
of a training checkpoint before quantizing.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --bits 2 --save-recipe /tmp/rec --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --recipe /tmp/rec --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --spec-k 3 --draft-recipe /tmp/rec --device cpu

``--spec-k`` serves with self-speculative decoding, the target drafting
for itself, or the draft minted from ``--draft-recipe``.
``--method percentile`` quantizes with the percentile-clipped baseline
(99%), ``--no-fused-attn`` decodes through the materialize read path and
``--prefill-chunk 0`` prefills each prompt in one shot at admission.

Without ``--device`` it runs on the CUDA card, and fails if there is
none.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..calib import QuantRecipe, collect_kv_stats, kv_static_scales
from ..checkpoint import ckpt
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


def load_recipe_params(recipe_dir, params, arch=None, reduced=None):
    """(params, recipe, kv_scales) from a saved QuantRecipe: restore the
    pre-quantized checkpoint if the recipe points at one (no k-means; on
    the device of ``params``), else apply the recipe's per-path policies
    to the dense ``params``.

    ``arch``/``reduced``: when given, checked against the recipe's
    provenance, so a mismatched recipe fails here and not deep inside a
    checkpoint lookup or a shape error."""
    rec = QuantRecipe.load(recipe_dir)
    if arch is not None and rec.arch and rec.arch != arch:
        raise ValueError(f"recipe {recipe_dir!r} was calibrated for arch "
                         f"{rec.arch!r}, serving {arch!r}")
    if reduced is not None and "reduced" in rec.meta \
            and bool(rec.meta["reduced"]) != bool(reduced):
        raise ValueError(f"recipe {recipe_dir!r} was calibrated with "
                         f"reduced={rec.meta['reduced']}, serving "
                         f"reduced={reduced}")
    ck = rec.resolve_ckpt_dir(recipe_dir)
    if ck is not None:
        params, step = ckpt.restore(ck, params)
        print(f"recipe: restored pre-quantized weights (step {step}) — "
              f"no k-means at startup")
    elif rec.policies:
        params, report = quantize_tree(params, QuantPolicy(), seed=0,
                                       overrides=rec.policies)
        print(f"recipe: quantized {len(report['quantized'])} tensors from "
              f"recipe policies ({report['deployed_bytes']/2**20:.1f} MiB)")
    return params, rec, rec.kv_scales


def save_recipe(recipe_dir, cfg, params, *, arch: str, bits: int,
                method: str, reduced: bool) -> QuantRecipe:
    """Offline calibration: quantize the dense ``params`` uniformly, measure
    KV ranges over the JAX package's seeded calibration prompts (4 batches
    of 4 x 48 tokens), and write a quantized checkpoint (``ckpt/``) and a
    QuantRecipe pointing at it under ``recipe_dir``."""
    policy = QuantPolicy(cfg=QuantConfig(bits=bits), method=method)
    qtree, report = quantize_tree(params, policy, seed=0)
    kv_scales = None
    if cfg.family in ENGINE_FAMILIES:
        rng = np.random.default_rng(0)
        # long calibration prompts: RoPE'd K ranges depend on position,
        # so coverage must reach past the serving prompt lengths
        calib = [rng.integers(0, cfg.vocab, size=(4, 48)) for _ in range(4)]
        kv_scales = kv_static_scales(
            collect_kv_stats(cfg, qtree, calib, qchunks=4))
    os.makedirs(recipe_dir, exist_ok=True)
    ckpt.save(os.path.join(recipe_dir, "ckpt"), 0, qtree)
    rec = QuantRecipe(
        name=f"{cfg.name}-int{bits}-{method}", arch=arch,
        policies={p: {"bits": d["bits"], "k": d["k"], "method": d["method"]}
                  for p, d in report["per_path"].items()},
        kv_scales=kv_scales, kv_qchunks=4, ckpt_dir="ckpt",
        meta={"deployed_bytes": report["deployed_bytes"],
              "orig_bytes": report["orig_bytes"], "reduced": reduced})
    rec.save(recipe_dir)
    print(f"saved recipe + quantized ckpt to {recipe_dir} "
          f"({report['deployed_bytes']/2**20:.1f} MiB deployed)")
    return rec


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
    ap.add_argument("--draft-recipe", default=None,
                    help="calibration recipe dir the speculative draft is "
                         "minted from (needs --spec-k)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore trained weights (the params half of a "
                         "training checkpoint) before quantizing")
    ap.add_argument("--recipe", default=None,
                    help="serve from a saved calibration recipe dir: "
                         "pre-quantized weights + static KV scales")
    ap.add_argument("--save-recipe", default=None,
                    help="run offline calibration, write recipe + "
                         "quantized ckpt to this dir, and exit")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain PyTorch versions; default "
                         "is the CUDA card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.draft_recipe and not args.spec_k:
        raise ValueError(
            "--draft-recipe only takes effect with --spec-k > 0 — the "
            "recipe would be silently ignored and serving would proceed "
            "plain-greedy")
    t0 = time.perf_counter()
    params = get_model(cfg).init(cfg, seed=0, device=device)
    if args.ckpt_dir:
        (params, _), step = ckpt.restore(args.ckpt_dir, (params, None))
        print(f"restored step {step}")
    if args.save_recipe:
        save_recipe(args.save_recipe, cfg, params, arch=args.arch,
                    bits=args.bits, method=args.method, reduced=args.reduced)
        return
    kv_scales, kv_qchunks = None, EngineConfig.kv_qchunks
    if args.recipe:
        params, rec, kv_scales = load_recipe_params(
            args.recipe, params, arch=args.arch, reduced=args.reduced)
        kv_qchunks = rec.kv_qchunks        # scales are (L, Hkv, kv_qchunks)
        if args.kv_mode != "int8":
            kv_scales = None               # static scales only apply to int8
    elif args.method != "none":
        params, report = quantize_tree(params, QuantPolicy(
            cfg=QuantConfig(bits=args.bits), method=args.method), seed=0)
        if device.type == "cuda":
            torch.cuda.synchronize()
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
            kv_qchunks=kv_qchunks, fused_attn=args.fused_attn,
            prefill_chunk=args.prefill_chunk, spec_k=args.spec_k,
            draft_recipe=args.draft_recipe),
            device=device, kv_scales=kv_scales)
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
