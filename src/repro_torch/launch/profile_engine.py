"""Where the serving time goes: device traces of the engine at full width.

    python -m repro_torch.launch.profile_engine [--out chiprun_out] \
        [--wave | --spec | --train]

Builds the engine of ``chip_smoke.py`` from
:func:`~repro_torch.launch.serve.smoke_workload` (stablelm-1.6b, seeded
bf16 weights, SplitQuant INT4 k=3, int8 slot cache, 8 slots, max_len
1024, 96-token chunks, 16 seeded requests of 16-512 prompt tokens and
32 new tokens each) and records two windows under ``torch.profiler``: the admission of the
first wave (prefill-heavy: every step until all 8 slots decode) and
12 steps with all 8 slots decoding. For each window it reports,
from the trace's kernel events:

* the device busy share (union of kernel intervals over the window's
  wall time) — the rest is time the card waits for the host;
* device time and launch count by kernel, the port's kernels by name,
  and the window's kernel launches in all (and per step), and its
  device memory copies and fills (a copy between contiguous tensors of
  one dtype, a slice assignment among them, is a ``cudaMemcpyAsync``, not
  a kernel; the busy share counts kernels only);
* the wall times of the window's decode steps and prefill chunks.

``--wave`` traces the rwkv6-3b wave loop of
:func:`~repro_torch.launch.serve.rwkv_smoke_workload` instead: the first
wave's prefill (8 prompts, one forward and the greedy pick) and the 12
decode steps after it, through the ``Server.prefill_wave`` and
``Server.decode_wave`` that ``Server.serve`` runs.

``--spec`` traces the speculative engine of ``chip_smoke.py``'s spec
phase: the same model and workload's first 8 requests, static KV scales
from ``calib.collect_kv_stats`` over 4 seeded prompts of 256 tokens, an
INT2 SplitQuant k=3 draft (dequantized once to bf16) and spec_k 3; after
the admission of the 8 requests, a window of 6 speculative steps, with
each draft pass and each verify pass marked (``torch.profiler``
``record_function``): their count, wall time, the device busy time inside
them, their launches, copies and fills and their kernels by name.

``--train`` traces training: 3 steps of ``launch.train``'s stablelm-1.6b
and of its rwkv6-3b (the WKV kernel and its backward kernel in every
layer) at full width (bf16, batch 8 x 128, remat, fp32 AdamW states)
after 2 warm-up steps each, and 20 steps of ``launch.table1``'s bert-tiny fine-tuning
(batch 32 x 64) after 5, with each step and each AdamW update marked:
the update's share of the step, the device busy share and the kernels
of each.

Runs on the CUDA card only. Writes ``profile_engine.json`` (or
``profile_wave.json``, ``profile_spec.json``, ``profile_train.json``)
under ``--out`` (the traces themselves are parsed and dropped).
"""
from __future__ import annotations

import argparse
import collections
import json
import time
from pathlib import Path

import torch

from ..device import resolve_device
from ..engine import Engine
from ..runtime.serve_loop import Request, Server, ServeConfig
from ..runtime.train_loop import UPDATE_RANGE
from .serve import build_params, rwkv_smoke_workload, smoke_workload

DECODE_STEPS = 12
SPEC_STEPS = 6
#: the ranges a speculative step is cut into by --spec
SPEC_RANGES = ("draft pass", "verify pass")

#: device-kernel name fragments of the port's CUDA kernels
PORT_KERNELS = {"sq_matmul_wgmma_kernel": "splitquant_matmul (bf16 wgmma)",
                "sq_matmul_fp32_kernel": "splitquant_matmul (fp32 CUDA cores)",
                "split_reduce_kernel": "splitquant_matmul (K-split sum)",
                "decode_split_kernel": "decode_attention",
                "prefill_tc_kernel": "prefill_attention (bf16 tensor cores)",
                "prefill_fp32_kernel": "prefill_attention (fp32 CUDA cores)",
                "kv_write_kernel": "kv_write (K/V cache write)",
                "wkv_kernel": "wkv_chunked"}


def _label(name: str) -> str:
    for frag, label in PORT_KERNELS.items():
        if frag in name:
            return label
    return "other: " + name[:60]


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def profile_window(run, scratch: Path, ranges=()) -> dict:
    """Trace ``run()`` (returns its step count) and summarize its
    kernels; for each name in ``ranges`` (``record_function`` labels
    inside ``run``), also the count and wall time of its ranges and the
    kernels that ran inside them."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(scratch))
    events = json.loads(scratch.read_text())["traceEvents"]
    scratch.unlink()
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    copies = [e["ts"] for e in events
              if e.get("cat") in ("gpu_memcpy", "gpu_memset") and "dur" in e]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernel")
    by = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        acc = by[_label(e["name"])]
        acc[0] += e["dur"]
        acc[1] += 1
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels]
    busy = _union(spans) * 1e-6
    rows = sorted(by.items(), key=lambda kv: -kv[1][0])
    out = {"steps": steps, "wall_s": wall, "device_busy_s": busy,
           "device_busy_share": busy / wall, "launches": len(kernels),
           "copies": len(copies),
           "kernels": [{"name": k, "device_s": v[0] * 1e-6, "count": v[1]}
                       for k, v in rows]}
    for name in ranges:
        marks = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") == name and "dur" in e]
        inside = collections.defaultdict(lambda: [0.0, 0])
        busy_in = 0.0
        for lo, hi in marks:
            busy_in += _union(_clip(spans, lo, hi))
            for e in kernels:
                if lo <= e["ts"] < hi:
                    acc = inside[_label(e["name"])]
                    acc[0] += e["dur"]
                    acc[1] += 1
        wall_in = sum(hi - lo for lo, hi in marks) * 1e-6
        out[name] = {
            "count": len(marks), "wall_s": wall_in,
            "device_busy_s": busy_in * 1e-6,
            "device_busy_share": busy_in * 1e-6 / wall_in if marks else None,
            "launches": sum(v[1] for v in inside.values()),
            "copies": sum(lo <= t < hi for lo, hi in marks for t in copies),
            "kernels": [{"name": k, "device_s": v[0] * 1e-6, "count": v[1]}
                        for k, v in sorted(inside.items(),
                                           key=lambda kv: -kv[1][0])]}
    return out


def engine_window(eng, run, scratch: Path) -> dict:
    """:func:`profile_window` plus the engine's step times in it."""
    n_dec, n_pre = len(eng.decode_step_s), len(eng.prefill_chunk_s)
    w = profile_window(run, scratch)
    w["decode_step_s"] = eng.decode_step_s[n_dec:]
    w["prefill_chunk_s"] = eng.prefill_chunk_s[n_pre:]
    return w


def _print(title: str, w: dict, ranges=()) -> None:
    print(f"{title}: {w['steps']} steps; wall {w['wall_s'] * 1e3:.1f} ms, "
          f"device busy {w['device_busy_s'] * 1e3:.1f} ms "
          f"({100 * w['device_busy_share']:.1f}%); {w['launches']} launches "
          f"({w['launches'] / w['steps']:.1f} a step), {w['copies']} copies "
          f"and fills ({w['copies'] / w['steps']:.1f} a step)")
    for k in w["kernels"][:12]:
        print(f"  {k['device_s'] * 1e3:10.3f} ms  {k['count']:7d}  "
              f"{k['name']}")
    for name in ranges:
        r = w[name]
        print(f"  {name}: {r['count']} ranges, wall {r['wall_s'] * 1e3:.1f} "
              f"ms, device busy {r['device_busy_s'] * 1e3:.1f} ms, "
              f"{r['launches']} launches "
              f"({r['launches'] / max(r['count'], 1):.1f} a range), "
              f"{r['copies']} copies and fills "
              f"({r['copies'] / max(r['count'], 1):.1f} a range)")
        for k in r["kernels"][:8]:
            print(f"    {k['device_s'] * 1e3:10.3f} ms  {k['count']:7d}  "
                  f"{k['name']}")


def profile_engine(device, scratch: Path) -> dict:
    cfg, ecfg, quant, warmup, prompts = smoke_workload()
    params, _ = build_params(cfg, device=device, **quant)
    warm = Engine(cfg, params, ecfg, device=device)
    warm.submit(warmup, 4)
    warm.drain()
    eng = Engine(cfg, params, ecfg, device=device)
    for p in prompts:
        eng.submit(p)

    def admit_wave():
        # the first step admits 8 requests and, with nobody decoding,
        # prefills until one joins the decode batch; go on until every
        # slot is decoding
        n = 0
        while eng.sched.free_slots() or eng.sched.prefill_slots() or n == 0:
            eng.step()
            n += 1
        return n

    def decode_window():
        for _ in range(DECODE_STEPS):
            eng.step()
        return DECODE_STEPS

    return {"arch": cfg.name, "card": torch.cuda.get_device_name(0),
            "admission": engine_window(eng, admit_wave, scratch),
            "decode": engine_window(eng, decode_window, scratch)}


def profile_spec(device, scratch: Path) -> dict:
    import dataclasses

    import numpy as np

    from ..calib import collect_kv_stats, kv_static_scales
    cfg, ecfg, quant, warmup, prompts = smoke_workload()
    ecfg = dataclasses.replace(ecfg, spec_k=3)
    params, _ = build_params(cfg, device=device, **quant)
    draft, _ = build_params(cfg, device=device, **dict(quant, bits=2))
    calib = np.random.default_rng(7).integers(0, cfg.vocab, size=(4, 256))
    scales = kv_static_scales(collect_kv_stats(cfg, params, [calib]))
    kw = dict(device=device, kv_scales=scales, draft_params=draft)
    warm = Engine(cfg, params, ecfg, **kw)
    warm.submit(warmup, 4)
    warm.drain()
    del warm
    eng = Engine(cfg, params, ecfg, **kw)
    del draft
    for p in prompts[:8]:
        eng.submit(p)
    while eng.sched.free_slots() or eng.sched.prefill_slots() or \
            not eng.sched.active_slots():
        eng.step()
    # mark each draft pass and each verify pass for the trace
    draft_fn, verify_fn = eng._spec.draft, eng._verify

    def marked(fn, name):
        def run(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return run

    eng._spec.draft = marked(draft_fn, SPEC_RANGES[0])
    eng._verify = marked(verify_fn, SPEC_RANGES[1])

    def spec_window():
        for _ in range(SPEC_STEPS):
            eng.step()
        return SPEC_STEPS

    window = profile_window(spec_window, scratch, SPEC_RANGES)
    return {"arch": cfg.name, "card": torch.cuda.get_device_name(0),
            "spec_k": ecfg.spec_k, "active_slots": len(eng.sched.active_slots()),
            "spec": window}


def profile_wave(device, scratch: Path) -> dict:
    cfg, scfg, quant, warmup, prompts = rwkv_smoke_workload()
    params, _ = build_params(cfg, device=device, **quant)
    srv = Server(cfg, params, ServeConfig(max_batch=8, max_new_tokens=2),
                 device=device)
    srv.serve([Request(i, p) for i, p in enumerate(warmup)])
    wave = prompts[:scfg.max_batch]
    carry = {}

    def prefill():
        carry["cache"], carry["tok"], _ = srv.prefill_wave(wave)
        return 1

    def decode_window():
        for _ in range(DECODE_STEPS):
            carry["cache"], carry["tok"], _ = srv.decode_wave(carry["cache"],
                                                              carry["tok"])
        return DECODE_STEPS

    return {"arch": cfg.name, "card": torch.cuda.get_device_name(0),
            "padded_prompt_len": max(len(p) for p in wave),
            "prefill": profile_window(prefill, scratch),
            "decode": profile_window(decode_window, scratch)}


#: the ranges a training step is cut into by --train
TRAIN_RANGES = ("train step", UPDATE_RANGE)


def _train_window(step, params, opt, batches, warm: int, scratch: Path):
    """Run ``warm`` steps of ``step`` on the first batches, then trace
    the rest, each step marked (the step marks its own AdamW update)."""
    for b in batches[:warm]:
        params, opt, _ = step(params, opt, b)

    def window():
        nonlocal params, opt
        for b in batches[warm:]:
            with torch.profiler.record_function(TRAIN_RANGES[0]):
                params, opt, m = step(params, opt, b)
                m["loss"].item()
        return len(batches) - warm

    return profile_window(window, scratch, TRAIN_RANGES)


def profile_train(device, scratch: Path) -> dict:
    from ..configs import get_arch
    from ..data import DataConfig, synthetic_lm_batch
    from ..data.classification import batches as cls_batches
    from ..data.classification import emotion_like, split
    from ..models import bert_tiny, get_model
    from ..optim import adamw
    from ..runtime.train_loop import make_train_step
    out = {"card": torch.cuda.get_device_name(0)}
    for arch in ("stablelm-1.6b", "rwkv6-3b"):
        cfg = get_arch(arch)
        model = get_model(cfg)
        oc = adamw.OptConfig(total_steps=5, warmup_steps=1)
        params = model.init(cfg, seed=0, device=device)
        step = make_train_step(
            lambda p, b, m=model, c=cfg: m.loss_fn(p, c, b, remat=True), oc)
        dc = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8)
        lm = [synthetic_lm_batch(dc, s, device=device) for s in range(5)]
        torch.cuda.reset_peak_memory_stats(device)
        out[arch] = _train_window(step, params, adamw.init(oc, params), lm,
                                  2, scratch)
        out[arch]["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
        del params, step, lm
        torch.cuda.empty_cache()
    bcfg = get_arch("bert-tiny")
    tr, _ = split(emotion_like(), 3200)
    bparams = bert_tiny.init(bcfg, tr.n_classes, max_len=tr.seq_len,
                             device=device)
    boc = adamw.OptConfig(lr=3e-4, total_steps=800, warmup_steps=50,
                          weight_decay=0.01)
    bstep = make_train_step(lambda p, b: bert_tiny.loss_fn(p, bcfg, b), boc)
    data = list(cls_batches(tr, 32, device=device))[:25]
    out["bert-tiny"] = _train_window(bstep, bparams,
                                     adamw.init(boc, bparams), data, 5,
                                     scratch)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--wave", action="store_true",
                      help="trace the rwkv6-3b wave loop, not the engine")
    mode.add_argument("--spec", action="store_true",
                      help="trace the speculative engine's steps")
    mode.add_argument("--train", action="store_true",
                      help="trace training steps (stablelm-1.6b and "
                           "rwkv6-3b at full width, bert-tiny)")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    scratch = out / "profile_trace.tmp.json"
    if args.train:
        res = profile_train(device, scratch)
        (out / "profile_train.json").write_text(json.dumps(res, indent=1))
        print(f"training on {res['card']}")
        for arch in ("stablelm-1.6b", "rwkv6-3b"):
            _print(f"{arch}, 3 steps of 8 x 128 (bf16, remat, fp32 AdamW "
                   f"states)", res[arch], TRAIN_RANGES)
            print(f"  peak memory "
                  f"{res[arch]['peak_mem_bytes'] / 2**30:.2f} GiB")
        _print("bert-tiny, 20 steps of 32 x 64 (fp32)", res["bert-tiny"],
               TRAIN_RANGES)
        return
    if args.spec:
        res = profile_spec(device, scratch)
        (out / "profile_spec.json").write_text(json.dumps(res, indent=1))
        print(f"{res['arch']} on {res['card']}, spec_k {res['spec_k']}, "
              f"{res['active_slots']} slots decoding")
        _print(f"{SPEC_STEPS} speculative steps", res["spec"], SPEC_RANGES)
        return
    if args.wave:
        res = profile_wave(device, scratch)
        (out / "profile_wave.json").write_text(json.dumps(res, indent=1))
        print(f"{res['arch']} on {res['card']}")
        _print(f"wave prefill (8 prompts padded to {res['padded_prompt_len']}"
               f")", res["prefill"])
        _print("decode window (a wave of 8 decoding)", res["decode"])
        return
    res = profile_engine(device, scratch)
    (out / "profile_engine.json").write_text(json.dumps(res, indent=1))
    print(f"{res['arch']} on {res['card']}")
    _print("admission window (prefill-heavy)", res["admission"])
    _print("decode window (8 slots decoding)", res["decode"])

if __name__ == "__main__":
    main()
