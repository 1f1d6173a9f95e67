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

Reliability (DESIGN.md §12-§13): ``--max-queue N`` bounds the submit
queue (``--overload-policy`` picks who is shed), ``--degrade`` arms the
degradation ladder, ``--faults SPEC`` injects a seeded fault storm (and
checks the chaos invariants after the drain), ``--journal`` writes the
request journal, ``--snapshot DIR --snapshot-every N`` snapshots the
engine, ``--supervise N`` restarts a crashed engine in-process and
recovers it, ``--recover-from DIR`` recovers in a fresh process after a
real crash (``crash_kill=1``), and ``--drain-timeout`` /
``--drain-stall-steps`` bound the drain.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --device cpu --faults crash=0.2,seed=1,max=1 \
        --journal /tmp/j.jsonl --snapshot /tmp/snap --snapshot-every 2 \
        --supervise 1
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --device cpu --faults crash=0.2,seed=1,max=1,crash_kill=1 \
        --journal /tmp/j.jsonl --snapshot /tmp/snap --snapshot-every 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --device cpu --journal /tmp/j.jsonl --snapshot /tmp/snap \
        --recover-from /tmp/snap

Observability (DESIGN.md §10, §14): ``--trace PATH`` records the engine's
lifecycle events and phase spans (dispatch vs device wait; a profiling
mode with a device sync after each prefill chunk) and writes them as
JSONL, ``--trace-chrome PATH`` also as a Chrome / Perfetto trace, and
``--trace-kv-every N`` samples the int8 cache's quality counters into the
trace; ``--incident-dir DIR`` arms the anomaly detectors, which write
incident bundles there (read them with
``python -m repro_torch.launch.incident_report``), and the supervisor
dumps one from a crashed engine before it restarts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --device cpu --trace /tmp/t.jsonl --trace-chrome \
        /tmp/t.json --trace-kv-every 2 --incident-dir /tmp/inc \
        --faults exception=0.2,seed=3,max=2

``--spec-k`` serves with self-speculative decoding, the target drafting
for itself, or the draft minted from ``--draft-recipe``.
``--method percentile`` quantizes with the percentile-clipped baseline
(99%), ``--no-fused-attn`` decodes through the materialize read path and
``--prefill-chunk 0`` prefills each prompt in one shot at admission.

Metrics snapshots: ``--metrics-snapshot PATH`` streams the metrics
registry as JSONL while serving (a provenance header, then one snapshot
at most every ``--metrics-interval`` seconds and one at drain; read it
with ``obs.load_snapshots``), and installs ``obs.RegistryQuantProbe`` on
the act-quant kernels' observed wrappers.

The MoE family (moonshot-v1-16b-a3b, kimi-k2-1t-a32b) serves through
the engine, speculatively (``--spec-k``; on the card the draft stays
packed) and through the wave loop (``--wave``; a wave prefill of more
than 512 tokens drops the pairs past each expert's capacity, as in JAX);
its experts run through the grouped SplitQuant matmul on the card. At
full width the weights are built part by part (:func:`build_params`):
moonshot-v1-16b-a3b's bf16 tree alone is 56.8 GB. kimi-k2-1t-a32b at
full width serves its first :data:`KIMI_CARD_LAYERS` layers (every width
kept; the 61 would not fit one card).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch moonshot-v1-16b-a3b --reduced --device cpu \
        --metrics-snapshot /tmp/m.jsonl --metrics-interval 0

The VLM family (paligemma-3b: head_dim 256, MQA, a tied head) serves
text requests through the engine and the wave loop, as the JAX
launcher does; its patch prefix is ``transformer.prefill``'s
(``batch["patch_embeds"]``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
        --reduced --device cpu

griffin (recurrentgemma-9b, the hybrid family: RG-LRU blocks and local
MQA attention over a ring of ``window`` rows) serves through the wave
loop, as the JAX launcher does; at full width it is built part by part.
whisper-tiny (audio) does not serve: its forward needs the stub
frontend's frames, and the JAX package's wave ``Server`` passes only
tokens. ``--spec-k`` on a family without a slot cache raises with the
family's reason, as the JAX launcher does.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --reduced --device cpu

Without ``--device`` it runs on the CUDA card, and fails if there is
none.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time

import numpy as np
import torch

from ..calib import QuantRecipe, collect_kv_stats, kv_static_scales
from ..checkpoint import ckpt
from ..configs import get_arch
from ..core.apply import LeafQuantizer, QuantPolicy, quantize_tree
from ..core.quantize import QuantConfig
from ..device import resolve_device
from ..engine import (Engine, EngineConfig, FaultSpec, InjectedCrash,
                      occupied_slots)
from ..engine.engine import ENGINE_FAMILIES   # the others: the wave loop
from ..engine.scheduler import OVERLOAD_POLICIES
from ..models import get_model, griffin, transformer
from ..runtime.serve_loop import Request, Server, ServeConfig


def seeded_prompts(vocab: int, n: int, lo: int, hi: int, seed: int = 0):
    """``n`` prompts of ``lo``..``hi`` tokens drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def build_params(cfg, *, bits: int, method: str, seed: int = 0,
                 device=None):
    """Seeded init of ``cfg``'s family + quantization (SplitQuant k=3, the
    k=1 baseline, or the k=1 percentile-clipped baseline; ``none`` leaves
    the weights in floating point), packed once, on ``device``. Returns
    (params, the quantization report or None).

    A decoder or griffin is built layer by layer: each part of the tree is quantized
    as soon as ``transformer.init`` has drawn it and its floating-point
    copy dropped, so the card never holds the whole bf16 tree; the packed
    bytes are those of ``quantize_tree(init(...))`` (the same draws, the
    same leaf order and k-means seeds)."""
    model = get_model(cfg)
    if method == "none":
        return model.init(cfg, seed=seed, device=device), None
    policy = QuantPolicy(cfg=QuantConfig(bits=bits), method=method)
    if model in (transformer, griffin):
        q = LeafQuantizer(policy, seed)
        return model.init(cfg, seed=seed, device=device,
                          on_part=q.part), q.report
    return quantize_tree(model.init(cfg, seed=seed, device=device), policy,
                         seed=seed)


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


def moe_smoke_workload():
    """The full-width MoE serving workload that ``chip_smoke.py`` drives:
    moonshot-v1-16b-a3b as the JAX package's config gives it, uncut (48
    layers, MHA 16 x 128; not checked against the published config: 1
    dense of FFN width 11264, then 47 MoE of 64 experts, top-6, 2 shared,
    d_ff 1408; d_model 2048, 16 heads of 128, vocab 163840, bf16),
    SplitQuant INT4 k=3 weights (seed 0), and :func:`smoke_workload`'s
    engine settings and request shapes: an int8 slot cache of 8 slots x
    1024 rows, 96-token prefill chunks, one 100-token warm-up prompt, 16
    seeded requests of 16-512 prompt tokens and 32 new tokens each.

    Returns (cfg, ecfg, quant, warmup_prompt, prompts), where ``quant``
    holds the keyword arguments of :func:`build_params`."""
    _, ecfg, quant, _, _ = smoke_workload()
    cfg = get_arch("moonshot-v1-16b-a3b")
    warmup = seeded_prompts(cfg.vocab, 1, 100, 100, seed=99)[0]
    prompts = seeded_prompts(cfg.vocab, 16, 16, 512, seed=0)
    return cfg, ecfg, quant, warmup, prompts


#: kimi-k2-1t-a32b's depth on one 80 GB card: the dense prelude and 4 of
#: its 60 MoE layers (:func:`kimi_smoke_workload`)
KIMI_CARD_LAYERS = 5


def kimi_smoke_workload():
    """The full-width kimi-k2-1t-a32b workload that ``chip_smoke.py``
    drives: the JAX package's config (d_model 7168, GQA 64/8 at head_dim
    112, 384 experts top-8 of d_ff 2048 with 1 shared, a dense prelude of
    FFN 18432, vocab 163840, bf16; its attention is the JAX config's
    approximation, not checked against the published model) cut to
    :data:`KIMI_CARD_LAYERS` layers, every width kept: at ~0.75 B a
    parameter a MoE layer packs to ~12.8 GB, so the prelude, 4 MoE layers,
    the bf16 embedding and the lm_head deploy ~55 GB and leave the build
    its working set (one expert stack in bf16, 11.3 GB) on an 80 GB
    card; a fifth MoE layer would not. SplitQuant INT4 k=3 weights (seed
    0), and :func:`smoke_workload`'s engine settings and request shapes:
    an int8 slot cache of 8 slots x 1024 rows (sub-channel chunks of 28),
    96-token prefill chunks, one 100-token warm-up prompt, 16 seeded
    requests of 16-512 prompt tokens and 32 new tokens each.

    Returns (cfg, ecfg, quant, warmup_prompt, prompts)."""
    _, ecfg, quant, _, _ = smoke_workload()
    cfg = dataclasses.replace(get_arch("kimi-k2-1t-a32b"),
                              n_layers=KIMI_CARD_LAYERS)
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


def f16_cache_workload():
    """:func:`smoke_workload` over an fp slot cache in float16 (the JAX
    engine's ``kv_dtype="float16"``): the same stablelm-1.6b weights,
    8 slots x 1024 rows, 96-token chunks and 16 requests, greedy.

    Returns (cfg, ecfg, quant, warmup_prompt, prompts)."""
    cfg, ecfg, quant, warmup, prompts = smoke_workload()
    ecfg = dataclasses.replace(ecfg, kv_mode="fp", kv_dtype="float16")
    return cfg, ecfg, quant, warmup, prompts


def vlm_smoke_workload():
    """The full-width VLM serving workload that ``chip_smoke.py`` drives:
    paligemma-3b as the JAX package's config gives it, uncut (18 layers,
    d_model 2048, MQA 8 heads / 1 kv-head of head_dim 256, d_ff 16384
    geglu, vocab 257216, the head tied to the embedding table, a
    1152 -> 2048 patch projection; bf16), SplitQuant INT4 k=3 weights
    (seed 0), and :func:`smoke_workload`'s engine settings and request
    shapes: an int8 slot cache of 8 slots x 1024 rows (sub-channel
    chunks of 64 columns at qchunks 4), 96-token prefill chunks, one
    100-token warm-up prompt, 16 seeded requests of 16-512 prompt tokens
    and 32 new tokens each. The requests are text, as the JAX engine
    serves a VLM; the patch prefix enters through ``transformer.prefill``.

    Returns (cfg, ecfg, quant, warmup_prompt, prompts)."""
    _, ecfg, quant, _, _ = smoke_workload()
    cfg = get_arch("paligemma-3b")
    warmup = seeded_prompts(cfg.vocab, 1, 100, 100, seed=99)[0]
    prompts = seeded_prompts(cfg.vocab, 16, 16, 512, seed=0)
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


def griffin_smoke_workload():
    """The full-width griffin workload that ``chip_smoke.py`` drives:
    recurrentgemma-9b as the JAX package's config gives it, uncut (38
    layers: 12 groups of (rec, rec, attn) and 2 trailing recurrent
    layers; d_model 4096, MQA 16/1 at head_dim 256 over a window of 2048,
    RG-LRU width 4096, geglu d_ff 12288, vocab 256000, bf16), SplitQuant
    INT4 k=3 weights (seed 0), and :func:`rwkv_smoke_workload`'s wave
    shapes: waves of up to 8, one warm-up wave of 8 prompts of 16 tokens,
    16 seeded requests of 64-256 prompt tokens and 32 new tokens each.

    Returns (cfg, scfg, quant, warmup_prompts, prompts), where ``quant``
    holds the keyword arguments of :func:`build_params`."""
    _, scfg, quant, warmup, prompts = rwkv_smoke_workload()
    return get_arch("recurrentgemma-9b"), scfg, quant, warmup, prompts


def griffin_ring_workload():
    """:func:`griffin_smoke_workload`'s weights past the window: one wave
    of 4 seeded prompts of 2100-2400 tokens (longer than the 2048-row
    ring), 32 new tokens each. Returns (cfg, scfg, prompts)."""
    cfg, _, _, _, _ = griffin_smoke_workload()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(2100,
                                                                 2401)))
               for _ in range(4)]
    return cfg, ServeConfig(max_batch=4, max_new_tokens=32), prompts


def whisper_smoke_workload():
    """The full-width whisper workload that ``chip_smoke.py`` drives:
    whisper-tiny as the JAX package's config gives it, uncut (4 encoder
    and 4 decoder layers, d_model 384, 6 heads of 64, enc_seq 1500, vocab
    51865, the head tied; bf16), SplitQuant INT4 k=3 weights and biases
    (seed 0), and two batches of 8, each seeded stub frames
    (8, 1500, 384) and 8 prompts of one length (16 tokens, then 48),
    decoded greedily for 32 tokens by ``whisper.prefill`` and
    ``whisper.decode_step``, as the JAX package's model tests drive it.

    Returns (cfg, quant, batches, new_tokens): each batch (frames (8,
    1500, 384) float32, tokens (8, S) int64) as numpy."""
    cfg = get_arch("whisper-tiny")
    quant = dict(bits=4, method="splitquant", seed=0)
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((8, cfg.enc_seq, cfg.d_model),
                                    dtype=np.float32),
                rng.integers(0, cfg.vocab, size=(8, S)))
               for S in (16, 48)]
    return cfg, quant, batches, 32


def serve_engine(args, cfg, params, device, kv_scales, kv_qchunks, prompts,
                 max_queue):
    """The engine half of :func:`main`: build the engine, submit the
    prompts (or recover with ``--recover-from``), drain under the
    supervisor, check the chaos invariants, write the metrics. Returns
    (finished requests, uid → journal retire record of the requests
    finished before a crash, a summary of the run, the seconds from the
    first submit or the recovery to the end of the drain)."""
    base_faults = FaultSpec.parse(args.faults) if args.faults else None

    def mk_engine(registry=None, resume=False, faults=base_faults):
        return Engine(cfg, params, EngineConfig(
            n_slots=args.slots, max_len=256,
            max_new_tokens=args.max_new_tokens, kv_mode=args.kv_mode,
            kv_qchunks=kv_qchunks, fused_attn=args.fused_attn,
            prefill_chunk=args.prefill_chunk, spec_k=args.spec_k,
            draft_recipe=args.draft_recipe,
            # a MoE draft stays packed on the card: its experts run
            # through the grouped kernel (dequantized, moonshot's INT4
            # stacks alone are 56 GB in bf16)
            draft_dequantize=not (cfg.family == "moe" and
                                  device.type == "cuda"),
            metrics=not args.no_metrics,
            max_queue=max_queue, overload_policy=args.overload_policy,
            degrade=args.degrade, fault_spec=faults,
            journal_path=args.journal, journal_resume=resume,
            snapshot_path=args.snapshot,
            snapshot_every=args.snapshot_every,
            trace=bool(args.trace), trace_kv_every=args.trace_kv_every,
            incident_dir=args.incident_dir,
            incident_cooldown=args.incident_cooldown),
            device=device, kv_scales=kv_scales, registry=registry)

    # --recover-from is a fresh-process restart: the journal already holds
    # this workload's submit records, so it is appended to
    eng = mk_engine(resume=args.recover_from is not None)
    writer = None
    if args.metrics_snapshot:
        from ..kernels import act_quant
        from ..obs import RegistryQuantProbe, SnapshotWriter
        writer = SnapshotWriter(args.metrics_snapshot, eng.registry,
                                interval_s=args.metrics_interval)
        # live act-quant clip-fraction gauges: the observed kernel
        # wrappers feed the registry through the probe hook
        act_quant.set_quality_probe(RegistryQuantProbe(eng.registry))

    def run_to_drain(eng):
        if writer is None:
            return eng.drain(timeout_s=args.drain_timeout,
                             stall_steps=args.drain_stall_steps)
        # step by hand so that snapshots land during the run, not only at
        # the drain
        while not eng.sched.idle:
            eng.step()
            writer.maybe_write()
        writer.write()                            # the final flush
        return sorted(eng.sched.finished, key=lambda r: r.uid)

    recovered = {}              # uid -> journal retire record (pre-crash)
    t0 = time.perf_counter()
    if args.recover_from is not None:
        info = eng.recover(args.recover_from, args.journal)
        recovered.update(info["retired"])
        print(f"recover: {info['n_restored']} live requests restored"
              f"{' from snapshot' if info['manifest'] else ' (no snapshot)'}"
              f", {info['n_requeued']} re-enqueued from the journal, "
              f"{len(info['retired'])} already retired before the crash")
    else:
        for p in prompts:
            eng.submit(p)
    restarts = 0
    while True:
        try:
            fin = run_to_drain(eng)
            break
        except InjectedCrash as exc:
            if restarts >= args.supervise:
                raise
            why = str(exc)
        restarts += 1
        print(f"supervisor: engine crashed ({why}) — restart {restarts}/"
              f"{args.supervise}, recovering from "
              f"{'snapshot+journal' if args.snapshot else 'journal'}",
              flush=True)
        if args.incident_dir:
            # from the CRASHED engine, whose flight window and scheduler
            # state describe the death — the new one starts empty
            eng.dump_incident("injected_crash", reason=why)
        # free the crashed engine (its cache) before the new one allocates
        # its own; crash injection off, or the same seed would crash at
        # the same boundary again
        registry = eng.registry
        eng = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        calm = dataclasses.replace(base_faults, crash_rate=0.0) \
            if base_faults else None
        eng = mk_engine(registry=registry, resume=True, faults=calm)
        info = eng.recover(args.snapshot, args.journal)
        recovered.update(info["retired"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    m = eng.metrics()
    if args.faults:
        # chaos invariants: every submitted request retired exactly once
        # (live finishes and journal-replayed retires partition the
        # workload) with a schema reason, and the drained engine holds no
        # state
        from ..obs.schema import RETIRE_REASONS
        live = {r.uid for r in eng.sched.finished}
        reasons = [r.finish_reason for r in eng.sched.finished] + \
            [rec["reason"] for rec in recovered.values()]
        problems = []
        if live & set(recovered):
            problems.append(f"uids retired twice (live + journal): "
                            f"{sorted(live & set(recovered))}")
        if len(live | set(recovered)) != len(prompts):
            problems.append(f"{len(live | set(recovered))} retired != "
                            f"{len(prompts)} submitted")
        if any(x not in RETIRE_REASONS for x in reasons):
            problems.append(f"non-schema retire reasons {reasons}")
        if any(eng.sched.slots) or eng.sched.queue:
            problems.append("scheduler not empty after drain")
        leak = occupied_slots(eng.cache)
        if leak:
            problems.append(f"slot-pool leak: cache rows {leak} still "
                            f"occupied")
        print(f"chaos  : injected {m.get('faults_injected')}, "
              f"{m['step_retries']} step retries, {m['quarantined']} "
              f"quarantined, retire reasons {m['retire_reasons']}")
        if problems:
            raise SystemExit("chaos invariants VIOLATED: "
                             + "; ".join(problems))
    if args.trace:
        n = eng.tracer.to_jsonl(args.trace)
        print(f"trace  : {n} records -> {args.trace} "
              f"({eng.tracer.dropped} dropped)")
        if args.trace_chrome:
            eng.tracer.to_chrome(args.trace_chrome)
            print(f"trace  : chrome/perfetto -> {args.trace_chrome}")
        pa = m["phase_attribution"]
        if pa["coverage"] is not None:
            print(f"trace  : phase coverage {pa['coverage']:.0%} of "
                  f"step wall; dispatch {pa['dispatch_frac']:.0%} / "
                  f"device wait {pa['device_wait_frac']:.0%} of "
                  f"attributed time")
    if args.incident_dir:
        # counted on disk, not eng.incidents: a supervised restart
        # replaces the engine, the bundles persist
        bundles = sorted(
            d for d in (os.listdir(args.incident_dir)
                        if os.path.isdir(args.incident_dir) else [])
            if d.startswith("incident-"))
        print(f"incidents: {len(bundles)} bundle(s) -> "
              f"{args.incident_dir}"
              + (f"; inspect with python -m "
                 f"repro_torch.launch.incident_report "
                 f"{os.path.join(args.incident_dir, bundles[0])}"
                 if bundles else " (no anomalies)"))
    if writer is not None:
        print(f"metrics: {writer.seq} snapshots -> {args.metrics_snapshot}")
    if args.metrics_prom:
        from ..obs.atomic import atomic_write_text
        atomic_write_text(args.metrics_prom, eng.registry.to_prometheus())
        print(f"metrics: prometheus text -> {args.metrics_prom}")
    if args.metrics_json:
        from ..obs.atomic import atomic_write_text
        from ..obs.provenance import provenance
        atomic_write_text(args.metrics_json, json.dumps(
            {"provenance": provenance(), **m}, indent=2, default=float))
        print(f"metrics: -> {args.metrics_json}")
    how = (f"{eng.n_decode_steps} decode steps, "
           f"{eng.n_prefill_chunks} prefill chunks, "
           f"{eng.n_prefills} one-shot prefills")
    if args.spec_k:
        how += (f", {eng.n_spec_steps} speculative steps, acceptance "
                f"{eng.sched.acceptance_rate()}")
    if restarts:
        how += f", {restarts} supervised restart(s)"
    return fin, recovered, how, dt


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
    ap.add_argument("--max-queue", default="0", metavar="N",
                    help="admission control: bound the submit queue at N "
                         "requests; a submit past the bound triggers "
                         "--overload-policy. 0 = unbounded. (The JAX "
                         "package's 'auto' is not ported: it sizes the "
                         "bound from BENCH_serve.json, which holds TPU "
                         "measurements)")
    ap.add_argument("--overload-policy", default="reject-new",
                    choices=OVERLOAD_POLICIES,
                    help="who is shed when the bounded queue is full: the "
                         "incoming request, the oldest queued one, or the "
                         "oldest queued batch-class one")
    ap.add_argument("--degrade", action="store_true",
                    help="graceful-degradation ladder: under sustained "
                         "backlog suspend speculation, then defer "
                         "batch-class admissions, then shed queued work")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="seeded fault injection, e.g. "
                         "'exception=0.05,nan=0.02,seed=3' (keys: "
                         "exception, nan, slow, slow_s, poison, crash, "
                         "crash_kill, seed, max); the chaos invariants "
                         "(each request retired once with a schema reason, "
                         "no slot leaked) are checked after the drain. "
                         "Not with --spec-k")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="request journal: append-only JSONL of submit / "
                         "admit / first_token / retire, fsync'd every "
                         "engine step — the replay source of recovery")
    ap.add_argument("--snapshot", default=None, metavar="DIR",
                    help="engine snapshot directory (atomic tmp + rename; "
                         "the quantized slot cache, scheduler and host "
                         "state, checksummed)")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                    help="with --snapshot: snapshot every N engine steps, "
                         "after the journal's fsync. 0 = never")
    ap.add_argument("--recover-from", default=None, metavar="DIR",
                    help="start by restoring this snapshot dir and "
                         "replaying --journal against it (recovery in a "
                         "fresh process after a crash); the dir may be "
                         "absent if --journal is given")
    ap.add_argument("--supervise", type=int, default=0, metavar="N",
                    help="in-process supervisor: on an injected crash, "
                         "free the engine, build a new one (crash "
                         "injection off, the metrics registry carried "
                         "over), recover from --snapshot / --journal and "
                         "go on serving, up to N restarts")
    ap.add_argument("--drain-timeout", type=float, default=None,
                    metavar="S",
                    help="drain watchdog: force-fail every outstanding "
                         "request after S wall seconds")
    ap.add_argument("--drain-stall-steps", type=int, default=10_000,
                    metavar="N",
                    help="drain watchdog: force-fail every outstanding "
                         "request after N steps without progress")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write Engine.metrics() (with the provenance "
                         "header and the registry's snapshot) as JSON")
    ap.add_argument("--metrics-prom", default=None, metavar="PATH",
                    help="write the registry in Prometheus text format "
                         "at exit")
    ap.add_argument("--metrics-snapshot", default=None, metavar="PATH",
                    help="stream periodic JSONL snapshots of the metrics "
                         "registry to this path while serving (line 1: "
                         "the provenance header; read with "
                         "obs.load_snapshots) and watch the act-quant "
                         "kernels' clip fraction through "
                         "obs.RegistryQuantProbe. Engine only (not --wave)")
    ap.add_argument("--metrics-interval", type=float, default=1.0,
                    metavar="S",
                    help="with --metrics-snapshot: the least seconds "
                         "between snapshots (a final one is always "
                         "written at the drain)")
    ap.add_argument("--no-metrics", action="store_true",
                    help="serve without the always-on metrics registry")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="trace the engine (obs.Tracer) and write the JSONL "
                         "event log here: lifecycle events + per-step "
                         "phase spans with dispatch vs device-wait "
                         "attribution. Engine only (not --wave); a "
                         "profiling mode — adds device syncs")
    ap.add_argument("--trace-chrome", default=None, metavar="PATH",
                    help="with --trace: also write a Chrome/Perfetto "
                         "trace.json (one track per slot, one per engine "
                         "phase)")
    ap.add_argument("--trace-kv-every", type=int, default=0, metavar="N",
                    help="with --trace and --kv-mode int8: sample the KV "
                         "quantization-quality counters (clip fraction, "
                         "occupancy, outlier-chunk histogram) every N "
                         "engine steps into the trace. 0 = off")
    ap.add_argument("--incident-dir", default=None, metavar="DIR",
                    help="arm the anomaly-detector sweep and write incident "
                         "bundles (flight window + metrics + journal tail + "
                         "fingerprint + request docs) under DIR; inspect "
                         "with repro_torch.launch.incident_report")
    ap.add_argument("--incident-cooldown", type=int, default=50,
                    metavar="N",
                    help="steps between detector refires / bundles "
                         "(default 50) — a fault storm yields one "
                         "incident, not one per step")
    args = ap.parse_args(argv)
    if args.max_queue == "auto":
        ap.error("--max-queue auto is not ported: it derives the bound "
                 "from BENCH_serve.json, which holds TPU measurements; "
                 "give N")
    max_queue = int(args.max_queue)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    elif cfg.name == "kimi-k2-1t-a32b":
        cfg = kimi_smoke_workload()[0]
        print(f"note: {cfg.name} at full width, its first "
              f"{KIMI_CARD_LAYERS} layers (the dense prelude and "
              f"{KIMI_CARD_LAYERS - 1} MoE): the 61 do not fit one card")
    if (args.trace_chrome or args.trace_kv_every) and not args.trace:
        raise ValueError(
            "--trace-chrome / --trace-kv-every require --trace — without "
            "it no trace is recorded and the flags would be silently "
            "ignored")
    if args.draft_recipe and not args.spec_k:
        raise ValueError(
            "--draft-recipe only takes effect with --spec-k > 0 — the "
            "recipe would be silently ignored and serving would proceed "
            "plain-greedy")
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name} does not serve: its forward needs the stub "
            f"frontend's frames, and the wave Server, like the JAX "
            f"package's, passes only tokens — drive whisper through "
            f"repro_torch.models.whisper.prefill and decode_step")
    if args.spec_k and args.wave:
        raise NotImplementedError(
            "--wave has no speculative path (spec_k > 0 is an engine "
            "feature) — drop --wave or --spec-k")
    if args.spec_k and cfg.family not in ENGINE_FAMILIES:
        # the family's own reason, as the JAX launcher gives it
        get_model(cfg).verify_step_slots()
    engine_only = dict(
        faults=args.faults, degrade=args.degrade, max_queue=max_queue,
        journal=args.journal, snapshot=args.snapshot,
        recover_from=args.recover_from, supervise=args.supervise,
        metrics_json=args.metrics_json, metrics_prom=args.metrics_prom,
        metrics_snapshot=args.metrics_snapshot, trace=args.trace,
        incident_dir=args.incident_dir)
    given = [f"--{k.replace('_', '-')}" for k, v in engine_only.items()
             if v]
    if (args.wave or cfg.family not in ENGINE_FAMILIES) and given:
        raise NotImplementedError(
            f"{'/'.join(given)}: engine features — the wave loop has no "
            f"retry, ladder, admission control, journal, snapshot, "
            f"metrics registry, tracer or flight recorder")
    if args.no_metrics and (args.metrics_snapshot or args.metrics_prom):
        raise ValueError("--no-metrics disables the registry the "
                         "--metrics-snapshot/--metrics-prom exporters read "
                         "— drop one side")
    if args.faults and args.spec_k:
        raise ValueError("--faults targets the plain decode path; drop "
                         "--spec-k")
    if args.snapshot_every and not args.snapshot:
        raise ValueError("--snapshot-every without --snapshot DIR has "
                         "nowhere to write")
    if args.supervise and not (args.journal or args.snapshot):
        raise ValueError("--supervise has nothing to recover from — give "
                         "--journal and/or --snapshot")
    if args.recover_from and not os.path.isdir(args.recover_from) \
            and not args.journal:
        raise ValueError(f"--recover-from: {args.recover_from!r} does not "
                         f"exist and no --journal was given — there is no "
                         f"state to recover")
    t0 = time.perf_counter()
    if not (args.ckpt_dir or args.save_recipe or args.recipe) and \
            args.method != "none":
        # layer by layer: a tree too large for bf16 + packed on the card
        params, report = build_params(cfg, bits=args.bits,
                                      method=args.method, seed=0,
                                      device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        print(f"quantized {len(report['quantized'])} tensors to "
              f"INT{args.bits} ({args.method}) in "
              f"{time.perf_counter() - t0:.2f} s; deployed "
              f"{report['deployed_bytes'] / 2**20:.1f} MiB")
    else:
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
    elif args.ckpt_dir and args.method != "none":
        params, report = quantize_tree(params, QuantPolicy(
            cfg=QuantConfig(bits=args.bits), method=args.method), seed=0)
        print(f"quantized {len(report['quantized'])} tensors to "
              f"INT{args.bits} ({args.method})")
    # the JAX package's launch/serve.py draws the same prompts
    prompts = seeded_prompts(cfg.vocab, args.requests, 4, 11)
    if cfg.family in ENGINE_FAMILIES and not args.wave:
        fin, recovered, how, dt = serve_engine(
            args, cfg, params, device, kv_scales, kv_qchunks, prompts,
            max_queue)
    else:
        recovered = {}
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
    n_tok = sum(len(r.out) for r in fin) + \
        sum(rec["n_out"] for rec in recovered.values())
    for uid in sorted(recovered):
        rec = recovered[uid]
        print(f"req {uid}: {rec['n_out']} tokens ({rec['reason']}) → "
              f"{rec['out']} (retired before the crash, from the journal)")
    for r in fin:
        why = getattr(r, "finish_reason", None)     # engine requests
        print(f"req {r.uid}: prompt {len(r.prompt)} → {r.out}"
              + (f" ({why})" if why else ""))
    print(f"{len(fin) + len(recovered)} requests, {n_tok} tokens in "
          f"{dt:.3f} s on {device.type} ({n_tok / dt:.1f} tok/s), {how}")


if __name__ == "__main__":
    main()
