#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. set-up: the card's name and power limit, torch and CUDA versions, and
   the build of every kernel from ``src/repro_torch/kernels/csrc``;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the shapes its path gives it (stablelm-1.6b's engine and its
   dense_wave prefill's largest M, rwkv6-3b's wave prefill and decode,
   and rwkv6-3b activation widths for the two act-quant kernels, which no
   serving path runs), with its time (CUDA
   events, warmed up, L2 flushed and the host let run ahead between
   launches: device time, not the wrapper's host time), the plain version's
   time, a one-call PyTorch yardstick where one exists, and the least
   time the card could take (the larger of bytes over 3.35 TB/s and
   operations over the bf16 tensor-core rate, 989 TFLOP/s); the matmul
   cases (INT4 at every shape, INT2 and INT8 at stablelm-1.6b's decode
   and chunk M; paligemma-3b's wk / wv and geglu at those M and its
   patch projection, K = 1152, at 8 x 256 rows) also print their
   achieved TFLOP/s and share of the bound, and
   the build's ``-Xptxas -v`` lines of the tensor-core matmul kernel and
   of the two attention kernels (registers, spills, shared memory) are
   printed first. The decode cases (stablelm-1.6b and chatglm3-6b at 8
   slots of 1024 rows, stablelm-1.6b at 4096, and the first two over a
   bf16 cache) and the prefill cases
   print their share of the bound, their speed against SDPA and the
   wrapper's host time per call. Decode attention does its work as
   fp32 FMAs on the CUDA cores (prefill, for bf16 q, on the tensor
   cores); the time each case's work needs at 67 TFLOP/s is kept as
   ``fp32_core_ms`` in the per-case details, not as the bound;
   The static and verify modes of the two attention kernels (decode at
   the same three shapes with static scales; a 96-token prefill chunk
   with static scales and a 4-row verify window over int8 dynamic, int8
   static and fp32 caches at position 384; a 96-token chunk and the
   4-row verify window over a bf16 cache) are held to their plain
   versions the same way, and so is the K/V cache write ``write_kv_rows``
   (one launch a layer write: K and V quantized together, codes, scales
   and kv_pos stored in the slot rows) in its dynamic, static and fp
   modes (fp into fp32 and into bf16 rows) at stablelm-1.6b's and chatglm3-6b's 96-row chunk (padded tail),
   8-slot decode write and 4-row verify window sticking out past T: every
   byte of the destination equal, with the wrapper's host time a call;
   then the standalone ``quantize_kv`` and ``quantize_kv_static`` (the
   same kernel with a dense destination) at 96 and 8 rows, exact. The
   chunked WKV runs at rwkv6-3b's wave prefill (320 heads at T=256 and
   at the first wave's padded T=240) and at one sequence (40 heads),
   printing its share of the bound, the fp32-core time of its operations
   and its launch plan; both act-quant kernels also run on odd widths
   and on views whose rows start off a 16-byte boundary (their scalar
   heads and tails; the dynamic kernel on 2562 columns in 3 chunks,
   aligned and one element in, and on a view three elements in), codes,
   scales and zeros exact; the ``-Xptxas -v`` lines of the WKV and both
   act-quant kernels are printed with the others. The grouped form of
   the matmul (a MoE layer's experts, one launch a projection) runs at
   moonshot-v1-16b-a3b's shapes (64 experts, 2048 -> 1408 and 1408 ->
   2048, the 48 rows of a decode step and the 576 of a 96-token chunk;
   bf16, and fp32 at the decode rows) beside ``torch.bmm`` over JAX's
   (E, C, d) buffer, the same at INT2 (moe_spec's draft), and at
   kimi-k2-1t-a32b's 384 experts of 7168 -> 2048 and 2048 -> 7168 (INT4,
   a decode step's 64 rows and a chunk's 768); decode and prefill
   attention also at its MHA 16 x D=128; every attention case and the
   K/V write also at kimi-k2-1t-a32b's GQA 64/8, head_dim 112,
   sub-channel chunks of 28; the first act-quant cases run once more
   through the ``*_observed`` wrappers with a ``RegistryQuantProbe``
   installed, its gauges equal to ``code_stats`` of the plain codes;
   decode attention (8 slots of 1024 rows), prefill attention (a
   96-token chunk and a 4-row verify window at 384) and the K/V write
   (a 96-row chunk, an 8-slot decode write, a 4-row window) at
   paligemma-3b's MQA 8/1 and head_dim 256 (chunks of 64) in every cache
   mode (int8 dynamic and static, fp32, bf16, float16), and over a
   float16 cache at stablelm-1.6b's and chatglm3-6b's layouts; the
   matmul's fp32 variant (the CUDA-core kernel) at bert-tiny's Table 1
   shapes (6400 rows at 128 -> 128, 128 -> 512 and 512 -> 128; 100 rows
   at the pooler's 128 -> 128 and the classifiers' 128 -> 6 and
   128 -> 2), bits 2, 4 and 8, k = 3 and 1, within 1e-4 of the output's
   scale of its plain version, beside ``torch.matmul`` on the
   dequantized fp32 weight with TF32 off, its bound the table's rule with
   the fp32-core time (67 TFLOP/s) printed beside it;
3. engine: stablelm-1.6b at its published widths (seeded random bf16
   weights, SplitQuant INT4 k=3, quantized on the card) served by the
   continuous-batching engine over an int8 slot cache: 8 slots,
   max_len 1024, 96-token prefill chunks, 16 seeded requests of 16-512
   prompt tokens and 32 new tokens each. Every kernel's launch count is
   set to 0 just before the run and read just after; each of the engine's
   kernels must be > 0, every matmul and every prefill-attention launch
   must be of its bf16 tensor-core variant, every decode-attention launch
   must split T across blocks, only the dynamic modes may run, every
   forward pass must write each of the 24 layers' cache rows with exactly
   one ``write_kv_rows`` launch in the cache's mode (writes = 24 x the
   engine's decode steps and prefill chunks = attention launches, mode
   by mode) and no standalone quantizer may run, and the decode and
   prefill attention launches per step and layer are printed; then
   static: static KV scales from the port's ``collect_kv_stats`` over 4
   seeded prompts of 256 tokens on the card, and the same run over them:
   only the static decode, prefill and write modes may run; its numbers
   are printed beside the dynamic run's; then spec: the first 8 of those
   requests through the speculative engine (spec_k 3, an INT2 SplitQuant
   k=3 draft of the same seeded weights, dequantized once to bf16, over
   the static scales): every request its 32 tokens, verify launches over
   the static cache, at least one rollback, and one write a layer and
   forward pass (static for the target's chunks, verify passes and
   decode steps, dynamic for the draft's twin cache's chunks and draft
   steps); it prints the acceptance rate, the tokens a verify commits,
   tokens/s and the share of tokens identical to the static run's
   greedy output (not gated: bf16 verify on the tensor
   cores and fp32 decode on the CUDA cores sum in different orders; with
   the target's top-2 margin where the first token differs);
   then dense_wave: the same weights and 16 requests through the wave
   ``Server`` (waves of 8, left-padded, a bf16 ``KVCache`` of 1024 rows a
   wave, attention in plain PyTorch): the counts are set to 0 just before
   the run and read just after; every request its 32 tokens,
   ``splitquant_matmul`` launched and only its bf16 tensor-core variant,
   and no attention kernel, K/V write or quantizer launched; it prints
   the wave-prefill p50, decode-step p50, tokens/s and peak memory beside
   the card's name and power limit; then engine_bf16: the same weights
   and 16 requests through the engine over an fp slot cache in bf16 (the
   JAX engine's ``kv_dtype="bfloat16"``, 1.6 GB): every request its 32
   tokens, every decode-attention, prefill-attention and K/V-write launch
   over the bf16 cache in mode fp (``dtype_launches``), one write a layer
   and forward pass, every matmul ``bf16_wgmma``; then oneshot: 8 of the
   requests with one-shot prefill (``prefill_chunk=0``) over the int8
   dynamic cache: every budget served, one prefill and one fp
   materialization a request, no prefill-attention launch, one K/V write
   a layer per admission and per decode step; then sampling: the port's
   sampler on a seeded full-vocab logits row at T = 0.7, 1e5 draws held
   to softmax(logits / T) by a chi-square bound (64 hot tokens and the
   rest, the 1 - 1e-6 quantile of 64 degrees of freedom, 132.79), and the
   bf16-cache engine at T = 0.7 over 8 requests (every budget, every
   token in the vocab); each of these resets the counts just before its
   run, reads them just after and prints its numbers beside the card's
   name and power limit; then percentile_quant: ``quantize_tree``
   with the percentile-clipped baseline (99%, INT4) of the full-width
   stablelm-1.6b tree on the card, timed, and one 2048 x 5632 leaf
   quantized on the card and on the CPU: codes and scales identical;
   then recipe: ``layer_sensitivity`` of the seeded bf16 stablelm-1.6b
   tree at bits (2, 4, 8) over 2 x 128 seeded tokens, ``greedy_allocate``
   midway between uniform INT2 and INT4 bytes (feasible, within budget,
   ``quantize_tree`` bits as allocated), static KV scales on the mixed
   tree, a checkpoint and QuantRecipe written to a temporary directory
   (free space checked first) and read back by ``load_recipe_params``
   with k-means made to fail (bit-identical weights), then the 16
   requests served from the recipe: tokens equal to an engine over the
   in-memory mixed tree with the same scales, matmul launches at every
   allocated bit-width (``bits_launches``) and at no other, all
   ``bf16_wgmma``, only static attention and write modes, one write a
   layer and forward pass; it prints the sensitivity's seconds and top
   3, the checkpoint's bytes, save and load seconds, tokens/s, TTFT p50
   and peak memory beside the card's name and power limit;
3b. reliability, right after the static phase: chaos — the engine
   phase's run under a seeded fault storm with the JAX package's chaos
   rates (``CHAOS_SPEC``: step exceptions 0.15, corrupted tokens 0.10,
   stragglers 0.05 at 0.5 ms, poisoned requests 0.25, at most 60
   faults), every failed decode attempt rolled back and run again: every
   uid retired once with a schema reason, steps retried, every poisoned
   uid "failed", every survivor's tokens equal to the engine phase's, no
   slot occupied after the drain, the engine phase's kernel variants and
   modes and one write a layer and forward pass (failed attempts
   included); it prints retries, quarantines, the injected faults,
   tokens/s and decode-step p50 beside the engine phase's. Then
   recovery — the static phase's run with a request journal and a
   snapshot every 20 steps in a temporary directory, crashed by a seeded
   ``InjectedCrash`` (``CRASH_SPEC``) after a snapshot with slots
   occupied; the engine is freed and a new one recovers from snapshot +
   journal and drains: at least one request restored, the journal's
   pre-crash retires and the new engine's finishes partition the 16
   uids, every token equal to the static phase's, the merged journal
   valid with snapshot and restore events, the registry's restore and
   replay counts, no slot occupied, static modes only; it prints the
   snapshot's bytes and write seconds, the restore's and the recovery's
   seconds, and the restored and re-enqueued counts;
3c. observe, right after chaos: the chaos run traced (``trace=True``, a
   ring that drops nothing), the int8 cache's quality counters sampled
   every ``OBSERVE_KV_EVERY`` steps into the trace and the registry, the
   anomaly detectors armed with an incident directory in a temporary
   directory: every request's reason and tokens, the retries and the
   quarantines equal to the chaos phase's (tracing changes no token),
   the trace valid with nothing dropped, one KV sample every
   ``OBSERVE_KV_EVERY`` steps from step 0 with valid rows, at least one
   incident bundle, each loading with its trigger in the detector
   catalog and ``incident_report --validate`` 0, the chaos phase's
   kernel gates; it prints the phase attribution (each step split into
   dispatch, device wait and other host time), the traced tokens/s
   beside the chaos phase's and the KV clip fractions, then serves the
   unfaulted workload four times with the flight recorder on, off, off,
   on (tokens equal in all four, tokens/s printed); its trace passes
   ``launch.trace_report --validate``;
3d. moe, after percentile_quant: moonshot-v1-16b-a3b as the JAX
   package's config gives it (48 layers: 1 dense, 47 MoE of 64 experts
   top-6 with 2 shared; MHA 16 x 128; SplitQuant INT4 k=3 built layer by
   layer on the card)
   through the engine over ``smoke_workload``'s cache, chunks and request
   shapes, with a ``SnapshotWriter`` of its registry read back by
   ``load_snapshots``: every request its 32 tokens, one K/V write a layer
   and pass over 48 layers, the grouped matmul 3 x 47 times a decode step
   and a chunk, no expert stack dequantized; it prints the build's
   seconds and peak, the deployed bytes, tokens/s, TTFT, the decode-step
   and chunk p50, peak memory, the cache's bytes, launches by variant and
   mode and the routing margin of an untimed forward after the run;
3e. moe_spec, moe_wave and kimi, after moe: moe_spec serves the first 8
   of moe's requests from moe's tree through the speculative engine
   (spec_k 3, an INT2 SplitQuant draft built on the card and kept packed,
   its experts through the grouped kernel at bits 2): every budget,
   grouped launches 3 x 47 a forward pass of target and draft, at bits 2
   at least 3 x 47 a draft pass, one K/V write a layer and pass, no
   expert stack dequantized; it prints the share of tokens equal to
   moe's greedy output (not gated) and, where a request first parts, the
   target's top-2 logit margin, and request 0's second token through a
   decode step and as a verify row (the MoE layers whose experts part,
   untimed). moe_wave serves moe's 16 requests from
   the same tree through the wave ``Server`` (waves of 8, a bf16
   ``KVCache`` of 1024 rows): every budget, the matmul alone (bf16 and
   grouped), no expert stack dequantized, and pairs dropped in a wave
   prefill (> 512 tokens a block); it prints the dropped pairs. Then
   moonshot's trees are freed and kimi builds kimi-k2-1t-a32b at full
   width, 5 of its 61 layers (``kimi_smoke_workload``), part by part on
   the card and serves the engine workload, gated as moe is (one K/V
   write a layer and pass over 5 layers, grouped launches 3 x 4 a pass,
   bf16 variants and dynamic modes only, no expert stack dequantized,
   finite logits); it prints build seconds and peak, deployed bytes,
   tokens/s, TTFT, decode-step and chunk p50, peak memory and launches;
3f. engine_f16 (after engine_bf16): the engine phase's weights and
   requests over a float16 fp cache, gated as engine_bf16 (every
   attention and write launch over float16 in mode fp, one write a layer
   and pass); vlm, vlm_prefix and vlm_wave (before moe): paligemma-3b at
   full width and depth (``vlm_smoke_workload``: 18 layers, MQA 8/1 at
   head_dim 256, a tied head, a 1152 -> 2048 patch projection) built
   layer by layer on the card and served by the engine over the int8
   dynamic cache (every budget, one K/V write a layer and pass, bf16
   variants and the dynamic mode only, no plain version called, finite
   logits; build seconds and peak, deployed bytes, tokens/s, TTFT,
   decode-step and chunk p50, peak memory); one ``transformer.prefill``
   of 8 prompts of 32 tokens after 256 seeded bf16 patch embeds each
   (logits (8, 288, vocab) finite; ``patch_proj`` one matmul launch,
   the prefill 1 + 7 x 18); and the wave ``Server`` with its pad mask
   (every budget, the matmul alone);
4. cross-checks: stablelm-1.6b ``.reduced()`` in fp32 through the engine
   on the card and on the CPU with the same weights: identical greedy
   tokens; the speculative engine (INT2 draft, spec_k 3) over int8
   dynamic and static caches: card spec tokens == card greedy tokens ==
   CPU spec tokens, and on each device the draft minted from
   ``draft_recipe`` (its checkpoint and recipe in a temporary directory)
   gives the tokens and proposed / accepted counts of the same draft as
   ``draft_params=``; the dense wave ``Server`` over two left-padded
   waves of mixed lengths, one request with a budget of 1: identical
   greedy tokens; and the engine over a bf16 fp cache, with one-shot
   prefill over an int8 cache, and through the materialize read path
   (``fused_attn=False``): identical greedy tokens each; and
   moonshot-v1-16b-a3b ``.reduced()`` in fp32 through the engine (the
   fp32 grouped kernel on the card, JAX's literal form on the CPU):
   identical greedy tokens, or the step that parted and its routing
   margin; reduced moonshot through the speculative engine (INT8 draft
   kept packed): card spec tokens == CPU spec tokens == card greedy
   tokens; reduced moonshot through the wave ``Server`` with an
   800-token wave (pairs dropped): card tokens == CPU tokens; reduced
   kimi-k2-1t-a32b at head_dim 112, GQA 8/1, in fp32 through the
   engine: card tokens == CPU tokens; the engine over a float16 fp
   cache: identical tokens; reduced paligemma-3b and its head_dim-256
   variant (MQA 2/1, d_model 512) in fp32 through the engine: identical
   tokens; their prefill with 8 patch embeds: logits within 1e-4 of
   their scale; reduced paligemma through the wave ``Server``: identical
   tokens;
4b. training and the paper's Table 1 (after kimi): table1 runs
   ``launch.table1`` at the JAX package's defaults on the card (bert-tiny
   fine-tuned by AdamW, 8 epochs of 3200 examples a task, then FP32 and
   INT2/4/8 x {baseline, SplitQuant}, weights and biases, without and
   with 8-bit activations), the counts set to 0 just before and read just
   after: every matmul launch ``fp32_cuda_core``, launches at each of
   bits 2, 4 and 8, no plain version, no other kernel, FP32 accuracy
   within 5%p of each task's regime (0.90, 0.98); it prints the grid, the
   INT2 differences and training steps/s; train runs ``launch.train`` on
   stablelm-1.6b at full width (bf16, batch 8 x 128, 8 steps, remat, fp32
   AdamW states): every loss finite, the final line printed, no kernel
   launched; it prints step p50, tokens/s and peak memory;
   table1_cross_check evaluates the emotion task's INT2 trees (both
   methods) on the card and, copied, on the CPU: accuracy within 2 of
   800 examples, logits within 1e-4 of their scale; train_cross_check
   trains reduced stablelm in fp32 for 3 steps on both devices from the
   same weights and batches (losses within 1e-4 relative) and bert-tiny
   through ``train_loop.run`` with a checkpoint every 3 steps and a
   failure injected at step 7 under deterministic algorithms: the
   restored run's final params equal the uninterrupted run's exactly;
4c. rwkv6 training (after train): rwkv_train runs ``launch.train`` on
   rwkv6-3b at full width (32 layers, d_model 2560, 40 heads of 64, d_ff
   8960, vocab 65536, ~3.1 B params in bf16; batch 8 x 128, 8 steps,
   remat, fp32 AdamW states), the counts set to 0 just before and read
   just after: 8 finite losses, the final line printed, the forward WKV
   kernel 2 x 32 x 8 = 512 times (remat recomputes each layer once), its
   backward kernel ``wkv_chunked_bwd`` 32 x 8 = 256 times, no other
   kernel and no plain version; it prints step p50, tokens/s and peak
   memory; rwkv_train_cross_check trains reduced rwkv6 in fp32 for 3
   steps (seq 32: the chunked branch) on both devices from the same
   weights and batches (losses within 1e-4 relative) and runs it through
   ``train_loop.run`` on the card with a checkpoint every 3 steps and a
   failure injected at step 7 under deterministic algorithms: the
   restored run's final params equal the uninterrupted run's exactly.
   The kernel phase adds the WKV backward (``wkv_chunked_bwd``, no TPU
   kernel: JAX differentiates ``wkv_chunked_jnp``) at rwkv6-3b's training
   shapes (8 x 40 heads at T = 128, and T = 256), bf16, with and without
   s0, against its plain version (dr, dk, dv 2e-2 of their scale in bf16;
   dw ⊙ w, du, ds0 1e-4), two launches bit-identical, its bound the
   table's rule with the fp32-core time (67 TFLOP/s) printed beside it;
5. rwkv6: rwkv6-3b at its published widths (seeded random bf16 weights,
   SplitQuant INT4 k=3 of 257 matrices, quantized on the card) served by
   the wave loop: waves of 8, 16 seeded requests of 64-256 prompt tokens
   (multiples of 16, so the chunked WKV kernel carries every prefill) and
   32 new tokens each. The counts are set to 0 just before the run and
   read just after; ``wkv_chunked`` and ``splitquant_matmul`` must be > 0,
   and every matmul launch must be of the bf16 tensor-core variant;
6. rwkv6 cross-check: rwkv6-3b ``.reduced()`` in fp32 through the wave
   server on the card and on the CPU with the same weights, over one wave
   whose padded length is a multiple of 16 and one whose length is not:
   identical greedy tokens;
7. griffin, griffin_ring and whisper (after rwkv6): recurrentgemma-9b
   uncut (38 layers: 12 groups of (rec, rec, attn) and 2 trailing
   recurrent layers, MQA 16/1 at head_dim 256, window 2048; SplitQuant
   INT4 k=3 built part by part on the card) through the wave ``Server``
   in rwkv6's wave shapes (waves of 8, 16 requests of 64-256 tokens, 32
   new); then one wave of 4 prompts of 2100-2400 tokens, past the
   window: the ring holds the last 2048 positions written, in ring
   order, after the run; then whisper-tiny uncut (4 + 4 layers, d_model
   384, enc_seq 1500; INT4 weights and biases) over two batches of 8
   with seeded stub frames, 16- and 48-token prompts, 32 greedy tokens
   by ``prefill`` and ``decode_step``. Each resets the counts just
   before and reads them just after: every budget, the matmul alone in
   its bf16 variant, no plain version, finite logits and state; they
   print build seconds and peak, deployed bytes, tokens/s, prefill and
   decode-step p50 (whisper also the encoder's ms). The kernel phase
   adds the matmul at recurrentgemma-9b's shapes (K 4096 -> 4096, 12288,
   256, 256000 and 12288 -> 4096 at 8 rows and at the griffin phase's
   largest wave prefill) and whisper-tiny's (384 -> 384, 1536 and 1536
   -> 384 at 8 rows and at the encoder's 12,000), and the 384 -> 384
   projection with its quantized bias through ``ops.linear``; the
   cross-checks add reduced griffin (8 layers, 2 in the tail, window 16)
   through the wave ``Server`` with waves padded past the window, and
   reduced whisper's prefill and decode steps: card tokens == CPU
   tokens.

The line before the last is ``{"kernels": [...]}``: one entry per TPU
kernel, with ``launches`` summed over the serving runs of phases 3, 5
and 7 (``launches_by_path`` splits them: engine, static, spec,
dense_wave, wave, engine_bf16, oneshot, sampling, recipe, chaos,
recovery, observe, moe, moe_spec, moe_wave, kimi, engine_f16, vlm,
vlm_prefix, vlm_wave, table1, train, rwkv_train, griffin, griffin_ring and
whisper,
``launches_by_variant``
splits those of the matmul (``grouped``: its MoE form) and of the two
attention kernels by variant,
``launches_by_bits`` the matmul's of the recipe, moe_spec and table1
runs by bit-width,
``launches_by_mode`` those of the attention kernels and of the K/V write
by mode and ``launches_by_cache_dtype`` theirs by the cache's dtype in
the runs of this slice; the write, the counterpart of both branches of the TPU prefill
kernel's epilogue, is two entries: ``kv_write`` (its dynamic and fp
modes) and ``kv_write_static``; ``wkv_chunked_bwd``, the WKV gradient,
replaces no TPU kernel and is on the rwkv_train path; the act-quant
kernels, on no serving path, report their kernel-phase launches); the last is ``{"ok": true,
"device": {...}}``. Each phase's seconds are printed as it ends
(``phase_s`` in the details). Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS's deterministic workspace, read when the card starts: the
# training cross-check runs under deterministic algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = 989e12                  # dense bf16 tensor-core rate
FP32_CORE_OPS = 67e12              # fp32 outside the tensor cores
SLEEP_CYCLES = 2_000_000           # ~1 ms at the H100's 1.98 GHz
TPU_KERNELS = {
    "splitquant_matmul": "src/repro/kernels/splitquant_matmul.py:83",
    "act_split_quantize": "src/repro/kernels/act_quant.py:60",
    "act_split_quantize_static": "src/repro/kernels/act_quant.py:132",
    "prefill_attention": "src/repro/kernels/prefill_attention.py:299",
    "kv_write": "src/repro/kernels/prefill_attention.py:232",
    "wkv_chunked": "src/repro/kernels/wkv_chunked.py:75",
    "decode_attention": "src/repro/kernels/decode_attention.py:164",
    "kv_write_static": "src/repro/kernels/prefill_attention.py:241",
    "wkv_chunked_bwd": "none: jax.vjp of wkv_chunked_jnp "
                       "(src/repro/kernels/wkv_chunked.py:112)",
}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "splitquant_matmul": CSRC + "splitquant_matmul.cu",
    "act_split_quantize": CSRC + "act_quant.cu",
    "act_split_quantize_static": CSRC + "act_quant.cu",
    "prefill_attention": CSRC + "prefill_attention.cu",
    "kv_write": CSRC + "kv_write.cu",
    "wkv_chunked": CSRC + "wkv_chunked.cu",
    "decode_attention": CSRC + "decode_attention.cu",
    "kv_write_static": CSRC + "kv_write.cu",
    "wkv_chunked_bwd": CSRC + "wkv_chunked_bwd.cu",
}
#: the serving runs each kernel is on: "engine" (dynamic int8 scales),
#: "static" (static scales), "spec" (speculative, static target, dynamic
#: draft), "dense_wave" (stablelm-1.6b through the wave loop), "wave"
#: (rwkv6), "engine_bf16" (an fp cache in bf16), "oneshot" (one-shot
#: prefill over the int8 dynamic cache: no prefill attention),
#: "sampling" (the bf16-cache engine at temperature 0.7) and "recipe" (a
#: mixed INT2/INT4/INT8 tree restored from a checkpoint, static scales
#: from its recipe), "chaos" (the engine phase's run under a seeded fault
#: storm), "recovery" (the static phase's run crashed after a snapshot
#: and recovered in a new engine; both engines' launches), "observe"
#: (the chaos run traced, with KV samples and incident bundles), "moe"
#: (moonshot-v1-16b-a3b through the engine; the matmul's launches there
#: are its dense and its grouped form), "moe_spec" (moonshot through the
#: speculative engine, its INT2 draft packed), "moe_wave" (moonshot
#: through the wave loop: the matmul alone), "kimi"
#: (kimi-k2-1t-a32b, 5 layers at full width, through the engine),
#: "table1" (the paper's Table 1: bert-tiny's quantized evaluations, the
#: matmul's fp32 variant), "train" (stablelm-1.6b trained at full
#: width: float weights, no quantized kernel, 0 launches), "griffin"
#: (recurrentgemma-9b through the wave loop), "griffin_ring" (its wave
#: past the 2048-row window) and "whisper" (whisper-tiny's prefill and
#: decode steps): the matmul alone; "rwkv_train" (rwkv6-3b trained at full
#: width: float weights, the WKV kernel and its backward).
#: ``kv_write`` is
#: ``write_kv_rows`` in its dynamic and fp modes, ``kv_write_static`` in
#: its static mode.
PATHS = {
    "splitquant_matmul": ("engine", "static", "spec", "dense_wave", "wave",
                          "engine_bf16", "oneshot", "sampling", "recipe",
                          "chaos", "recovery", "observe", "moe", "moe_spec",
                          "moe_wave", "kimi", "engine_f16", "vlm",
                          "vlm_prefix", "vlm_wave", "table1", "train",
                          "griffin", "griffin_ring", "whisper"),
    "act_split_quantize": (),
    "act_split_quantize_static": (),
    "prefill_attention": ("engine", "static", "spec", "engine_bf16",
                          "sampling", "recipe", "chaos", "recovery",
                          "observe", "moe", "moe_spec", "kimi", "engine_f16",
                          "vlm"),
    "kv_write": ("engine", "spec", "engine_bf16", "oneshot", "sampling",
                 "chaos", "observe", "moe", "moe_spec", "kimi", "engine_f16",
                 "vlm"),
    "wkv_chunked": ("wave", "rwkv_train"),
    "decode_attention": ("engine", "static", "spec", "engine_bf16",
                         "oneshot", "sampling", "recipe", "chaos",
                         "recovery", "observe", "moe", "moe_spec", "kimi",
                         "engine_f16", "vlm"),
    "kv_write_static": ("static", "spec", "recipe", "recovery"),
    "wkv_chunked_bwd": ("rwkv_train",),
}
#: the 1 - 1e-6 quantile of chi-square with 64 degrees of freedom (the
#: sampling phase's 64 hot tokens and the rest)
CHI2_64 = 132.79
#: the chaos phase's fault storm: the rates of the JAX package's chaos
#: test; seed 0 poisons 5 of the 16 requests and, at this schedule, fails
#: no whole batch (3 unattributable failures in a row), so 11 survive
CHAOS_SPEC = dict(seed=0, step_exception_rate=0.15, nan_logits_rate=0.10,
                  slow_step_rate=0.05, slow_step_s=0.0005, poison_rate=0.25,
                  max_faults=60)
#: the recovery phase's crash: seed 42 at rate 0.02 fires at the boundary
#: before step 52 of the run's 91, after the snapshots of steps 20 and 40
CRASH_SPEC = dict(seed=42, crash_rate=0.02, max_faults=1)
SNAPSHOT_EVERY = 20
#: the observe phase's KV quality period (trace samples and gauges)
OBSERVE_KV_EVERY = 4

#: seconds of each phase of the run (``timed``)
PHASE_S = {}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds kept in ``PHASE_S`` and printed."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_S[name] = time.perf_counter() - t0
    log(f"phase {name}: {PHASE_S[name]:.1f} s")
    return out


# ------------------------------------------------------------- timing ---
class Timer:
    """Mean device time of one call: CUDA events around each launch,
    after warm-up, with the L2 cache flushed between launches (the
    serving path meets every weight and cache row cold). After the flush
    the stream sleeps ~1 ms on the card, so the host has queued the whole
    call (all its launches) before the start event fires and the
    interval holds the call's device time and not the wrapper's host
    overhead; a call that synchronizes inside (a plain version) still
    counts its host time."""

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
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)


def host_us(torch, fn, reps: int = 200) -> float:
    """Host time of one wrapper call: a loop of ``reps`` calls with no
    synchronize inside (the card catches up afterwards)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


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

    def entry(self, launches: dict, **extra) -> dict:
        """``launches``: the kernel's count per serving run it is on, or
        {"kernel phase": n} for a kernel on no serving path; ``extra``
        keys are added to the entry."""
        tot = lambda k: sum(c[k] for c in self.cases)
        libs = [c["library_ms"] for c in self.cases]
        t_b = sum(c["bytes"] for c in self.cases) / HBM_BYTES_PER_S * 1e3
        t_o = sum(c["ops"] for c in self.cases) / PEAK_OPS * 1e3
        return {"name": self.name, "route": "cuda",
                "source": SOURCES[self.name],
                "replaces": TPU_KERNELS[self.name],
                "launches": sum(launches.values()),
                "launches_by_path": launches,
                "on_serving_path": bool(PATHS[self.name]),
                "max_abs_err": max(c["max_abs_err"] for c in self.cases),
                "ms": tot("ms"), "plain_ms": tot("plain_ms"),
                "bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "library_ms": None if None in libs else sum(libs),
                **extra, "cases": self.cases}


def log_against_sdpa(rep, host: float) -> None:
    """The last case's share of its bound, speed against SDPA and the
    wrapper's host time per call."""
    c = rep.cases[-1]
    c["bound_share"] = c["bound_ms"] / c["ms"]
    c["host_us"] = host
    log(f"  {'':18s} {'':44s} {100 * c['bound_share']:.1f}% of its bound "
        f"({c['bound_by']}); {c['library_ms'] / c['ms']:.2f}x the speed of "
        f"SDPA; wrapper host time {host:.1f} us a call")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def rows_err(torch, got, want, rows: int = 1024) -> tuple[float, float, bool]:
    """(max |got - want|, max |want|, got all finite) of two (M, N)
    outputs, a block of ``rows`` rows at a time: an output of several GB
    is compared without fp32 copies of the whole (a NaN carried)."""
    errs, scales, finite = [], [], True
    for g, w in zip(got.split(rows), want.split(rows)):
        g, w = g.float(), w.float()
        errs.append((g - w).abs().max())
        scales.append(w.abs().max())
        finite = finite and bool(torch.isfinite(g).all())
    return (float(torch.stack(errs).max()), float(torch.stack(scales).max()),
            finite)


# ------------------------------------------------------------ kernels ---
def matmul_cases(torch, timer, rep):
    from repro_torch.kernels.packing import pack_cids
    from repro_torch.kernels.ref import (dequant_weight_ref,
                                         splitquant_matmul_ref)
    from repro_torch.kernels.splitquant_matmul import (row_slabs,
                                                       splitquant_matmul)
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import (dense_wave_workload,
                                          griffin_ring_workload,
                                          griffin_smoke_workload)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k = 3
    # M at the dense_wave phase's largest wave prefill: a wave's rows times
    # its longest prompt
    _, scfg, _, _, prompts = dense_wave_workload()
    B = scfg.max_batch
    m_wave = max(len(w) * max(map(len, w)) for w in
                 (prompts[i:i + B] for i in range(0, len(prompts), B)))
    # (arch, K, N, M at decode, at a prefill chunk and at a wave prefill,
    # bits): INT4 as every serving run quantizes, INT2 and INT8 (the
    # recipe phase's mixed tree) at the stablelm decode and chunk M;
    # paligemma-3b's own shapes (wk / wv, geglu) at decode and chunk M,
    # and its patch projection (K = 1152) at vlm_prefix's 8 x 256 rows
    stablelm = ((2048, 2048), (2048, 5632), (5632, 2048), (2048, 100352))
    # recurrentgemma-9b at a decode step, at its griffin phase's largest
    # wave prefill and at griffin_ring's one wave prefill (4 prompts padded
    # to the longest: its vocab head is the product launched in two row
    # slabs); whisper-tiny at a decode step and at the encoder's 8 x 1500
    # rows
    _, gscfg, _, _, gprompts = griffin_smoke_workload()
    gB = gscfg.max_batch
    m_gwave = max(len(w) * max(map(len, w)) for w in
                  (gprompts[i:i + gB] for i in range(0, len(gprompts), gB)))
    _, _, rprompts = griffin_ring_workload()
    m_ring = len(rprompts) * max(map(len, rprompts))
    m_enc = 8 * get_arch("whisper-tiny").enc_seq
    shapes = [("stablelm-1.6b", K, N, (8, 96, m_wave), 4)
              for K, N in stablelm] + \
        [("recurrentgemma-9b", K, N, (8, m_gwave, m_ring), 4) for K, N in (
            (4096, 4096), (4096, 12288), (4096, 256), (4096, 256000),
            (12288, 4096))] + \
        [("whisper-tiny", K, N, (8, m_enc), 4) for K, N in (
            (384, 384), (384, 1536), (1536, 384))] + \
        [("rwkv6-3b", K, N, (8, 96, 2048), 4) for K, N in (
            (2560, 2560), (2560, 8960), (8960, 2560), (2560, 65536))] + \
        [("paligemma-3b", K, N, (8, 96), 4) for K, N in (
            (2048, 256), (2048, 16384), (16384, 2048))] + \
        [("paligemma-3b patch_proj", 1152, 2048, (2048,), 4)] + \
        [("stablelm-1.6b", K, N, (8, 96), bits) for bits in (2, 8)
         for K, N in stablelm]
    for arch, K, N, Ms, bits in shapes:
        qp = torch.randint(0, 256, (K * bits // 8, N), generator=gen,
                           dtype=torch.uint8, device="cuda")
        cids = torch.randint(0, k, (K, N), generator=gen, device="cuda")
        cp = pack_cids(cids.to(torch.uint8))
        del cids
        recip = (torch.rand((k, N), generator=gen, device="cuda") + 0.5) / 16
        shift = torch.randn((k, N), generator=gen, device="cuda") * 0.05
        w = dequant_weight_ref(qp, cp, recip, shift, bits, torch.bfloat16)
        for M in Ms:
            x = torch.randn((M, K), generator=gen,
                            device="cuda").to(torch.bfloat16)
            n0 = splitquant_matmul.launches
            got = splitquant_matmul(x, qp, cp, recip, shift, bits=bits, k=k)
            slabs = splitquant_matmul.launches - n0
            want = splitquant_matmul_ref(x, qp, cp, recip, shift, bits)
            torch.cuda.synchronize()
            if slabs != len(row_slabs(M, N)):
                fail(f"matmul M={M} K={K} N={N}: {slabs} launches, expected "
                     f"{len(row_slabs(M, N))} row slabs")
            if slabs > 1:
                log(f"  {'':18s} M={M} K={K} N={N}: {slabs} row slabs "
                    f"{row_slabs(M, N)}")
            # bf16 output: one bf16 rounding of an fp32 sum whose order
            # differs from torch's ⇒ ≲ 2^-8 relative to the output scale
            err, scale, finite = rows_err(torch, got, want)
            if not finite:
                fail(f"matmul M={M} K={K} N={N}: non-finite output")
            del got, want
            tol = 2 ** -7 * max(1.0, scale)
            nbytes = M * K * 2 + K * N * bits / 8 + K * N / 4 + \
                2 * k * N * 4 + M * N * 2
            ms = timer(lambda: splitquant_matmul(x, qp, cp, recip, shift,
                                                 bits=bits, k=k))
            rep.add(f"{arch} M={M} K={K} N={N} bf16 int{bits} k=3",
                    err, tol, ms,
                    timer(lambda: splitquant_matmul_ref(x, qp, cp, recip,
                                                        shift, bits)),
                    timer(lambda: torch.matmul(x, w)),
                    nbytes, 2 * M * K * N)
            c = rep.cases[-1]
            c["tflops"] = 2 * M * K * N / ms * 1e-9
            c["bound_share"] = c["bound_ms"] / ms
            log(f"  {'':18s} {'':44s} {c['tflops']:.1f} TFLOP/s, "
                f"{100 * c['bound_share']:.1f}% of its bound "
                f"({c['bound_by']}); {c['library_ms'] / ms:.2f}x the "
                f"speed of torch.matmul")
        del qp, cp, w


def bias_cases(torch, timer, rep):
    """whisper-tiny's 384 -> 384 projection with its quantized bias, as
    ``ops.linear`` runs it (the kernel, then the bias's eq. (4)
    dequantization added) at a decode step's 8 rows and the encoder's
    8 x 1500, weight and bias quantized by the port (SplitQuant INT4
    k=3) on the card, against the plain version plus the same bias;
    ``torch.matmul`` on the dequantized weight plus the bias beside it."""
    from repro_torch.core.quantize import QuantConfig
    from repro_torch.core.splitquant import splitquant_tensor
    from repro_torch.kernels.ops import linear, pack_for_kernel
    from repro_torch.kernels.ref import splitquant_matmul_ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    K = N = 384
    w = torch.randn((K, N), generator=gen, device="cuda") * 0.05
    b = torch.randn((N,), generator=gen, device="cuda") * 0.1
    pw = pack_for_kernel(splitquant_tensor(gen, w, QuantConfig(bits=4)))
    qb = splitquant_tensor(gen, b, QuantConfig(bits=4))
    bd = qb.dequantize().to(torch.bfloat16)
    wd = pw.dequantize().to(torch.bfloat16)
    ref = lambda x: splitquant_matmul_ref(x, pw.qp, pw.cp, pw.recip,
                                          pw.shift, 4) + bd
    for M in (8, 8 * 1500):
        x = torch.randn((M, K), generator=gen,
                        device="cuda").to(torch.bfloat16)
        got, want = linear(x, pw, qb), ref(x)
        torch.cuda.synchronize()
        tol = 2 ** -7 * max(1.0, float(want.float().abs().max()))
        nbytes = M * K * 2 + K * N / 2 + K * N / 4 + 2 * 3 * N * 4 + \
            N * 4 + M * N * 2
        rep.add(f"whisper-tiny M={M} K={K} N={N} + quantized bias",
                max_err(got, want), tol, timer(lambda: linear(x, pw, qb)),
                timer(lambda: ref(x)), timer(lambda: torch.matmul(x, wd) + bd),
                nbytes, 2 * M * K * N)


def random_packed_cids(torch, gen, shape, k=3):
    """Packed cluster ids (..., K/4, N) drawn as bytes, each 2-bit id
    below k (an id at or past k moved to k - 1): no (..., K, N) id tensor
    (5.6 G elements for a kimi-k2 stack)."""
    cp = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                       device="cuda")
    for p in range(4):
        f = ((cp >> (2 * p)) & 3).to(torch.int16)
        cp -= (torch.clamp(f - (k - 1), min=0) << (2 * p)).to(torch.uint8)
    return cp


def grouped_cases(torch, timer, rep):
    """The grouped form of the matmul (a MoE layer's experts: one launch a
    projection) at the MoE serving shapes, k=3, routed by a seeded top-k
    of random router probabilities: moonshot-v1-16b-a3b's 64 experts of
    2048 -> 1408 (gate, up) and 1408 -> 2048 (down) at INT4 over the rows
    of a decode step of 8 slots (8 x top-6 = 48 rows) and of a 96-token
    chunk (576 rows), bf16 (the moe phase) at both, fp32 (the reduced
    cross-check's CUDA-core form) at the decode rows; the same at INT2
    (the moe_spec phase's draft), bf16; kimi-k2-1t-a32b's 384 experts of
    7168 -> 2048 and 2048 -> 7168 at INT4 over a decode step's 64 rows and
    a chunk's 768, bf16. The bound counts x and y once and the packed
    codes, ids and constants of the experts that got rows; the library
    time is ``torch.bmm`` over JAX's (E, C, d) buffer (C = the block's
    tokens, 8 or 96) with the dequantized stack in x's type."""
    from repro_torch.kernels.ref import dequant_weight_ref
    from repro_torch.kernels.splitquant_matmul import (
        grouped_splitquant_matmul, grouped_splitquant_matmul_ref)
    from repro_torch.launch.serve import (kimi_smoke_workload,
                                          moe_smoke_workload)
    moon, kimi = moe_smoke_workload()[0], kimi_smoke_workload()[0]
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(8)
    for arch, cfg, bits, rows in (
            ("moonshot", moon, 4, ((8, (bf, f32)), (96, (bf,)))),
            ("moonshot draft", moon, 2, ((8, (bf,)), (96, (bf,)))),
            ("kimi", kimi, 4, ((8, (bf,)), (96, (bf,))))):
        E, top, k = cfg.n_experts, cfg.top_k, 3
        for K, N in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
            qp = torch.randint(0, 256, (E, K * bits // 8, N), generator=gen,
                               dtype=torch.uint8, device="cuda")
            cp = random_packed_cids(torch, gen, (E, K // 4, N), k)
            recip = (torch.rand((E, k, N), generator=gen, device="cuda")
                     + 0.5) / 16
            shift = torch.randn((E, k, N), generator=gen,
                                device="cuda") * 0.05
            w = torch.empty((E, K, N), dtype=bf, device="cuda")
            for e in range(E):
                w[e] = dequant_weight_ref(qp[e], cp[e], recip[e], shift[e],
                                          bits, bf)
            for T, dtypes in rows:
                probs = torch.rand((T, E), generator=gen, device="cuda")
                flat = torch.topk(probs, top, dim=-1).indices.reshape(-1)
                offsets = torch.searchsorted(
                    torch.sort(flat).values,
                    torch.arange(E + 1, device="cuda")).to(torch.int32)
                used = int((offsets.diff() > 0).sum())
                R = T * top
                for dt in dtypes:
                    x = torch.randn((R, K), generator=gen,
                                    device="cuda").to(dt)
                    go = lambda: grouped_splitquant_matmul(  # noqa: E731
                        x, offsets, qp, cp, recip, shift, bits=bits, k=k)
                    got = go()
                    want = grouped_splitquant_matmul_ref(
                        x, offsets, qp, cp, recip, shift, bits)
                    torch.cuda.synchronize()
                    if not bool(torch.isfinite(got).all()):
                        fail(f"grouped matmul {arch} R={R} K={K} N={N}: "
                             f"non-finite")
                    # bf16: one rounding of an fp32 sum taken in another
                    # order (as the dense kernel); fp32: the sum's order
                    rel = 2 ** -7 if dt == bf else 2 ** -14
                    tol = rel * max(1.0, float(want.float().abs().max()))
                    es = x.element_size()
                    nbytes = R * K * es + R * N * es + (E + 1) * 4 + used * (
                        K * N * bits / 8 + K * N / 4 + 2 * k * N * 4)
                    buf = torch.randn((E, T, K), generator=gen,
                                      device="cuda").to(dt)
                    wd = w.to(dt)
                    ms = timer(go)
                    name = "bf16" if dt == bf else "fp32"
                    rep.add(f"{arch} grouped E={E} R={R} K={K} N={N} {name} "
                            f"int{bits} k=3 ({used} experts routed)",
                            max_err(got, want), tol, ms,
                            timer(lambda: grouped_splitquant_matmul_ref(
                                x, offsets, qp, cp, recip, shift, bits)),
                            timer(lambda: torch.bmm(buf, wd)),
                            nbytes, 2 * R * K * N)
                    c = rep.cases[-1]
                    c["grouped"] = True
                    c["bound_share"] = c["bound_ms"] / ms
                    log(f"  {'':18s} {'':44s} {100 * c['bound_share']:.1f}% "
                        f"of its bound ({c['bound_by']}); "
                        f"{c['library_ms'] / ms:.2f}x the speed of torch.bmm "
                        f"over the (E, C, d) buffer")
                    del buf, wd
            del qp, cp, w
            torch.cuda.empty_cache()


def _decode_inputs(torch, gen, N, T, Hq, Hkv, D, C):
    from repro_torch.kernels.prefill_attention import quantize_kv_ref
    q = torch.randn((N, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((N, T, Hkv, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn((N, T, Hkv, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    qk, ks, kz = quantize_kv_ref(k, C)
    qv, vs, vz = quantize_kv_ref(v, C)
    # ragged depths (at T = 1024, scaled with T), slot 2 empty
    depths = [d * T // 1024 for d in (1000, 513, 0, 17, 256, 777, 64,
                                      1023)][:N]
    kv_pos = torch.full((N, T), -1, dtype=torch.int32, device="cuda")
    for n, d in enumerate(depths):
        kv_pos[n, :d] = torch.arange(d, device="cuda", dtype=torch.int32)
    q_pos = torch.tensor([max(d - 1, 0) for d in depths], dtype=torch.int32,
                         device="cuda")
    return q, qk, qv, kv_pos, q_pos, (ks, kz, vs, vz)


def static_scales_of(torch, x, C, gen=None):
    """Per-(head, chunk) static (S, Z) of x (..., Hkv, D) from its own
    range, as ``calib.kv_static_scales`` derives them from calibration
    ranges; with ``gen``, S is scaled by U(0.5, 2) and Z moved by a
    fractional U(-0.5, 0.5), so that most codes still fall inside the
    range and an exact check tests the rounding of S·x + Z, not the clip
    (as the static act-quant cases do)."""
    H, D = x.shape[-2:]
    xc = x.float().reshape(-1, H, C, D // C)
    lo, hi = xc.amin(dim=(0, 3)), xc.amax(dim=(0, 3))
    if gen is None:
        scale = 255.0 / (hi - lo)
        return scale, -128.0 - scale * lo
    u = torch.rand((2, H, C), generator=gen, device=x.device)
    scale = 255.0 / (hi - lo) * (0.5 + 1.5 * u[0])
    return scale, -0.5 - scale * (hi + lo) / 2 + (u[1] - 0.5)


def _static_decode_inputs(torch, gen, N, T, Hq, Hkv, D, C):
    from repro_torch.kernels.prefill_attention import quantize_kv_static_ref
    q, _, _, kv_pos, q_pos, _ = _decode_inputs(torch, gen, N, T, Hq, Hkv, D,
                                               C)
    k = torch.randn((N, T, Hkv, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn((N, T, Hkv, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    ks, kz = static_scales_of(torch, k, C)
    vs, vz = static_scales_of(torch, v, C)
    return (q, quantize_kv_static_ref(k, ks, kz),
            quantize_kv_static_ref(v, vs, vz), kv_pos, q_pos, (ks, kz, vs, vz))


def decode_cases(torch, timer, rep):
    """Decode attention at stablelm-1.6b's and chatglm3-6b's serving
    shapes, with per-entry (dynamic) scales and with static per-layer
    scales; the static bound counts the code bytes alone."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref,
                                                      dequant_chunk)
    gen = torch.Generator(device="cuda").manual_seed(1)
    N, C = 8, 4
    for (arch, Hq, Hkv, D, T), static in (
            (c, st) for st in (False, True) for c in (
                ("stablelm-1.6b", 32, 32, 64, 1024),
                ("chatglm3-6b", 32, 2, 128, 1024),
                ("stablelm-1.6b", 32, 32, 64, 4096),
                ("moonshot-v1-16b-a3b", 16, 16, 128, 1024),
                ("kimi-k2-1t-a32b", 64, 8, 112, 1024))):
        make = _static_decode_inputs if static else _decode_inputs
        q, qk, qv, kv_pos, q_pos, sc = make(torch, gen, N, T, Hq, Hkv, D, C)
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
        # codes, and per-entry scales unless static (4 x Hkv x C constants)
        nbytes = E * Hkv * (2 * D + (0 if static else 2 * 2 * C * 4)) + \
            N * T * 4 + N * 4 + 2 * N * Hq * D * 2 + \
            (4 * Hkv * C * 4 if static else 0)
        rep.add(f"{arch} N={N} T={T} Hq={Hq} Hkv={Hkv} D={D} int8 "
                f"{'static' if static else 'dynamic'}",
                max_err(got, want), tol,
                timer(lambda: decode_attention(q, qk, qv, kv_pos, q_pos,
                                               *sc)),
                timer(lambda: decode_attention_ref(q, qk, qv, kv_pos, q_pos,
                                                   *sc)),
                lib, nbytes, 4 * E * Hq * D)
        log_against_sdpa(rep, host_us(torch, lambda: decode_attention(
            q, qk, qv, kv_pos, q_pos, *sc)))


def decode_bf16_cases(torch, timer, rep):
    """Decode attention over a bf16 cache (the engine's
    ``kv_dtype="bfloat16"``), bf16 q, at stablelm-1.6b's and chatglm3-6b's
    T = 1024 serving shapes, beside SDPA on the same bf16 K/V; the bound
    counts the live rows' 2 x D bf16 values."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(11)
    N = 8
    for arch, Hq, Hkv, D, T in (("stablelm-1.6b", 32, 32, 64, 1024),
                                ("chatglm3-6b", 32, 2, 128, 1024),
                                ("kimi-k2-1t-a32b", 64, 8, 112, 1024)):
        q, _, _, kv_pos, q_pos, _ = _decode_inputs(torch, gen, N, T, Hq, Hkv,
                                                   D, 4)
        k, v = (torch.randn((N, T, Hkv, D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        got = decode_attention(q, k, v, kv_pos, q_pos)
        want = decode_attention_ref(q, k, v, kv_pos, q_pos)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()) or \
                not bool((got[2] == 0).all()):
            fail(f"decode {arch} bf16 cache: non-finite output or non-zero "
                 f"empty slot")
        tol = 2 ** -7 * max(1.0, float(want.float().abs().max()))
        valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
        G = Hq // Hkv
        ks_ = k.transpose(1, 2).repeat_interleave(G, 1)
        vs_ = v.transpose(1, 2).repeat_interleave(G, 1)
        mask = valid[:, None, None, :]
        lib = timer(lambda: F.scaled_dot_product_attention(
            q[:, :, None], ks_, vs_, attn_mask=mask))
        E = int(valid.sum())
        nbytes = E * Hkv * 2 * D * 2 + N * T * 4 + N * 4 + 2 * N * Hq * D * 2
        rep.add(f"{arch} N={N} T={T} Hq={Hq} Hkv={Hkv} D={D} bf16 cache",
                max_err(got, want), tol,
                timer(lambda: decode_attention(q, k, v, kv_pos, q_pos)),
                timer(lambda: decode_attention_ref(q, k, v, kv_pos, q_pos)),
                lib, nbytes, 4 * E * Hq * D)
        log_against_sdpa(rep, host_us(torch, lambda: decode_attention(
            q, k, v, kv_pos, q_pos)))


def prefill_cases(torch, timer, rep):
    from repro_torch.kernels.decode_attention import dequant_chunk
    from repro_torch.kernels.prefill_attention import (prefill_attention,
                                                       prefill_attention_ref,
                                                       quantize_kv_ref)
    gen = torch.Generator(device="cuda").manual_seed(2)
    T, C, Sq, pos_start, length = 1024, 4, 96, 384, 96
    for arch, Hq, Hkv, D in (("stablelm-1.6b", 32, 32, 64),
                             ("chatglm3-6b", 32, 2, 128),
                             ("moonshot-v1-16b-a3b", 16, 16, 128),
                             ("kimi-k2-1t-a32b", 64, 8, 112)):
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
        lib = _sdpa_prefill(torch, timer, q, dequant_chunk(ck, ks, kz),
                            dequant_chunk(cv, vs, vz), kn, vn, kv_pos,
                            pos_start, length)
        Ec = int(((kv_pos >= 0) & (kv_pos < pos_start)).sum())
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
        log_against_sdpa(rep, host_us(torch, lambda: prefill_attention(
            q, kn, vn, ck, cv, kv_pos, pos_start, length, *sc)))


def _sdpa_prefill(torch, timer, q, kd, vd, kn, vn, kv_pos, pos_start, length):
    """SDPA's time over the dequantized cache rows and the chunk's K/V
    (bf16), with the same mask: the library yardstick of a prefill
    case."""
    import torch.nn.functional as F
    Sq, Hq, _ = q.shape
    T, Hkv = kd.shape[:2]
    G = Hq // Hkv         # heads expanded and types cast before timing
    keys, vals = (torch.cat([c.to(q.dtype), n.to(q.dtype)], 0)
                  .transpose(0, 1)[None].repeat_interleave(G, 1)
                  for c, n in ((kd, kn), (vd, vn)))
    cache_ok = (kv_pos >= 0) & (kv_pos < pos_start)
    idx = torch.arange(Sq, device="cuda")
    causal = (idx[None, :] <= idx[:, None]) & (idx[None, :] < length)
    mask = torch.cat([cache_ok[None].expand(Sq, T), causal], 1)[None, None]
    qs = q.transpose(0, 1)[None]
    return timer(lambda: F.scaled_dot_product_attention(
        qs, keys, vals, attn_mask=mask))


def prefill_mode_cases(torch, timer, rep):
    """The static and verify modes of prefill attention at the serving
    shapes: a 96-token chunk with static scales, and a 4-row verify
    window (spec_k = 3) over int8 dynamic, int8 static and fp32 caches,
    each at position 384 of a 1024-row slot, for stablelm-1.6b and
    chatglm3-6b; then a bf16 cache (the engine's ``kv_dtype="bfloat16"``)
    under the 96-token chunk and the 4-row verify window; the times are
    the wrapper's (with its quantize launches). The codes the wrapper
    returns must equal the plain quantizers'."""
    from repro_torch.kernels.decode_attention import dequant_chunk
    from repro_torch.kernels.prefill_attention import (
        prefill_attention, prefill_attention_ref, quantize_kv_ref,
        quantize_kv_static_ref, window_kv)
    gen = torch.Generator(device="cuda").manual_seed(5)
    T, C, pos_start = 1024, 4, 384
    cases = [("static", 96, False), ("dynamic", 4, True),
             ("static", 4, True), ("fp32", 4, True), ("bf16", 96, False),
             ("bf16", 4, True)]
    for arch, Hq, Hkv, D in (("stablelm-1.6b", 32, 32, 64),
                             ("chatglm3-6b", 32, 2, 128),
                             ("kimi-k2-1t-a32b", 64, 8, 112)):
        for mode, Sq, verify in cases:
            length = Sq
            f = lambda *s: torch.randn(s, generator=gen, device="cuda").to(
                torch.bfloat16)
            q, kn, vn = f(Sq, Hq, D), f(Sq, Hkv, D), f(Sq, Hkv, D)
            kc, vc = f(T, Hkv, D), f(T, Hkv, D)
            if mode == "static":
                ks, kz = static_scales_of(torch, kc, C)
                vs, vz = static_scales_of(torch, vc, C)
                ck, cv = (quantize_kv_static_ref(kc, ks, kz),
                          quantize_kv_static_ref(vc, vs, vz))
                sc = (ks, kz, vs, vz)
            elif mode == "dynamic":
                ck, ks, kz = quantize_kv_ref(kc, C)
                cv, vs, vz = quantize_kv_ref(vc, C)
                sc = (ks, kz, vs, vz)
            elif mode == "bf16":
                ck, cv, sc = kc, vc, ()
            else:
                ck, cv, sc = kc.float(), vc.float(), ()
            kv_pos = torch.full((T,), -1, dtype=torch.int32, device="cuda")
            kv_pos[:pos_start + 1] = torch.arange(pos_start + 1, device="cuda",
                                                  dtype=torch.int32)
            args = (q, kn, vn, ck, cv, kv_pos, pos_start, length, *sc)
            got, gaux = prefill_attention(*args, verify=verify)
            want = prefill_attention_ref(*args, verify=verify)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                fail(f"prefill {arch} {mode}: non-finite output")
            if mode == "static":
                waux = (quantize_kv_static_ref(kn, ks, kz),
                        quantize_kv_static_ref(vn, vs, vz))
            elif mode == "dynamic":
                wk_, wv_ = quantize_kv_ref(kn, C), quantize_kv_ref(vn, C)
                waux = (wk_[0], wv_[0], wk_[1], wk_[2], wv_[1], wv_[2])
            else:
                waux = ()
            if len(gaux) != len(waux) or not all(
                    torch.equal(a, b) for a, b in zip(gaux, waux)):
                fail(f"prefill {arch} {mode}: the chunk's codes differ from "
                     f"the plain quantizer's")
            tol = 2 ** -7 * max(1.0, float(want.float().abs().max()))
            kd, vd = (ck, cv) if mode in ("fp32", "bf16") else \
                (dequant_chunk(ck, ks, kz), dequant_chunk(cv, vs, vz))
            wkd, wvd = window_kv(kn, vn, ck.dtype, sc, verify)
            lib = _sdpa_prefill(torch, timer, q, kd, vd, wkd, wvd, kv_pos,
                                pos_start, length)
            Ec = int(((kv_pos >= 0) & (kv_pos < pos_start)).sum())
            pairs = sum(min(i + 1, length) for i in range(Sq))
            row = {"static": 2 * D, "dynamic": 2 * D + 2 * 2 * C * 4,
                   "fp32": 2 * D * 4, "bf16": 2 * D * 2}[mode]
            out = {"static": 2 * Sq * Hkv * D, "fp32": 0, "bf16": 0,
                   "dynamic": 2 * Sq * Hkv * (D + 2 * C * 4)}[mode]
            nbytes = Ec * Hkv * row + T * 4 + (Sq * Hq * D * 2) * 2 + \
                2 * Sq * Hkv * D * 2 + out + \
                (4 * Hkv * C * 4 if mode == "static" else 0)
            rep.add(f"{arch} {'verify ' if verify else ''}{mode}"
                    f"{' cache' if mode == 'bf16' else ''} Sq={Sq} "
                    f"pos_start={pos_start} T={T} Hkv={Hkv} D={D}",
                    max_err(got, want), tol,
                    timer(lambda: prefill_attention(*args, verify=verify)),
                    timer(lambda: prefill_attention_ref(*args,
                                                        verify=verify)),
                    lib, nbytes, 4 * Hq * D * (Ec * Sq + pairs))
            log_against_sdpa(rep, host_us(torch, lambda: prefill_attention(
                *args, verify=verify)))


#: the write cases' (arch, Hkv, D) and cache modes by default
WRITE_ARCHS = (("stablelm-1.6b", 32, 64), ("chatglm3-6b", 2, 128),
               ("kimi-k2-1t-a32b", 8, 112))
WRITE_CASE_MODES = ("dynamic", "static", "fp", "fp bf16")


def kv_write_cases(torch, timer, rep, srep, archs=WRITE_ARCHS,
                   modes=WRITE_CASE_MODES, standalone=True):
    """The K/V cache write ``write_kv_rows`` (one launch a layer write:
    K and V quantized together, codes, scales and kv_pos stored in the
    slot rows) at its main-path shapes, bf16 K/V into a layer of 8 slots
    x 1024 rows: stablelm-1.6b's and chatglm3-6b's 96-row chunk at 384
    with a padded tail (length 90), their 8-slot decode write, and a
    4-row verify window of the last slot at T - 2 (two rows past T,
    dropped); in the dynamic and fp modes (fp32 and bf16 destinations)
    into ``rep`` and the static one into ``srep``. Every byte of the destination (rows, scales, kv_pos;
    stale bytes everywhere before) equals the plain version's, and most
    static codes fall strictly inside the range. The bound counts K/V
    read once, the kept rows' codes (fp32 rows), scales and kv_pos
    written once, and the static constants and decode positions read.
    Then the standalone ``quantize_kv`` and ``quantize_kv_static`` (the
    same kernel with a dense destination) at 96 and 8 rows, codes and
    scales exact (with ``standalone``). ``archs``: (arch, Hkv, D);
    ``modes``: the write modes, "fp bf16" and "fp f16" the fp mode into
    bf16 and float16 rows."""
    from repro_torch.kernels.prefill_attention import (
        quantize_kv, quantize_kv_ref, quantize_kv_static,
        quantize_kv_static_ref, write_kv_rows, write_kv_rows_ref)
    gen = torch.Generator(device="cuda").manual_seed(7)
    N, T, C = 8, 1024, 4
    f = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    depths = torch.tensor([1000, 513, 0, 17, 256, 777, 64, 1023],
                          dtype=torch.int32, device="cuda")
    for arch, Hkv, D in archs:
        for what, R, kw, kept in (
                ("chunk", 96, dict(slot=3, pos_start=384, length=90), 96),
                ("decode", N, dict(positions=depths), N),
                ("verify window", 4, dict(slot=N - 1, pos_start=T - 2,
                                          length=2), 2)):
            k = (f(R, Hkv, D) * 2).to(torch.bfloat16)
            v = f(R, Hkv, D).to(torch.bfloat16)
            for mode in modes:
                kv_pos = torch.randint(-1, T, (N, T), generator=gen,
                                       device="cuda", dtype=torch.int32)
                if mode in ("fp bf16", "fp f16"):
                    dt = torch.bfloat16 if mode == "fp bf16" else \
                        torch.float16
                    dst = [f(N, T, Hkv, D).to(dt), f(N, T, Hkv, D).to(dt),
                           kv_pos]
                elif mode == "fp":
                    dst = [f(N, T, Hkv, D), f(N, T, Hkv, D), kv_pos]
                else:
                    dst = [torch.randint(-128, 128, (N, T, Hkv, D),
                                         generator=gen, device="cuda",
                                         dtype=torch.int8)
                           for _ in range(2)] + [kv_pos]
                    dst += [f(N, T, Hkv, C) for _ in range(4)] \
                        if mode == "dynamic" else \
                        [*static_scales_of(torch, k, C, gen),
                         *static_scales_of(torch, v, C, gen)]
                want = [t.clone() for t in dst]
                write_kv_rows_ref(k, v, *want, **kw)
                write_kv_rows(k, v, *dst, **kw)
                torch.cuda.synchronize()
                err = max(max_err(a, b) for a, b in zip(dst, want))
                if mode == "static":
                    codes = quantize_kv_static_ref(k, *dst[3:5])
                    inside = float(((codes > -128) & (codes < 127)).float()
                                   .mean())
                    if inside <= 0.5:
                        fail(f"kv_write {arch} {what}: only {inside:.2f} of "
                             f"the static codes fall inside the range; the "
                             f"check would test the clip")
                row = 2 * Hkv * D * {"fp": 4, "fp bf16": 2,
                                     "fp f16": 2}.get(mode, 1) + \
                    4 + \
                    (2 * 2 * Hkv * C * 4 if mode == "dynamic" else 0)
                nbytes = 2 * R * Hkv * D * 2 + kept * row + \
                    (4 * Hkv * C * 4 if mode == "static" else 0) + \
                    (N * 4 if what == "decode" else 0)
                r = srep if mode == "static" else rep
                r.add(f"{arch} {what} ({R}, {Hkv}, {D}) {mode}", err, 0.0,
                      timer(lambda: write_kv_rows(k, v, *dst, **kw)),
                      timer(lambda: write_kv_rows_ref(k, v, *want, **kw)),
                      None, nbytes, 4 * 2 * R * Hkv * D)
                c = r.cases[-1]
                c["bound_share"] = c["bound_ms"] / c["ms"]
                c["host_us"] = host_us(torch, lambda: write_kv_rows(
                    k, v, *dst, **kw))
                log(f"  {'':18s} {'':44s} {100 * c['bound_share']:.2f}% of "
                    f"its bound ({c['bound_by']}); wrapper host time "
                    f"{c['host_us']:.1f} us a call")
        # the standalone quantizers (the same kernel, a dense destination)
        # at the chunk's and the decode write's rows, K alone
        for R in (96, N) if standalone else ():
            x = (f(R, Hkv, D) * 2).to(torch.bfloat16)
            sz = static_scales_of(torch, x, C, gen)
            n = x.numel()
            for r, name, fn, ref, nbytes in (
                    (rep, "quantize_kv", lambda: quantize_kv(x, C),
                     lambda: quantize_kv_ref(x, C), 3 * n + 8 * n // (D // C)),
                    (srep, "quantize_kv_static",
                     lambda: quantize_kv_static(x, *sz),
                     lambda: quantize_kv_static_ref(x, *sz),
                     3 * n + 8 * Hkv * C)):
                got, want = fn(), ref()
                torch.cuda.synchronize()
                err = max(max_err(a, b) for a, b in
                          zip(*(t if isinstance(t, tuple) else (t,)
                                for t in (got, want))))
                r.add(f"{arch} {name} ({R}, {Hkv}, {D})", err, 0.0,
                      timer(fn), timer(ref), None, nbytes, 4 * n)


def wkv_cases(torch, timer, rep):
    """The chunked WKV at rwkv6-3b's full-width wave prefill: 8 sequences
    x 40 heads at T=256 and at the first wave's padded length T=240, and
    one sequence (40 heads) at T=256; head size 64, bf16 r/k/v, fp32
    w/u/s0."""
    from repro_torch.kernels import build
    from repro_torch.kernels.wkv_chunked import (CHUNK, wkv_chunked,
                                                 wkv_chunked_ref, wkv_plan)
    gen = torch.Generator(device="cuda").manual_seed(3)
    K = V = 64
    lib = build.library()
    for BH, T in ((8 * 40, 256), (8 * 40, 240), (40, 256)):
        f = lambda *s: torch.randn(s, generator=gen, device="cuda")
        r, k, v = (f(BH, T, n).to(torch.bfloat16) for n in (K, K, V))
        w = torch.exp(-torch.exp(f(BH, T, K) * 2 - 1))
        u, s0 = f(BH, K) * 0.5, f(BH, K, V)
        y, S = wkv_chunked(r, k, v, w, u, s0=s0)
        y_ref, S_ref = wkv_chunked_ref(r, k, v, w, u, s0=s0)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(y).all()) and
                bool(torch.isfinite(S).all())):
            fail("wkv_chunked: non-finite output")
        # y is rounded to bf16 on both sides: ≲ 2^-8 relative to its
        # scale; S stays fp32 (summation order): 1e-4 relative
        s_err = max_err(S, S_ref)
        s_tol = 1e-4 * max(1.0, float(S_ref.abs().max()))
        if not s_err <= s_tol:
            fail(f"wkv_chunked: S_final max abs err {s_err} > tol {s_tol}")
        tol = 2 ** -7 * max(1.0, float(y_ref.float().abs().max()))
        n, L = T // CHUNK, CHUNK
        pairs = L * (L + 1) // 2            # causal (t, s) pairs per chunk
        ops = BH * n * (3 * K * pairs + 2 * V * pairs + 4 * L * K * V +
                        2 * K * V + 4 * L * K)
        nbytes = BH * T * (2 * K * 2 + V * 2 + K * 4 + V * 2) + \
            BH * K * 4 + 2 * BH * K * V * 4
        plan = wkv_plan(BH, K, V, build.sm_count(0), 2)
        if plan.smem != lib.wkv_chunked_smem(K, 1):
            fail(f"wkv_chunked: the plan's shared memory {plan.smem} B is "
                 f"not the kernel's {lib.wkv_chunked_smem(K, 1)} B")
        rep.add(f"rwkv6-3b BH={BH} T={T} K={K} V={V} bf16, s0 "
                f"(S_final err {s_err:.2e} tol {s_tol:.1e})",
                max_err(y, y_ref), tol,
                timer(lambda: wkv_chunked(r, k, v, w, u, s0=s0)),
                timer(lambda: wkv_chunked_ref(r, k, v, w, u, s0=s0)), None,
                nbytes, ops)
        c = rep.cases[-1]
        # the plan's slab against the narrower ones (direct launches of
        # the library, not counted): the evidence for wkv_plan's choice
        slabs = {}
        for vs in (32, 16):
            yy, ss = torch.empty_like(y), torch.empty_like(S)
            launch = lambda: build.check(lib, lib.wkv_chunked(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr(), yy.data_ptr(), ss.data_ptr(),
                BH, T, K, V, vs, 1, build.stream_of(r)), "wkv_chunked")
            launch()
            torch.cuda.synchronize()
            if max_err(yy, y) > tol or max_err(ss, S) > s_tol:
                fail(f"wkv_chunked: slab {vs} disagrees with slab {plan.vs}")
            slabs[vs] = timer(launch)
        c["slab_ms"] = {str(plan.vs): c["ms"],
                        **{str(vs): t for vs, t in slabs.items()}}
        log(f"  {'':18s} {'':44s} {100 * c['bound_ms'] / c['ms']:.1f}% of "
            f"its bound ({c['bound_by']}); fp32-core floor "
            f"{c['fp32_core_ms']:.5f} ms; slab {plan.vs} of {V} columns, "
            f"{2 * BH * -(-V // plan.vs)} blocks of {plan.threads} threads, "
            f"{plan.smem} B shared memory a block; slabs of 32 / 16 columns "
            f"{slabs[32]:.4f} / {slabs[16]:.4f} ms")


def wkv_bwd_cases(torch, timer, rep):
    """The WKV backward at rwkv6-3b's training shapes: 8 sequences x 40
    heads at T = 128 (launch.train's batch) and T = 256, head size 64,
    bf16 r/k/v/ȳ, fp32 w/u/s0/S̄, with and without s0, against its plain
    version: dr, dk, dv (bf16 on both sides) within 2e-2 of their scale,
    dw ⊙ w, du and ds0 within 1e-4; two launches bit-identical. The bound
    counts each input read and each output written once, and the 14 fp32
    operations a state element and step (the state forwards and its
    gradient backwards, 3 each; the dr, dk, dw and dv sums, 2 each), by
    the table's rule; the time of those operations at the fp32 rate
    outside the tensor cores (67 TFLOP/s) is printed beside it
    (``fp32_core_ms``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.wkv_chunked import (wkv_bwd_slab,
                                                 wkv_chunked_bwd,
                                                 wkv_chunked_bwd_ref)
    gen = torch.Generator(device="cuda").manual_seed(4)
    K = V = 64
    lib = build.library()
    for (BH, T), with_s0 in (((320, 128), True), ((320, 128), False),
                             ((320, 256), True), ((320, 256), False)):
        f = lambda *s: torch.randn(s, generator=gen, device="cuda")
        r, k, v, yb = (f(BH, T, n).to(torch.bfloat16) for n in (K, K, V, V))
        w = torch.exp(-torch.exp(f(BH, T, K) * 2 - 1))
        u, Sb = f(BH, K) * 0.5, f(BH, K, V)
        s0 = f(BH, K, V) if with_s0 else None
        args = (r, k, v, w, u, s0, yb, Sb)
        got = wkv_chunked_bwd(*args)
        again = wkv_chunked_bwd(*args)
        want = wkv_chunked_bwd_ref(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None):
            fail(f"wkv_chunked_bwd BH={BH} T={T}: two launches on the same "
                 f"inputs differ")
        if not all(bool(torch.isfinite(g).all()) for g in got
                   if g is not None):
            fail("wkv_chunked_bwd: non-finite gradient")
        errs = {}
        pairs = list(zip(("dr", "dk", "dv", "dw*w", "du", "ds0"),
                         (*got[:3], got[3] * w, *got[4:]),
                         (*want[:3], want[3] * w, *want[4:])))
        for name, g, x in pairs:
            if x is None:
                continue
            scale = float(x.float().abs().max())
            rel = 2e-2 if name in ("dr", "dk", "dv") else 1e-4
            errs[name] = (max_err(g, x), rel * scale)
        bad = {n: e for n, e in errs.items() if not e[0] <= e[1]}
        if bad:
            fail(f"wkv_chunked_bwd BH={BH} T={T} s0={with_s0}: (err, tol) "
                 f"{bad}")
        worst = max(errs, key=lambda n: errs[n][0] / errs[n][1])
        ops = 14 * BH * T * K * V
        nbytes = BH * T * (2 * K * 2 + 2 * V * 2 + K * 4) + BH * K * 4 + \
            BH * K * V * 4 * (1 + with_s0) + \
            BH * T * (2 * K * 2 + V * 2 + K * 4) + BH * K * 4 + \
            BH * K * V * 4 * with_s0
        vs = wkv_bwd_slab(K, V)
        rep.add(f"rwkv6-3b train BH={BH} T={T} K={K} V={V} bf16"
                f"{', s0' if with_s0 else ''} (worst {worst})",
                errs[worst][0], errs[worst][1],
                timer(lambda: wkv_chunked_bwd(*args)),
                timer(lambda: wkv_chunked_bwd_ref(*args)), None, nbytes, ops)
        c = rep.cases[-1]
        c["errs"] = errs
        log(f"  {'':18s} {'':44s} {100 * c['bound_ms'] / c['ms']:.1f}% of "
            f"its bound ({c['bound_by']}); fp32-core ops time "
            f"{c['fp32_core_ms']:.5f} ms; every output (err, tol): "
            + ", ".join(f"{n} {e[0]:.2e}/{e[1]:.1e}" for n, e in errs.items())
            + f"; two launches bit-identical; slab {vs} of {V} columns, "
            f"{BH * -(-V // vs)} blocks of 512 threads, "
            f"{lib.wkv_chunked_bwd_smem(K, vs)} B shared memory a block")


def static_qparams(torch, x, n_chunks, bits, gen):
    """Per-chunk (S, Z) over ``array_split`` chunks that make S·x + Z
    cover the code range: S = (2^b − 1) / (chunk max − min) · U(0.5, 2),
    Z centres the chunk's range on the codes with a fractional offset
    U(−0.5, 0.5), so most codes are inside [qmin, qmax] and the exact
    check holds the rounding of S·x + Z, not the clip."""
    from repro_torch.core.splitquant import activation_chunk_bounds
    xf = x.float()
    b = activation_chunk_bounds(x.shape[1], n_chunks)
    lo = torch.stack([xf[:, s:e].min() for s, e in zip(b[:-1], b[1:])])
    hi = torch.stack([xf[:, s:e].max() for s, e in zip(b[:-1], b[1:])])
    u = torch.rand((2, n_chunks), generator=gen, device=x.device)
    scale = (2 ** bits - 1) / (hi - lo) * (0.5 + 1.5 * u[0])
    return scale, -0.5 - scale * (hi + lo) / 2 + (u[1] - 0.5)


def act_quant_cases(torch, timer, drep, srep):
    """Both act-quant kernels at rwkv6-3b activation shapes (a wave of
    2048 tokens at widths 2560 and 8960, bf16), exactly equal to their
    plain versions: dynamic with 4 chunks, static with 3 (uneven on both
    widths); then odd widths and views off a 16-byte boundary. Each of
    the first cases runs once more through its ``*_observed`` wrapper
    with a ``RegistryQuantProbe`` installed: the gauges must equal
    ``code_stats`` of the plain version's codes."""
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels.act_quant import (
        act_split_quantize, act_split_quantize_ref, act_split_quantize_static,
        act_split_quantize_static_ref)
    from repro_torch.obs import MetricsRegistry, RegistryQuantProbe, \
        code_stats
    gen = torch.Generator(device="cuda").manual_seed(4)
    R = 2048
    observed = []

    def observe(run, want_q, what):
        reg = MetricsRegistry()
        aq.set_quality_probe(RegistryQuantProbe(reg))
        try:
            run()
        finally:
            aq.set_quality_probe(None)
        snap, cs = reg.snapshot(), code_stats(want_q.cpu().numpy())
        got = (snap["act_quant_observations_total"],
               snap["act_quant_clip_frac"], snap["act_quant_occupancy"])
        if got != (1.0, cs["clip_frac"], cs["occupancy"]):
            fail(f"{what}: RegistryQuantProbe gauges {got} != code_stats "
                 f"of the plain version's codes {cs}")
        observed.append((what, got))
    for N in (2560, 8960):
        x = (torch.randn((R, N), generator=gen, device="cuda") * 2).to(
            torch.bfloat16)
        for bits in (2, 4, 8):
            got = act_split_quantize(x, bits=bits, n_chunks=4)
            want = act_split_quantize_ref(x, bits=bits, n_chunks=4)
            torch.cuda.synchronize()
            err = max(max_err(a, b) for a, b in zip(got, want))
            drep.add(f"R={R} N={N} bits={bits} n_chunks=4 bf16", err, 0.0,
                     timer(lambda: act_split_quantize(x, bits=bits,
                                                      n_chunks=4)),
                     timer(lambda: act_split_quantize_ref(x, bits=bits,
                                                          n_chunks=4)),
                     None, R * N * 2 + R * N + 2 * R * 4 * 4, 4 * R * N)
            observe(lambda: aq.act_split_quantize_observed(
                x, bits=bits, n_chunks=4), want[0],
                f"act_split_quantize_observed N={N} bits={bits}")
            scale, zero = static_qparams(torch, x, 3, bits, gen)
            got = act_split_quantize_static(x, scale, zero, bits=bits)
            want = act_split_quantize_static_ref(x, scale, zero, bits=bits)
            torch.cuda.synchronize()
            inside = float(((got > -2 ** (bits - 1)) &
                            (got < 2 ** (bits - 1) - 1)).float().mean())
            if inside <= 0.5:
                fail(f"act_split_quantize_static: only {inside:.2f} of the "
                     f"codes fall inside the range; the check would test "
                     f"the clip, not the rounding")
            srep.add(f"R={R} N={N} bits={bits} n_chunks=3 bf16",
                     max_err(got, want), 0.0,
                     timer(lambda: act_split_quantize_static(x, scale, zero,
                                                             bits=bits)),
                     timer(lambda: act_split_quantize_static_ref(
                         x, scale, zero, bits=bits)),
                     None, R * N * 2 + R * N + 2 * 3 * 4, 4 * R * N)
            observe(lambda: aq.act_split_quantize_static_observed(
                x, scale, zero, bits=bits), want,
                f"act_split_quantize_static_observed N={N} bits={bits}")
    # the scalar heads and tails: an odd width on a view that starts one
    # element into its storage (every row misaligned), and a view three
    # elements in (a head of five columns, vectors, a tail); the dynamic
    # kernel on 2562 columns in 3 chunks (854 each: every chunk starts
    # elsewhere against a 16-byte boundary), aligned and one element in,
    # and on the 8960-wide view three elements in
    for N, offset in ((2562, 0), (2562, 1), (8960, 3)):
        big = (torch.randn(R * N + offset, generator=gen, device="cuda") *
               2).to(torch.bfloat16)
        x = big[offset:].view(R, N)
        n_chunks = 3 if N == 2562 else 4
        got = act_split_quantize(x, bits=8, n_chunks=n_chunks)
        want = act_split_quantize_ref(x, bits=8, n_chunks=n_chunks)
        torch.cuda.synchronize()
        err = max(max_err(a, b) for a, b in zip(got, want))
        drep.add(f"R={R} N={N} bits=8 n_chunks={n_chunks} bf16, view "
                 f"+{offset}", err, 0.0,
                 timer(lambda: act_split_quantize(x, bits=8,
                                                  n_chunks=n_chunks)),
                 timer(lambda: act_split_quantize_ref(x, bits=8,
                                                      n_chunks=n_chunks)),
                 None, R * N * 2 + R * N + 2 * R * n_chunks * 4, 4 * R * N)
    for N, offset in ((2563, 1), (8960, 3)):
        big = (torch.randn(R * N + offset, generator=gen, device="cuda") *
               2).to(torch.bfloat16)
        x = big[offset:].view(R, N)
        scale, zero = static_qparams(torch, x, 3, 8, gen)
        got = act_split_quantize_static(x, scale, zero, bits=8)
        want = act_split_quantize_static_ref(x, scale, zero, bits=8)
        torch.cuda.synchronize()
        srep.add(f"R={R} N={N} bits=8 n_chunks=3 bf16, view +{offset}",
                 max_err(got, want), 0.0,
                 timer(lambda: act_split_quantize_static(x, scale, zero,
                                                         bits=8)),
                 timer(lambda: act_split_quantize_static_ref(
                     x, scale, zero, bits=8)),
                 None, R * N * 2 + R * N + 2 * 3 * 4, 4 * R * N)
    log(f"  act-quant observed wrappers with a RegistryQuantProbe: "
        f"{len(observed)} calls, gauges (calls, clip fraction, occupancy) "
        f"== code_stats of the plain codes: "
        + "; ".join(f"{w} {g[1]:.4f} / {g[2]:.4f}" for w, g in observed))
    return observed


def log_ptxas(out: str) -> None:
    """Registers, spills and shared memory of each instantiation of the
    tensor-core matmul kernel, the two attention kernels, the WKV kernel
    and the two act-quant kernels, from the build's ``-Xptxas -v``
    output, and their dynamic shared memory at the shapes of the kernel
    phase."""
    kernels = ("sq_matmul_wgmma_kernel", "decode_split_kernel",
               "prefill_tc_kernel", "wkv_kernel", "wkv_bwd_kernel",
               "act_quant_static_kernel", "act_quant_dynamic_kernel")
    if not any(k in out for k in kernels):
        log("ptxas: the library was already built; no compiler output")
        return
    lines = out.splitlines()
    for i, line in enumerate(lines):
        for k in kernels:
            if "Function properties for" in line and k in line:
                inst = line.split(k)[1].split("EEv")[0]
                log(f"ptxas {k}{inst}: {lines[i + 1].strip()}; "
                    f"{lines[i + 2].strip()}")
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_plan
    lib = build.library()
    log("matmul dynamic shared memory per block (bits, BM): " + ", ".join(
        f"({b}, {bm}) {lib.splitquant_matmul_smem(b, bm)} B"
        for b in (2, 4, 8) for bm in (64, 128)))
    for arch, Hq, Hkv, D in (("stablelm-1.6b", 32, 32, 64),
                             ("chatglm3-6b", 32, 2, 128),
                             ("moonshot-v1-16b-a3b", 16, 16, 128),
                             ("kimi-k2-1t-a32b", 64, 8, 112),
                             ("paligemma-3b", 8, 1, 256)):
        p = decode_plan(8, 1024, Hkv, Hq // Hkv, build.sm_count(0), D)
        smem = [lib.decode_attention_smem(D, 4, 1, st, p.group, p.warps)
                for st in (0, 1)]
        log(f"attention dynamic shared memory per block, {arch} int8 C=4: "
            f"decode {smem[0]} B dynamic, {smem[1]} B static ({p}), prefill "
            f"{lib.prefill_attention_smem(D, 4, 1, 1024)} B; bf16 cache: "
            f"decode {lib.decode_attention_smem(D, 0, 2, 0, p.group, p.warps)}"
            f" B, prefill {lib.prefill_attention_smem(D, 0, 2, 1024)} B; fp32 "
            f"cache: decode "
            f"{lib.decode_attention_smem(D, 0, 4, 0, p.group, p.warps)} B, "
            f"prefill {lib.prefill_attention_smem(D, 0, 4, 1024)} B")
    log("wkv dynamic shared memory per block (K=V=64, bf16 / fp32): "
        f"{lib.wkv_chunked_smem(64, 1)} / {lib.wkv_chunked_smem(64, 0)} B; "
        f"its backward (K=64, 16 columns): "
        f"{lib.wkv_chunked_bwd_smem(64, 16)} B")


#: the ``write_kv_rows`` modes behind each of its two kernel names
WRITE_NAMES = {"kv_write": ("dynamic", "fp"), "kv_write_static": ("static",)}


def launch_counts(counters) -> dict:
    """Each kernel's launches since the last reset (the write's two names
    by their modes)."""
    return {name: sum(c.mode_launches[m] for m in WRITE_NAMES[name])
            if name in WRITE_NAMES else c.launches
            for name, c in counters.items()}


def one_write_per_layer(phase: str, n_layers: int, passes: dict) -> dict:
    """The K/V writes of a serving run since the last reset: one
    ``write_kv_rows`` launch a layer and forward pass, in its cache's
    mode: ``passes`` gives the run's forward passes by cache mode, so the
    writes of each mode must be ``n_layers`` times those (and equal that
    mode's attention launches, one a layer and pass too); no other mode
    and no standalone quantizer may run. Returns the writes by mode."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    writes = dict(pa.write_kv_rows.mode_launches)
    want = {m: n_layers * passes.get(m, 0) for m in writes}
    dm = da.decode_attention.mode_launches
    pm = pa.prefill_attention.mode_launches
    attn = {m: dm.get(m, 0) + pm[m] + pm[f"verify_{m}"] for m in writes}
    if writes != want or writes != attn or not any(writes.values()) or \
            pa.quantize_kv.launches or pa.quantize_kv_static.launches:
        fail(f"{phase}: K/V writes by mode {writes}; expected {want} "
             f"({n_layers} layers x forward passes by mode {passes}); "
             f"attention launches by mode {attn}; standalone quantizes "
             f"{pa.quantize_kv.launches} dynamic, "
             f"{pa.quantize_kv_static.launches} static")
    return writes


def reset_counts(counters) -> None:
    """Every kernel's launch count to 0, the per-variant and per-mode
    counts of the matmul and the two attention kernels too."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import splitquant_matmul as sqm
    for c in counters.values():
        c.launches = 0
    for mod in (sqm, pa, da):
        mod.reset_counts()


def only_variant(counters, name: str, phase: str) -> dict:
    """``name``'s launches by variant since the last reset. A bf16 serving
    run must have gone through the matmul's and the prefill attention's
    tensor-core kernels only, and through the decode attention with T
    split across blocks only."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import splitquant_matmul as sqm
    want, other = {"splitquant_matmul": (sqm.TENSOR_CORE, sqm.CUDA_CORE),
                   "prefill_attention": (pa.TENSOR_CORE, pa.CUDA_CORE),
                   "decode_attention": (da.SPLIT, da.WHOLE)}[name]
    v = dict(counters[name].variant_launches)
    if v[other] or not v[want]:
        fail(f"{phase}: the bf16 serving run launched the {name} variants "
             f"{v}; expected {want!r} only")
    return v


def only_modes(counters, phase: str, decode: set, prefill: set) -> dict:
    """The attention kernels' launches by mode since the last reset: each
    mode in ``decode`` / ``prefill`` launched, no other mode."""
    out = {}
    for name, want in (("decode_attention", decode),
                       ("prefill_attention", prefill)):
        m = dict(counters[name].mode_launches)
        if any(m[k] <= 0 for k in want) or \
                any(v for k, v in m.items() if k not in want):
            fail(f"{phase}: {name} launched the modes {m}; expected "
                 f"{sorted(want)} only")
        out[name] = m
    return out


# ------------------------------------------------------------- engine ---
def percentile(xs, p):
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p))


def engine_mod():
    import importlib
    return importlib.import_module("repro_torch.engine.engine")


def warm_up(cfg, params, ecfg, warmup, **engine_kw) -> None:
    """One request of 4 tokens through a throw-away engine of the run's
    configuration (no faults, journal or snapshots)."""
    import dataclasses
    from repro_torch.engine import Engine
    warm = Engine(cfg, params, dataclasses.replace(
        ecfg, fault_spec=None, journal_path=None, snapshot_path=None,
        snapshot_every=0), device="cuda", **engine_kw)
    warm.submit(warmup, 4)
    warm.drain()


def serve_run(torch, counters, phase, cfg, params, ecfg, warmup, prompts,
              snapshot_path=None, **engine_kw):
    """One engine serving run at full width: a warm-up engine, then the
    run with every launch count set to 0 just before and read just after.
    Returns (engine, finished requests, wall seconds, launches); the
    engine's ``materializations_in_run`` counts the run's one-shot fp
    prefill materializations. Given ``snapshot_path``, the run is stepped
    by hand with a ``SnapshotWriter`` of the engine's registry (each step
    ``maybe_write``, once more at drain); ``snapshots_written`` counts
    them."""
    from repro_torch.engine import Engine
    from repro_torch.obs import SnapshotWriter
    warm_up(cfg, params, ecfg, warmup, **engine_kw)
    eng = Engine(cfg, params, ecfg, device="cuda", **engine_kw)
    writer = None if snapshot_path is None else \
        SnapshotWriter(snapshot_path, eng.registry, interval_s=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    mat0 = engine_mod().FP_PREFILL_MATERIALIZATIONS
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p)
    if writer is None:
        fin = eng.drain()
    else:
        while not eng.sched.idle:
            eng.step()
            writer.maybe_write()
        fin = sorted(eng.sched.finished, key=lambda r: r.uid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    if writer is not None:
        writer.write()
        eng.snapshots_written = writer.seq
    eng.materializations_in_run = \
        engine_mod().FP_PREFILL_MATERIALIZATIONS - mat0
    if len(fin) != len(prompts) or \
            any(len(r.out) != ecfg.max_new_tokens for r in fin):
        fail(f"{phase}: expected {len(prompts)} requests x "
             f"{ecfg.max_new_tokens} tokens, got {[len(r.out) for r in fin]}")
    if any(not 0 <= t < cfg.vocab for r in fin for t in r.out):
        fail(f"{phase}: token id out of vocab")
    for name in (n for n, p in PATHS.items() if phase in p):
        if launches[name] <= 0:
            fail(f"{phase}: kernel {name} was not launched on its path")
    return eng, fin, wall, launches


def finite_logits(torch, phase, cfg, params, eng, fin):
    """One decode step of the run's first 8 requests at position 700 over
    the engine's cache: finite logits of shape (8, 1, vocab)."""
    from repro_torch.models import transformer
    logits = transformer.decode_step_slots(
        params, cfg, eng.cache,
        torch.tensor([[r.out[-1]] for r in fin[:8]], device="cuda"),
        torch.full((8,), 700, dtype=torch.int32, device="cuda"))
    if logits.shape != (8, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{phase}: non-finite or misshapen logits at full width")


def engine_phase(torch, counters, params, kv_scales=None):
    """The engine over the smoke workload, with dynamic int8 scales or,
    given ``kv_scales``, static ones. ``counters``: every kernel wrapper
    by name; all are set to 0 just before the run and read just after."""
    from repro_torch.launch.serve import smoke_workload

    cfg, ecfg, _, warmup, prompts = smoke_workload()
    phase = "engine" if kv_scales is None else "static"
    eng, fin, wall, launches = serve_run(
        torch, counters, phase, cfg, params, ecfg, warmup, prompts,
        kv_scales=kv_scales)
    variants = only_variant(counters, "splitquant_matmul", phase)
    pvariants = only_variant(counters, "prefill_attention", phase)
    dvariants = only_variant(counters, "decode_attention", phase)
    mode = "dynamic" if kv_scales is None else "static"
    modes = only_modes(counters, phase, {mode}, {mode})
    writes = one_write_per_layer(
        phase, cfg.n_layers,
        {mode: eng.n_decode_steps + eng.n_prefill_chunks})
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(r.out) for r in fin)
    # the logits the engine samples from are finite at full width
    finite_logits(torch, phase, cfg, params, eng, fin)
    ttft = [r.ttft for r in fin]
    res = {"arch": cfg.name, "kv_scales": mode, "requests": len(fin),
           "new_tokens": n_tok,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "wall_s": wall,
           "ttft_p50_s": percentile(ttft, 50),
           "ttft_p90_s": percentile(ttft, 90),
           "decode_step_p50_s": percentile(eng.decode_step_s, 50),
           "prefill_chunk_p50_s": percentile(eng.prefill_chunk_s, 50),
           "decode_steps": eng.n_decode_steps,
           "prefill_chunks": eng.n_prefill_chunks,
           "tokens_per_s": n_tok / wall, "peak_mem_bytes": peak,
           "kv_cache_bytes": eng.cache.nbytes(), "launches": launches,
           "matmul_variants": variants, "prefill_variants": pvariants,
           "decode_variants": dvariants,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes,
           "outputs": [r.out for r in fin],
           "decode_launches_per_step_layer":
               launches["decode_attention"] / eng.n_decode_steps
               / cfg.n_layers,
           "prefill_launches_per_chunk_layer":
               launches["prefill_attention"] / eng.n_prefill_chunks
               / cfg.n_layers}
    log(f"{phase}: {mode} KV scales, {len(fin)} requests, "
        f"{res['prompt_tokens']} prompt + {n_tok} new tokens in {wall:.3f} s "
        f"= {res['tokens_per_s']:.1f} tok/s; TTFT p50 "
        f"{res['ttft_p50_s'] * 1e3:.1f} ms; decode step p50 "
        f"{res['decode_step_p50_s'] * 1e3:.2f} ms; prefill chunk p50 "
        f"{res['prefill_chunk_p50_s'] * 1e3:.2f} ms; {eng.n_decode_steps} "
        f"decode steps, {eng.n_prefill_chunks} prefill chunks; peak memory "
        f"{peak / 2**30:.2f} GiB; KV cache {res['kv_cache_bytes'] / 2**20:.1f} "
        f"MiB; launches {launches}; matmul launches by variant {variants}; "
        f"prefill attention launches by variant {pvariants}, by mode "
        f"{modes['prefill_attention']}; decode attention launches by variant "
        f"{dvariants}, by mode {modes['decode_attention']}; K/V writes by "
        f"mode {writes} (one a layer and forward pass); per step and "
        f"layer: decode attention "
        f"{res['decode_launches_per_step_layer']:.2f}, prefill attention "
        f"{res['prefill_launches_per_chunk_layer']:.2f} (per chunk)")
    return res


def reliability_gates(torch, counters, phase, cfg, launches, mode, passes):
    """The launch gates of a reliability run: each kernel of its path
    launched, every launch of the bf16 tensor-core matmul and prefill and
    of the split decode (the engine phase's variants), only ``mode``'s
    attention and write modes, one write a layer and forward pass
    (``passes``: the run's forward passes, failed decode attempts
    included). Returns (matmul, prefill, decode variants, modes,
    writes)."""
    for name in (n for n, p in PATHS.items() if phase in p):
        if launches[name] <= 0:
            fail(f"{phase}: kernel {name} was not launched on its path")
    variants = tuple(only_variant(counters, n, phase)
                     for n in ("splitquant_matmul", "prefill_attention",
                               "decode_attention"))
    modes = only_modes(counters, phase, {mode}, {mode})
    writes = one_write_per_layer(phase, cfg.n_layers, {mode: passes})
    return (*variants, modes, writes)


def chaos_phase(torch, counters, params, eng_res, card_line):
    """The engine phase's run (dynamic int8 scales, 16 requests of 32
    tokens) under a seeded fault storm with the JAX package's chaos rates
    (``CHAOS_SPEC``): transient step exceptions, NaN-like corrupted
    tokens, stragglers and poisoned requests. Every failed decode attempt
    rolls the decoding slots back and runs again. Gates: every uid
    retires exactly once with a schema reason; steps were retried; every
    poisoned uid is "failed"; every survivor's tokens equal the engine
    phase's; no slot is occupied after the drain; the engine phase's
    kernel variants and modes, and one write a layer and pass."""
    import dataclasses
    from repro_torch.engine import (Engine, FaultInjector, FaultSpec,
                                    occupied_slots)
    from repro_torch.launch.serve import smoke_workload
    from repro_torch.obs.schema import RETIRE_REASONS
    cfg, ecfg, _, warmup, prompts = smoke_workload()
    phase = "chaos"
    spec = FaultSpec(**CHAOS_SPEC)
    probe = FaultInjector(spec)
    poisoned = [u for u in range(len(prompts)) if probe.note_submit(u)]
    if not poisoned:
        fail(f"{phase}: the seed poisons no request")
    ecfg = dataclasses.replace(ecfg, fault_spec=spec)
    warm_up(cfg, params, ecfg, warmup)
    eng = Engine(cfg, params, ecfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p)
    fin = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    m = eng.metrics()
    uids = sorted(r.uid for r in eng.sched.finished)
    if uids != list(range(len(prompts))) or \
            any(r.finish_reason not in RETIRE_REASONS for r in fin):
        fail(f"{phase}: retired uids {uids}, reasons "
             f"{[r.finish_reason for r in fin]}")
    if m["step_retries"] <= 0:
        fail(f"{phase}: no step was retried")
    reasons = {r.uid: r.finish_reason for r in fin}
    if any(reasons[u] != "failed" for u in poisoned):
        fail(f"{phase}: poisoned uids {poisoned} retired as "
             f"{[reasons[u] for u in poisoned]}")
    survivors = [r for r in fin if r.finish_reason == "budget"]
    want = eng_res["outputs"]
    bad = [r.uid for r in survivors if r.out != want[r.uid]]
    if not survivors or bad:
        fail(f"{phase}: {len(survivors)} survivors, tokens of uids {bad} "
             f"differ from the engine phase's")
    leak = occupied_slots(eng.cache)
    if leak or not eng.sched.idle:
        fail(f"{phase}: slots {leak} still occupied after the drain")
    mv, pv, dv, modes, writes = reliability_gates(
        torch, counters, phase, cfg, launches, "dynamic",
        eng.n_decode_steps + eng.n_prefill_chunks)
    n_tok = sum(len(r.out) for r in fin)
    res = {"arch": cfg.name, "card": card_line, "fault_spec": CHAOS_SPEC,
           "requests": len(fin), "survivors": len(survivors),
           "poisoned": poisoned, "retire_reasons": m["retire_reasons"],
           "step_retries": m["step_retries"],
           "quarantined": m["quarantined"],
           "faults_injected": m["faults_injected"], "new_tokens": n_tok,
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "decode_step_p50_s": percentile(eng.decode_step_s, 50),
           "decode_steps": eng.n_decode_steps,
           "prefill_chunks": eng.n_prefill_chunks,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "matmul_variants": mv,
           "prefill_variants": pv, "decode_variants": dv,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes,
           "finished": [(r.uid, r.finish_reason, r.out) for r in fin],
           "registry": m["registry"]}
    log(f"{phase}: the engine phase's 16 requests under a seeded fault "
        f"storm {CHAOS_SPEC}: injected {m['faults_injected']}; "
        f"{m['step_retries']} step retries, {m['quarantined']} quarantined "
        f"(poisoned uids {poisoned}); retire reasons {m['retire_reasons']}; "
        f"{len(survivors)} survivors token-identical to the engine phase; "
        f"{n_tok} new tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} "
        f"tok/s (engine phase {eng_res['tokens_per_s']:.1f}); decode step "
        f"p50 {res['decode_step_p50_s'] * 1e3:.2f} ms (engine phase "
        f"{eng_res['decode_step_p50_s'] * 1e3:.2f}); {eng.n_decode_steps} "
        f"decode dispatches (engine phase {eng_res['decode_steps']}); "
        f"launches {launches}; K/V writes by mode {writes} (one a layer and "
        f"forward pass, failed attempts included) [card: {card_line}]")
    return res


def observe_phase(torch, counters, params, cha_res, card_line):
    """The chaos phase's run (``CHAOS_SPEC``, its 16 requests, dynamic
    int8 scales) traced: ``trace=True`` with a ring that drops nothing,
    KV quality counters sampled every ``OBSERVE_KV_EVERY`` steps into the
    trace and into the registry's gauges, and the anomaly detectors
    armed with an incident directory in a temporary directory. Gates:
    the survivors' tokens, the retries and the quarantines equal the
    chaos phase's; the trace validates and dropped nothing; one KV sample
    every ``OBSERVE_KV_EVERY`` steps from step 0, each over valid rows;
    at least one incident bundle, each loading, its trigger in the
    detector catalog, and ``incident_report --validate`` 0 on each; the
    chaos phase's kernel variants and modes, one write a layer and pass.
    Printed, not gated: the phase attribution (coverage, dispatch and
    device-wait fractions), the traced tokens/s beside the chaos
    phase's, the KV clip fractions, and engine runs of the unfaulted,
    untraced workload with the flight recorder on and off in turns (on,
    off, off, on; tokens equal in all four)."""
    import contextlib as ctx
    import dataclasses
    import os
    import tempfile
    from repro_torch.engine import Engine, FaultSpec
    from repro_torch.launch.incident_report import main as report_main
    from repro_torch.launch.serve import smoke_workload
    from repro_torch.launch.trace_report import main as trace_main
    from repro_torch.obs import DETECTORS, load_incident_bundle
    from repro_torch.obs.schema import validate_events
    cfg, ecfg, _, warmup, prompts = smoke_workload()
    phase = "observe"
    warm_up(cfg, params, ecfg, warmup)
    with tempfile.TemporaryDirectory() as tmp:
        inc = os.path.join(tmp, "incidents")
        tcfg = dataclasses.replace(
            ecfg, fault_spec=FaultSpec(**CHAOS_SPEC), trace=True,
            trace_capacity=1 << 20, trace_kv_every=OBSERVE_KV_EVERY,
            metrics_kv_every=OBSERVE_KV_EVERY, incident_dir=inc)
        eng = Engine(cfg, params, tcfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p)
        fin = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(counters)
        m = eng.metrics()
        bundles = sorted(os.listdir(inc)) if os.path.isdir(inc) else []
        triggers, report_rcs = [], []
        for b in bundles:
            path = os.path.join(inc, b)
            try:
                bundle = load_incident_bundle(path)
            except ValueError as e:
                fail(f"{phase}: bundle {b} does not load: {e}")
            triggers.append(bundle["trigger.json"]["trigger"])
            with ctx.redirect_stdout(io.StringIO()):
                report_rcs.append(report_main([path, "--validate"]))
        trace_path = os.path.join(tmp, "trace.jsonl")
        eng.tracer.to_jsonl(trace_path)
        trace_out = io.StringIO()
        with ctx.redirect_stdout(trace_out):
            trace_rc = trace_main([trace_path, "--validate",
                                   "--waterfalls", "0"])
    if trace_rc != 0:
        fail(f"{phase}: trace_report --validate exits {trace_rc}:\n"
             f"{trace_out.getvalue()}")
    out = {r.uid: (r.finish_reason, r.out) for r in fin}
    want = {u: (r, o) for u, r, o in cha_res["finished"]}
    if out != want or m["step_retries"] != cha_res["step_retries"] or \
            m["quarantined"] != cha_res["quarantined"]:
        fail(f"{phase}: finished / retries / quarantines differ from the "
             f"chaos phase's: {m['step_retries']} vs "
             f"{cha_res['step_retries']} retries, {m['quarantined']} vs "
             f"{cha_res['quarantined']} quarantined, uids "
             f"{sorted(u for u in out if out[u] != want.get(u))}")
    records = list(eng.tracer.records())
    errs = validate_events(records)
    if errs or eng.tracer.dropped:
        fail(f"{phase}: trace errors {errs[:5]}, {eng.tracer.dropped} "
             f"dropped")
    steps = len(eng.step_s)
    kv = [r["value"] for r in eng.tracer.events
          if r["kind"] == "counter" and r["name"] == "kv_quality"]
    n_want = -(-steps // OBSERVE_KV_EVERY)      # steps 0, 4, 8, ...
    if len(kv) != n_want or any(v["valid_rows"] <= 0 for v in kv):
        fail(f"{phase}: {len(kv)} KV samples over {steps} steps (expected "
             f"{n_want}), valid rows {[v['valid_rows'] for v in kv]}")
    bad = [t for t in triggers if t["detector"] not in DETECTORS]
    if not bundles or bad or any(report_rcs):
        fail(f"{phase}: bundles {bundles}, triggers outside the catalog "
             f"{bad}, incident_report --validate exits {report_rcs}")
    mv, pv, dv, modes, writes = reliability_gates(
        torch, counters, phase, cfg, launches, "dynamic",
        eng.n_decode_steps + eng.n_prefill_chunks)
    pa = m["phase_attribution"]
    n_tok = sum(len(r.out) for r in fin)
    clips = {side: [v[f"{side}_clip_frac"] for v in kv]
             for side in ("k", "v")}
    # the flight recorder on and off in turns over the unfaulted,
    # untraced workload: tokens unchanged, tokens/s printed
    flight = []
    for on in (True, False, False, True):
        f_eng = Engine(cfg, params, dataclasses.replace(ecfg, flight=on),
                       device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for p in prompts:
            f_eng.submit(p)
        f_fin = f_eng.drain()
        torch.cuda.synchronize()
        f_wall = time.perf_counter() - t1
        f_tok = sum(len(r.out) for r in f_fin)
        flight.append({"flight": on, "wall_s": f_wall,
                       "tokens_per_s": f_tok / f_wall,
                       "flight_recorded": f_eng.metrics()["flight_recorded"],
                       "outputs": [r.out for r in f_fin]})
        del f_eng
    if any(f["outputs"] != flight[0]["outputs"] for f in flight):
        fail(f"{phase}: the flight recorder changed tokens")
    res = {"arch": cfg.name, "card": card_line, "fault_spec": CHAOS_SPEC,
           "kv_every": OBSERVE_KV_EVERY, "requests": len(fin),
           "step_retries": m["step_retries"],
           "quarantined": m["quarantined"], "steps": steps,
           "new_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "chaos_tokens_per_s": cha_res["tokens_per_s"],
           "trace_records": m["trace_records"],
           "trace_dropped": m["trace_dropped"],
           "phase_attribution": pa, "kv_samples": kv,
           "bundles": bundles, "triggers": triggers,
           "trace_report": trace_out.getvalue(),
           "anomalies_fired": m["anomalies_fired"],
           "flight_recorded": m["flight_recorded"],
           "registry_kv": {k: v for k, v in m["registry"].items()
                           if k.startswith("kv_")},
           "flight_on_off": [{k: v for k, v in f.items() if k != "outputs"}
                             for f in flight],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "matmul_variants": mv,
           "prefill_variants": pv, "decode_variants": dv,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes}
    flight_tps = " / ".join(f"{f['tokens_per_s']:.1f}" for f in flight)
    per = "; ".join(f"{n} {d['total_s']:.3f} s ({d['count']}, dispatch "
                    f"{d['dispatch_s']:.3f}, wait {d['device_wait_s']:.3f})"
                    for n, d in pa["phases"].items())
    log(f"{phase}: the chaos run traced, KV sampled every "
        f"{OBSERVE_KV_EVERY} steps, detectors armed: {n_tok} new tokens in "
        f"{wall:.3f} s = {res['tokens_per_s']:.1f} tok/s (chaos phase "
        f"{cha_res['tokens_per_s']:.1f}); {steps} steps, "
        f"{m['trace_records']} trace records, 0 dropped, valid; phase "
        f"coverage {pa['coverage']:.3f} of {pa['step_total_s']:.3f} s of "
        f"step wall, dispatch {pa['dispatch_frac']:.3f} / device wait "
        f"{pa['device_wait_frac']:.3f} / other host "
        f"{pa['other_host_s'] / pa['attributed_s']:.3f} of attributed "
        f"time; by phase: {per}; {len(kv)} KV samples, clip fraction K "
        f"{min(clips['k']):.4f}-{max(clips['k']):.4f}, V "
        f"{min(clips['v']):.4f}-{max(clips['v']):.4f}; "
        f"{m['anomalies_fired']} firings, bundles {bundles} (each loads, "
        f"incident_report --validate 0); trace_report --validate 0 on the "
        f"trace; flight recorder on / off / off / "
        f"on: {flight_tps} tok/s, tokens equal; launches {launches} "
        f"[card: {card_line}]")
    return res


def recovery_phase(torch, counters, params, scales, sta_res, card_line):
    """The static phase's run (static int8 scales, 16 requests of 32
    tokens) with a request journal and a snapshot every
    ``SNAPSHOT_EVERY`` steps in a temporary directory, crashed at a step
    boundary by a seeded ``InjectedCrash`` (``CRASH_SPEC``); the crashed
    engine is freed, and a new one (``journal_resume=True``) recovers
    from snapshot + journal and drains. Gates: the crash came after a
    snapshot with slots occupied; a manifest and at least one restored
    request; the journal's pre-crash retires and the new engine's
    finishes partition the 16 uids; every token equal to the static
    phase's; the merged journal valid, with snapshot and restore events;
    the registry's restore and replay counts; no slot occupied after the
    drain; the static modes only, one write a layer and pass over both
    engines."""
    import dataclasses
    import gc
    import os
    import shutil
    import tempfile
    from repro_torch.engine import (Engine, FaultSpec, InjectedCrash,
                                    occupied_slots)
    from repro_torch.engine.recovery import load_journal
    from repro_torch.launch.serve import smoke_workload
    from repro_torch.obs.schema import validate_events
    cfg, ecfg, _, warmup, prompts = smoke_workload()
    phase = "recovery"
    warm_up(cfg, params, ecfg, warmup, kv_scales=scales)
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        if free < 4 << 30:
            fail(f"{phase}: {free / 2**30:.1f} GiB free under {tmp}; the "
                 f"snapshots need ~1 GiB each")
        jpath = os.path.join(tmp, "journal.jsonl")
        spath = os.path.join(tmp, "snap")
        crash_cfg = dataclasses.replace(
            ecfg, journal_path=jpath, snapshot_path=spath,
            snapshot_every=SNAPSHOT_EVERY,
            fault_spec=FaultSpec(**CRASH_SPEC))
        eng = Engine(cfg, params, crash_cfg, device="cuda", kv_scales=scales)
        snap_s = []
        take = eng.snapshot

        def timed_snapshot(path=None):
            t = time.perf_counter()
            out = take(path)
            snap_s.append(time.perf_counter() - t)
            return out

        eng.snapshot = timed_snapshot
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p)
        crashed = False
        try:
            eng.drain()
        except InjectedCrash:
            crashed = True
        t_crash = time.perf_counter()
        if not crashed:
            fail(f"{phase}: {CRASH_SPEC} did not crash the run")
        crash_step = len(eng.step_s)
        occupied = sum(r is not None for r in eng.sched.slots)
        if not snap_s or not occupied:
            fail(f"{phase}: crash at step {crash_step} after "
                 f"{len(snap_s)} snapshots with {occupied} slots occupied")
        passes = eng.n_decode_steps + eng.n_prefill_chunks
        pre = {"decode_steps": eng.n_decode_steps,
               "prefill_chunks": eng.n_prefill_chunks}
        registry = eng.registry
        snap_bytes = sum(os.path.getsize(os.path.join(spath, f))
                         for f in os.listdir(spath))
        del eng, take, timed_snapshot
        gc.collect()
        torch.cuda.empty_cache()
        mem_freed = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        eng = Engine(cfg, params, dataclasses.replace(
            ecfg, journal_path=jpath, journal_resume=True,
            snapshot_path=spath), device="cuda", kv_scales=scales,
            registry=registry)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        info = eng.recover()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        fin = eng.drain()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        launches = launch_counts(counters)
        records = load_journal(jpath)
    if info["manifest"] is None or info["n_restored"] <= 0:
        fail(f"{phase}: manifest {info['manifest'] is not None}, "
             f"{info['n_restored']} requests restored")
    done = {u: rec["out"] for u, rec in info["retired"].items()}
    twice = [r.uid for r in fin if r.uid in done]
    done.update({r.uid: r.out for r in fin})
    if twice or sorted(done) != list(range(len(prompts))):
        fail(f"{phase}: uids retired twice {twice}; retired "
             f"{sorted(done)}")
    want = sta_res["outputs"]
    bad = [u for u, out in done.items() if out != want[u]]
    if bad:
        fail(f"{phase}: tokens of uids {bad} differ from the static "
             f"phase's")
    errs = validate_events(records)
    names = {r.get("name") for r in records if r.get("kind") == "event"}
    if errs or not {"snapshot", "restore"} <= names:
        fail(f"{phase}: merged journal errors {errs[:5]}, events {names}")
    snap = eng.registry.snapshot()
    if snap["engine_restore"] != 1 or \
            snap["engine_journal_replayed_requests"] != \
            info["n_restored"] + info["n_requeued"]:
        fail(f"{phase}: registry restores {snap['engine_restore']}, "
             f"replayed {snap['engine_journal_replayed_requests']}")
    if occupied_slots(eng.cache) or not eng.sched.idle:
        fail(f"{phase}: slots {occupied_slots(eng.cache)} still occupied")
    mv, pv, dv, modes, writes = reliability_gates(
        torch, counters, phase, cfg, launches, "static",
        passes + eng.n_decode_steps + eng.n_prefill_chunks)
    n_tok = sum(len(r.out) for r in fin)
    res = {"arch": cfg.name, "card": card_line, "crash_spec": CRASH_SPEC,
           "snapshot_every": SNAPSHOT_EVERY, "crash_step": crash_step,
           "snapshots_before_crash": len(snap_s),
           "slots_occupied_at_crash": occupied,
           "snapshot_bytes": snap_bytes, "snapshot_write_s": snap_s,
           "snapshot_step": info["manifest"]["step"],
           "n_restored": info["n_restored"],
           "n_requeued": info["n_requeued"],
           "n_retired_before_crash": len(info["retired"]),
           "run_to_crash_s": t_crash - t0,
           "memory_after_free_bytes": mem_freed,
           "engine_build_s": t2 - t1, "restore_s": t3 - t2,
           "recovery_s": t3 - t1, "drain_after_recovery_s": t4 - t3,
           "restore_histogram": snap["engine_restore_duration_s"],
           "finished_after_recovery": len(fin), "new_tokens_after": n_tok,
           "tokens_per_s_after": n_tok / (t4 - t3),
           "pre_crash": pre, "decode_steps_after": eng.n_decode_steps,
           "prefill_chunks_after": eng.n_prefill_chunks,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "journal_records": len(records), "launches": launches,
           "matmul_variants": mv, "prefill_variants": pv,
           "decode_variants": dv,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes}
    log(f"{phase}: the static phase's 16 requests with a journal and a "
        f"snapshot every {SNAPSHOT_EVERY} steps, crashed ({CRASH_SPEC}) at "
        f"step {crash_step} with {occupied} slots occupied after "
        f"{len(snap_s)} snapshots of {snap_bytes} B (written in "
        f"{', '.join(f'{x:.3f}' for x in snap_s)} s); recovery in a new "
        f"engine: build {t2 - t1:.3f} s, restore + replay {t3 - t2:.3f} s "
        f"(snapshot of step {info['manifest']['step']}: {info['n_restored']}"
        f" restored, {info['n_requeued']} re-enqueued, "
        f"{len(info['retired'])} retired before the crash), then "
        f"{len(fin)} requests drained in {t4 - t3:.3f} s ({n_tok} tokens); "
        f"every token equal to the static phase's; merged journal "
        f"{len(records)} records, valid; launches {launches}; K/V writes by "
        f"mode {writes} [card: {card_line}]")
    return res


def calibrate(torch, cfg, params, device, S=256):
    """Static KV scales of ``cfg`` from the port's ``collect_kv_stats``
    over 4 seeded prompts of ``S`` tokens, on ``device``."""
    import numpy as np
    from repro_torch.calib import collect_kv_stats, kv_static_scales
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, size=(4, S))
    t0 = time.perf_counter()
    scales = kv_static_scales(collect_kv_stats(cfg, params, [toks]))
    if device == "cuda":
        torch.cuda.synchronize()
    return scales, time.perf_counter() - t0


def top2_margin(torch, cfg, params, scales, tokens) -> float:
    """The target's top-2 logit margin after ``tokens``, on a fresh
    one-slot static cache (96-token chunks)."""
    from repro_torch.engine.kvcache import init_slot_cache
    from repro_torch.models import transformer
    cache = init_slot_cache(cfg, 1, len(tokens) + 1, mode="int8",
                            kv_scales=scales, device="cuda")
    t = torch.as_tensor(tokens, device="cuda")[None]
    for done in range(0, len(tokens), 96):
        n = min(96, len(tokens) - done)
        logits = transformer.prefill_chunk_slots(
            params, cfg, cache, t[:, done:done + n], 0, done, n)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def spec_phase(torch, counters, params, scales, static_res):
    """Self-speculative decoding at full width: the INT4 target over the
    static scales, an INT2 SplitQuant k=3 draft of the same seeded
    weights (dequantized once to bf16), spec_k = 3, 8 slots, max_len 1024,
    the first 8 requests of the smoke workload."""
    import dataclasses
    from repro_torch.launch.serve import build_params, smoke_workload
    cfg, ecfg, quant, warmup, prompts = smoke_workload()
    prompts = prompts[:8]
    ecfg = dataclasses.replace(ecfg, spec_k=3)
    t0 = time.perf_counter()
    draft, _ = build_params(cfg, device="cuda", **dict(quant, bits=2))
    torch.cuda.synchronize()
    t_draft = time.perf_counter() - t0
    eng, fin, wall, launches = serve_run(
        torch, counters, "spec", cfg, params, ecfg, warmup, prompts,
        kv_scales=scales, draft_params=draft)
    del draft
    modes = only_modes(counters, "spec", {"dynamic"},
                       {"static", "verify_static", "dynamic"})
    # the target's cache is static, the draft's twin dynamic; the draft
    # mirrors every prefill chunk
    writes = one_write_per_layer("spec", cfg.n_layers, {
        "static": eng.n_prefill_chunks + eng.n_verify_calls +
        eng.n_decode_steps,
        "dynamic": eng.n_prefill_chunks + eng._spec.n_draft_steps})
    if eng.n_rollbacks < 1:
        fail("spec: no rollback in the run")
    n_tok = sum(len(r.out) for r in fin)
    greedy = static_res["outputs"][:8]
    same = sum(a == b for r, g in zip(fin, greedy)
               for a, b in zip(r.out, g))
    res = {"arch": cfg.name, "spec_k": ecfg.spec_k, "requests": len(fin),
           "new_tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "draft_quantize_s": t_draft,
           "acceptance_rate": eng.sched.acceptance_rate(),
           "draft_proposed": eng.sched.spec_proposed,
           "draft_accepted": eng.sched.spec_accepted,
           "spec_steps": eng.n_spec_steps,
           "verify_calls": eng.n_verify_calls,
           "rollbacks": eng.n_rollbacks,
           "draft_steps": eng._spec.n_draft_steps,
           "tokens_per_spec_step": eng.n_spec_commit_tokens / eng.n_spec_steps,
           "tokens_per_verify": eng.n_spec_commit_tokens / eng.n_verify_calls,
           "spec_step_p50_s": percentile(eng.spec_step_s, 50),
           "ttft_p50_s": percentile([r.ttft for r in fin], 50),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes,
           "identical_to_static_greedy_share": same / n_tok}
    diff = next(((i, j) for i, (r, g) in enumerate(zip(fin, greedy))
                 for j, (a, b) in enumerate(zip(r.out, g)) if a != b), None)
    if diff is not None:
        i, j = diff
        res["first_difference"] = {"request": i, "position": j}
        res["top2_margin_there"] = top2_margin(
            torch, cfg, params, scales,
            list(prompts[i]) + list(fin[i].out[:j]))
    log(f"spec: spec_k {ecfg.spec_k}, INT2 draft (quantized in {t_draft:.1f} "
        f"s, dequantized to bf16), static target scales; {len(fin)} requests,"
        f" {n_tok} new tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} "
        f"tok/s; acceptance {res['acceptance_rate']:.3f} "
        f"({res['draft_accepted']}/{res['draft_proposed']}); "
        f"{res['tokens_per_spec_step']:.2f} tokens committed per spec step "
        f"({res['tokens_per_verify']:.2f} per verify) over "
        f"{eng.n_spec_steps} spec steps ({eng.n_verify_calls} verify calls, "
        f"{eng.n_rollbacks} rollbacks, {res['draft_steps']} draft decode "
        f"steps); spec step p50 {res['spec_step_p50_s'] * 1e3:.1f} ms; peak "
        f"memory {res['peak_mem_bytes'] / 2**30:.2f} GiB; prefill attention by"
        f" mode {modes['prefill_attention']}, decode attention by mode "
        f"{modes['decode_attention']}, K/V writes by mode {writes}; "
        f"{100 * same / n_tok:.1f}% of tokens "
        f"identical to the static engine's greedy output"
        + ("" if diff is None else
           f" (first difference: request {diff[0]}, token {diff[1]}; the "
           f"target's top-2 logit margin there {res['top2_margin_there']:.4f})"))
    return res


def cross_check(torch):
    from repro_torch.configs import get_arch
    from repro_torch.tree import tree_to
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


def spec_cross_check(torch):
    """stablelm-1.6b reduced in fp32, INT4 target and INT2 draft,
    spec_k = 3, over int8 dynamic and static caches: the card's
    speculative tokens equal the card's greedy tokens and the CPU's
    speculative tokens; and on each device an engine whose draft is
    minted from ``draft_recipe`` (the INT2 draft's checkpoint and a
    recipe, saved in a temporary directory) gives the same tokens and
    the same proposed and accepted counts as the draft passed as
    ``draft_params=``."""
    import os
    import tempfile
    from repro_torch.calib import QuantRecipe
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_arch
    from repro_torch.tree import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg = get_arch("stablelm-1.6b").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", seed=0,
                             device="cpu")
    draft, _ = build_params(cfg, bits=2, method="splitquant", seed=0,
                            device="cpu")
    scales, _ = calibrate(torch, cfg, params, "cpu", S=64)
    prompts = seeded_prompts(cfg.vocab, 8, 16, 200, seed=2)
    res = {}
    with tempfile.TemporaryDirectory() as rdir:
        ckpt.save(os.path.join(rdir, "ckpt"), 0, draft)
        QuantRecipe(name=f"{cfg.name}-int2-draft", arch=cfg.name,
                    ckpt_dir="ckpt").save(rdir)
        for mode, kv_scales in (("dynamic", None), ("static", scales)):
            outs, counts = {}, {}
            for dev, spec_k, how in (("cpu", 3, "params"),
                                     ("cuda", 3, "params"), ("cuda", 0, ""),
                                     ("cpu", 3, "recipe"),
                                     ("cuda", 3, "recipe")):
                p, d = (params, draft) if dev == "cpu" else \
                    (tree_to(params, "cuda"), tree_to(draft, "cuda"))
                eng = Engine(cfg, p, EngineConfig(
                    n_slots=4, max_len=256, max_new_tokens=16,
                    kv_mode="int8", prefill_chunk=96, spec_k=spec_k,
                    draft_recipe=rdir if how == "recipe" else None),
                    device=dev, kv_scales=kv_scales,
                    draft_params=d if how == "params" else None)
                for pr in prompts:
                    eng.submit(pr)
                outs[(dev, spec_k, how)] = [r.out for r in eng.drain()]
                counts[(dev, how)] = (eng.sched.spec_proposed,
                                      eng.sched.spec_accepted)
            same = outs[("cuda", 3, "params")] == outs[("cuda", 0, "")] == \
                outs[("cpu", 3, "params")]
            log(f"spec cross-check: stablelm-1.6b reduced fp32, int8 {mode} "
                f"KV, spec_k 3 with an INT2 draft, 8 requests x 16 tokens: "
                f"card spec tokens {'==' if same else '!='} card greedy "
                f"tokens == CPU spec tokens")
            if not same:
                fail(f"spec cross-check ({mode}): card spec "
                     f"{outs[('cuda', 3, 'params')]}, card greedy "
                     f"{outs[('cuda', 0, '')]}, cpu spec "
                     f"{outs[('cpu', 3, 'params')]}")
            for dev in ("cpu", "cuda"):
                ok = outs[(dev, 3, "recipe")] == outs[(dev, 3, "params")] \
                    and counts[(dev, "recipe")] == counts[(dev, "params")]
                log(f"spec cross-check ({mode}, {dev}): the draft from "
                    f"draft_recipe {'==' if ok else '!='} the draft as "
                    f"draft_params (tokens; proposed, accepted "
                    f"{counts[(dev, 'recipe')]} vs {counts[(dev, 'params')]})")
                if not ok:
                    fail(f"spec cross-check ({mode}, {dev}): draft_recipe "
                         f"gave {outs[(dev, 3, 'recipe')]} "
                         f"{counts[(dev, 'recipe')]}, draft_params "
                         f"{outs[(dev, 3, 'params')]} "
                         f"{counts[(dev, 'params')]}")
            res[mode] = {"requests": len(prompts), "identical": same,
                         "draft_recipe_identical": True,
                         "proposed_accepted": {
                             f"{dev}_{how}": list(c)
                             for (dev, how), c in counts.items()}}
    return res


# ------------------------------------------- wave loop: rwkv6, griffin ---
def _wave_kernels(counters, phase: str, launches: dict) -> None:
    """Every kernel of the wave path (``PATHS``) launched in the run."""
    for name in (n for n, p in PATHS.items() if "wave" in p):
        if launches[name] <= 0:
            fail(f"{phase}: kernel {name} was not launched on the wave path")


def _only_matmul(counters, phase: str, launches: dict) -> None:
    """A griffin or whisper run launches the matmul and no other kernel
    (no attention kernel, K/V write, quantizer or WKV)."""
    from repro_torch.kernels import prefill_attention as pa
    if launches["splitquant_matmul"] <= 0:
        fail(f"{phase}: splitquant_matmul was not launched on its path")
    others = {n: c for n, c in launches.items() if n != "splitquant_matmul"}
    if any(others.values()) or pa.quantize_kv.launches or \
            pa.quantize_kv_static.launches:
        fail(f"{phase}: kernels off the path were launched: {others}")


def _all_finite(torch, tensors) -> bool:
    return all(bool(torch.isfinite(t.float()).all()) for t in tensors)


def _rwkv_shape(cfg) -> str:
    return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.d_model // cfg.rwkv_head_dim} heads of "
            f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}")


def _griffin_shape(cfg) -> str:
    from repro_torch.models import griffin
    groups, tail = griffin.layout(cfg)
    return (f"{cfg.n_layers} layers = {groups} x (rec, rec, attn) + {tail} "
            f"rec, d_model {cfg.d_model}, {cfg.n_heads} heads / "
            f"{cfg.n_kv_heads} kv-head of {cfg.head_dim}, window "
            f"{cfg.window}, lru {cfg.lru_width}, {cfg.ffn_type} d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}")


def wave_phase(torch, counters, phase: str, workload, model, shape, gate,
               card_line):
    """A wave-loop family at full width through the wave ``Server``:
    ``workload()`` gives (cfg, scfg, quant, warm-up prompts, prompts)
    (``rwkv_smoke_workload``: rwkv6-3b; ``griffin_smoke_workload``:
    recurrentgemma-9b uncut, 38 layers, 12 groups of (rec, rec, attn) and
    2 trailing recurrent layers); SplitQuant INT4 k=3 built on the card
    (griffin part by part); waves of 8, 16 seeded requests, 32 new tokens
    each, after one warm-up wave. ``model`` is the family's module,
    ``shape(cfg)`` describes it for the log. The counts are set to 0
    just before the run and read just after. Gates: every request its
    budget in vocab; ``gate(counters, phase, launches)`` (every wave
    kernel launched for rwkv6, the matmul alone for griffin); no plain
    version called; an untimed prefill's logits and state finite at full
    width. Printed: build seconds, the build's peak and the weights'
    bytes on the card (both above what was resident before), deployed
    bytes, tokens/s, wave-prefill and decode-step p50, peak memory,
    launches by variant. Returns (result, params)."""
    from repro_torch.launch.serve import build_params
    from repro_torch.runtime.serve_loop import Request, Server, ServeConfig
    cfg, scfg, quant, warmup, prompts = workload()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, report = build_params(cfg, device="cuda", **quant)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    # above what was resident before the build
    build_peak = torch.cuda.max_memory_allocated() - resident
    weight_bytes = torch.cuda.memory_allocated() - resident
    log(f"{phase}: {cfg.name} full width ({shape(cfg)}): init + SplitQuant "
        f"INT4 k=3 of {len(report['quantized'])} leaves on the card in "
        f"{t_build:.2f} s, build peak {build_peak / 2**30:.2f} GiB; deployed "
        f"{report['deployed_bytes'] / 1e9:.3f} GB (the JAX count), "
        f"{weight_bytes / 2**30:.2f} GiB on the card [card: {card_line}]")
    Server(cfg, params, ServeConfig(max_batch=8, max_new_tokens=2),
           device="cuda").serve([Request(i, p)
                                 for i, p in enumerate(warmup)])
    srv = Server(cfg, params, scfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    with plain_calls() as plain:
        t0 = time.perf_counter()
        fin = srv.serve([Request(i, p) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    no_plain(phase, plain)
    launches = launch_counts(counters)
    variants = only_variant(counters, "splitquant_matmul", phase)
    gate(counters, phase, launches)
    peak = torch.cuda.max_memory_allocated()
    if len(fin) != len(prompts) or \
            any(len(r.out) != scfg.max_new_tokens for r in fin) or \
            any(not 0 <= t < cfg.vocab for r in fin for t in r.out):
        fail(f"{phase}: expected {len(prompts)} requests x "
             f"{scfg.max_new_tokens} tokens in vocab, got "
             f"{[len(r.out) for r in fin]}")
    logits, state = model.prefill(
        params, cfg, {"tokens": torch.as_tensor(prompts[0][None],
                                                device="cuda")})
    if logits.shape != (1, len(prompts[0]), cfg.vocab) or \
            not _all_finite(torch, (logits, *state)):
        fail(f"{phase}: non-finite or misshapen logits or state at full "
             f"width")
    del logits, state
    n_tok = sum(len(r.out) for r in fin)
    res = {"arch": cfg.name, "card": card_line, "build_s": t_build,
           "build_peak_bytes": build_peak, "weight_bytes": weight_bytes,
           "deployed_bytes": report["deployed_bytes"],
           "quantized_leaves": len(report["quantized"]),
           "requests": len(fin), "new_tokens": n_tok,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "waves": len(srv.wave_prefill_s), "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "wave_prefill_p50_s": percentile(srv.wave_prefill_s, 50),
           "wave_prefill_s": srv.wave_prefill_s,
           "decode_step_p50_s": percentile(srv.decode_step_s, 50),
           "decode_steps": len(srv.decode_step_s), "peak_mem_bytes": peak,
           "launches": launches, "matmul_variants": variants,
           "plain_calls": plain, "outputs": [r.out for r in fin]}
    log(f"{phase}: {len(fin)} requests in {res['waves']} waves, "
        f"{res['prompt_tokens']} prompt + {n_tok} new tokens in {wall:.3f} s "
        f"= {res['tokens_per_s']:.1f} tok/s; wave prefill p50 "
        f"{res['wave_prefill_p50_s'] * 1e3:.1f} ms; decode step p50 "
        f"{res['decode_step_p50_s'] * 1e3:.2f} ms; {res['decode_steps']} "
        f"decode steps; peak memory {peak / 2**30:.2f} GiB; launches "
        f"{launches}; matmul by variant {variants} [card: {card_line}]")
    return res, params


def wave_cross_check(torch, name: str, cfg, lens, seed: int):
    """``cfg`` (a reduced config) in fp32 with INT4 SplitQuant weights
    through the wave ``Server`` on the card and on the CPU with the same
    weights: seeded prompts of ``lens`` tokens in waves of 4, 16 new
    tokens each: identical greedy tokens."""
    import numpy as np
    from repro_torch.launch.serve import build_params
    from repro_torch.runtime.serve_loop import Request, Server, ServeConfig
    from repro_torch.tree import tree_to
    params, _ = build_params(cfg, bits=4, method="splitquant", seed=0,
                             device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in lens]
    B, new = 4, 16
    outs = {}
    for dev, p in (("cpu", params), ("cuda", tree_to(params, "cuda"))):
        srv = Server(cfg, p, ServeConfig(max_batch=B, max_new_tokens=new),
                     device=dev)
        outs[dev] = [r.out for r in srv.serve(
            [Request(i, pr) for i, pr in enumerate(prompts)])]
    same = outs["cpu"] == outs["cuda"]
    pads = [max(lens[i:i + B]) for i in range(0, len(lens), B)]
    log(f"{name} cross-check: {cfg.name} reduced ({cfg.n_layers} layers), "
        f"fp32, waves of {B} padded to {pads}, {len(prompts)} requests x "
        f"{new} tokens: card tokens {'==' if same else '!='} CPU tokens")
    if not same:
        fail(f"{name} cross-check: card {outs['cuda']} != cpu {outs['cpu']}")
    return {"requests": len(prompts), "identical": same}


def rwkv_cross_check(torch):
    """rwkv6-3b reduced: waves padded to 32 (the WKV kernel's chunk) and
    37 (the steps)."""
    from repro_torch.configs import get_arch
    return wave_cross_check(torch, "rwkv6", get_arch("rwkv6-3b").reduced(),
                            (32, 20, 7, 16, 37, 5, 12, 30), seed=1)


def griffin_cross_check(torch):
    """recurrentgemma-9b reduced at 8 layers (2 groups and 2 trailing
    recurrent layers), window 16: waves padded to 30 and 21, past the
    window, and 16 new tokens, so the ring wraps."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("recurrentgemma-9b").reduced(),
                              n_layers=8)
    return wave_cross_check(torch, "griffin", cfg,
                            (30, 7, 18, 3, 21, 12, 17, 5), seed=3)


# ------------------------------------------------ griffin and whisper ---
def griffin_ring_phase(torch, counters, params, card_line):
    """griffin's weights past the window (``griffin_ring_workload``): one
    wave of 4 seeded prompts of 2100-2400 tokens through the wave
    ``Server``, 32 new tokens each. The prefill assembles the 2048-row
    ring from the last 2048 positions and the decode steps write into
    it. Gates: every request its 32 tokens; after the run each attention
    layer's ring holds exactly the last 2048 positions written, position
    p in row p % 2048; the recurrent states finite; the matmul alone, its
    bf16 variant; no plain version called. Printed: the prefill's wall
    and the decode-step p50."""
    from repro_torch.launch.serve import griffin_ring_workload
    from repro_torch.models import griffin
    from repro_torch.runtime.serve_loop import Request, Server
    cfg, scfg, prompts = griffin_ring_workload()
    phase = "griffin_ring"
    srv = Server(cfg, params, scfg, device="cuda")
    seen = {}
    for name in ("prefill_wave", "decode_wave"):
        def keep(*a, _fn=getattr(srv, name), **kw):
            out = _fn(*a, **kw)
            seen["cache"] = out[0]
            return out
        setattr(srv, name, keep)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    with plain_calls() as plain:
        t0 = time.perf_counter()
        fin = srv.serve([Request(i, p) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    no_plain(phase, plain)
    launches = launch_counts(counters)
    variants = only_variant(counters, "splitquant_matmul", phase)
    _only_matmul(counters, phase, launches)
    if any(len(r.out) != scfg.max_new_tokens for r in fin) or \
            any(not 0 <= t < cfg.vocab for r in fin for t in r.out):
        fail(f"{phase}: expected {len(prompts)} requests x "
             f"{scfg.max_new_tokens} tokens, got {[len(r.out) for r in fin]}")
    cache, W = seen["cache"], cfg.window
    S = max(len(p) for p in prompts)
    last = S + len(srv.decode_step_s)          # one past the last written
    pos = cache.attn_pos.cpu()
    want = torch.arange(last - W, last, dtype=torch.int32)
    want = want[torch.argsort(want % W)]
    if pos.shape != (griffin.layout(cfg)[0], W) or \
            not bool((pos == want[None]).all()) or \
            not _all_finite(torch, (cache.rec_h, cache.rec_conv)):
        fail(f"{phase}: the ring holds positions {pos[0, :4].tolist()}..., "
             f"expected the last {W} before {last} in ring order, or the "
             f"recurrent state is not finite")
    n_tok = sum(len(r.out) for r in fin)
    res = {"arch": cfg.name, "card": card_line, "requests": len(fin),
           "prompt_tokens": [len(p) for p in prompts], "padded_to": S,
           "window": W, "new_tokens": n_tok, "wall_s": wall,
           "prefill_s": srv.wave_prefill_s[0],
           "decode_step_p50_s": percentile(srv.decode_step_s, 50),
           "decode_steps": len(srv.decode_step_s),
           "ring_positions": [int(want.min()), int(want.max())],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "matmul_variants": variants,
           "plain_calls": plain, "outputs": [r.out for r in fin]}
    log(f"{phase}: {cfg.name} full width, one wave of {len(prompts)} "
        f"prompts of {res['prompt_tokens']} tokens (padded to {S}, past the "
        f"{W}-row window): prefill {res['prefill_s'] * 1e3:.1f} ms, decode "
        f"step p50 {res['decode_step_p50_s'] * 1e3:.2f} ms over "
        f"{res['decode_steps']} steps; the ring holds positions "
        f"{res['ring_positions'][0]}..{res['ring_positions'][1]} in ring "
        f"order; {n_tok} tokens in {wall:.3f} s; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; launches {launches} "
        f"[card: {card_line}]")
    return res


def whisper_phase(torch, counters, card_line):
    """whisper-tiny at full width (``whisper_smoke_workload``: 4 + 4
    layers, d_model 384, 6 heads of 64, enc_seq 1500, vocab 51865, the
    head tied; SplitQuant INT4 k=3 of its matrices and biases on the
    card): two batches of 8, seeded stub frames (8, 1500, 384) and prompts
    of 16, then 48 tokens, decoded greedily for 32 tokens by
    ``whisper.prefill`` and ``whisper.decode_step``. The counts are set
    to 0 just before and read just after. Gates: 8 x 32 tokens in vocab a
    batch; logits and the cache finite; the matmul launched, only
    ``bf16_wgmma``, no other kernel; no plain version called. Printed:
    the encoder's ms (timed alone, after the counted run), prefill and
    decode-step p50, tokens/s."""
    from repro_torch.launch.serve import build_params, whisper_smoke_workload
    from repro_torch.models import whisper
    cfg, quant, batches, new = whisper_smoke_workload()
    phase = "whisper"
    t0 = time.perf_counter()
    params, report = build_params(cfg, device="cuda", **quant)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_bias = sum(p.endswith(("/bq", "/bk", "/bv", "/bo", "/b_up",
                             "/b_down")) for p in report["per_path"])
    log(f"{phase}: {cfg.name} full width ({cfg.n_enc_layers} + "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"of {cfg.head_dim}, enc_seq {cfg.enc_seq}, vocab {cfg.vocab}, tied "
        f"head): SplitQuant INT4 k=3 of {len(report['quantized'])} leaves "
        f"({n_bias} bias groups) on the card in {t_build:.2f} s; deployed "
        f"{report['deployed_bytes'] / 2**20:.1f} MiB [card: {card_line}]")

    def frames_on_card(frames):
        return torch.as_tensor(frames, device="cuda").to(torch.bfloat16)

    def run(frames, toks):
        """(tokens (8, new), prefill s, decode step seconds, finite)."""
        f = frames_on_card(frames)
        t = torch.as_tensor(toks, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = whisper.prefill(params, cfg, {"tokens": t,
                                                      "frames": f},
                                        max_len=t.shape[1] + new)
        tok = logits[:, -1].argmax(-1)
        out = [tok.tolist()]
        t_pre = time.perf_counter() - t0
        steps, finite = [], bool(torch.isfinite(logits).all())
        for i in range(new - 1):
            t0 = time.perf_counter()
            logits, cache = whisper.decode_step(params, cfg, cache,
                                                tok[:, None],
                                                t.shape[1] + i)
            tok = logits[:, -1].argmax(-1)
            out.append(tok.tolist())
            steps.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(logits).all()) and \
            _all_finite(torch, cache)
        return [list(r) for r in zip(*out)], t_pre, steps, finite

    run(*batches[0])                                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    outs, pres, steps = [], [], []
    with plain_calls() as plain:
        t0 = time.perf_counter()
        for frames, toks in batches:
            o, tp, st, finite = run(frames, toks)
            if not finite:
                fail(f"{phase}: non-finite logits or cache")
            outs.append(o)
            pres.append(tp)
            steps += st
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    no_plain(phase, plain)
    launches = launch_counts(counters)
    variants = only_variant(counters, "splitquant_matmul", phase)
    _only_matmul(counters, phase, launches)
    # the encoder alone, after the run whose wall and counts are kept (its
    # pass inside each prefill is the one the run needs)
    encs = []
    for frames, _ in batches:
        f = frames_on_card(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whisper.encode(params, cfg, f)
        torch.cuda.synchronize()
        encs.append(time.perf_counter() - t0)
    if any(len(o) != 8 or any(len(r) != new or
                              any(not 0 <= x < cfg.vocab for x in r)
                              for r in o) for o in outs):
        fail(f"{phase}: expected 2 batches of 8 x {new} tokens in vocab")
    n_tok = 2 * 8 * new
    res = {"arch": cfg.name, "card": card_line, "build_s": t_build,
           "deployed_bytes": report["deployed_bytes"],
           "quantized_leaves": len(report["quantized"]),
           "prompt_lens": [int(t.shape[1]) for _, t in batches],
           "new_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "encoder_s": encs,
           "prefill_s": pres, "prefill_p50_s": percentile(pres, 50),
           "decode_step_p50_s": percentile(steps, 50),
           "decode_steps": len(steps),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "matmul_variants": variants,
           "plain_calls": plain, "outputs": outs}
    log(f"{phase}: 2 batches of 8 (stub frames 8 x {cfg.enc_seq} x "
        f"{cfg.d_model}, prompts of {res['prompt_lens']} tokens), {n_tok} "
        f"greedy tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} tok/s "
        f"(each prefill runs the encoder); encoder, timed alone after the "
        f"run, "
        f"{[round(s * 1e3, 2) for s in encs]} ms; prefill "
        f"{[round(s * 1e3, 2) for s in pres]} ms (p50 "
        f"{res['prefill_p50_s'] * 1e3:.2f}); decode step p50 "
        f"{res['decode_step_p50_s'] * 1e3:.2f} ms; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; launches {launches}; "
        f"matmul by variant {variants} [card: {card_line}]")
    return res


def whisper_cross_check(torch):
    """whisper-tiny ``.reduced()`` in fp32 with INT4 SplitQuant weights and
    biases: ``prefill`` of 4 prompts of 9 tokens over seeded frames, then
    12 greedy ``decode_step``s, on the card and on the CPU with the same
    weights: identical tokens."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_params
    from repro_torch.models import whisper
    from repro_torch.tree import tree_to
    cfg = get_arch("whisper-tiny").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", seed=0,
                             device="cpu")
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((4, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab, (4, 9))
    outs = {}
    for dev, p in (("cpu", params), ("cuda", tree_to(params, "cuda"))):
        t = torch.as_tensor(toks, device=dev)
        logits, cache = whisper.prefill(
            p, cfg, {"tokens": t, "frames": torch.as_tensor(frames,
                                                            device=dev)},
            max_len=9 + 13)
        tok = logits[:, -1].argmax(-1)
        out = [tok.tolist()]
        for i in range(12):
            logits, cache = whisper.decode_step(p, cfg, cache, tok[:, None],
                                                9 + i)
            tok = logits[:, -1].argmax(-1)
            out.append(tok.tolist())
        outs[dev] = out
    same = outs["cpu"] == outs["cuda"]
    log(f"whisper cross-check: whisper-tiny reduced fp32, INT4 with biases, "
        f"4 prompts of 9 tokens + 13 greedy tokens: card tokens "
        f"{'==' if same else '!='} CPU tokens")
    if not same:
        fail(f"whisper cross-check: card {outs['cuda']} != cpu {outs['cpu']}")
    return {"requests": 4, "identical": same}


def dense_wave_phase(torch, counters, params, card_line):
    """stablelm-1.6b at full width through the wave ``Server``
    (``launch.serve.dense_wave_workload``): a bf16 ``KVCache`` of 1024 rows
    a wave, attention in plain PyTorch. The counts are set to 0 just
    before the run and read just after: every request its 32 tokens,
    ``splitquant_matmul`` launched and only its bf16 tensor-core variant,
    no other kernel (no attention kernel, no K/V write, no quantizer)."""
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.launch.serve import dense_wave_workload
    from repro_torch.models import transformer
    from repro_torch.runtime.serve_loop import Request, Server, ServeConfig

    cfg, scfg, _, warmup, prompts = dense_wave_workload()
    Server(cfg, params, ServeConfig(max_batch=8, max_new_tokens=2,
                                    max_len=scfg.max_len),
           device="cuda").serve([Request(0, warmup)])
    srv = Server(cfg, params, scfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    fin = srv.serve([Request(i, p) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    variants = only_variant(counters, "splitquant_matmul", "dense_wave")
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(r.out) for r in fin)
    if len(fin) != len(prompts) or \
            any(len(r.out) != scfg.max_new_tokens for r in fin):
        fail(f"dense_wave: expected {len(prompts)} requests x "
             f"{scfg.max_new_tokens} tokens, got {[len(r.out) for r in fin]}")
    if any(not 0 <= t < cfg.vocab for r in fin for t in r.out):
        fail("dense_wave: token id out of vocab")
    if launches["splitquant_matmul"] <= 0:
        fail("dense_wave: splitquant_matmul was not launched on its path")
    others = {n: c for n, c in launches.items() if n != "splitquant_matmul"}
    if any(others.values()) or pa.quantize_kv.launches or \
            pa.quantize_kv_static.launches:
        fail(f"dense_wave: kernels off the path were launched: {others}, "
             f"standalone quantizes {pa.quantize_kv.launches} / "
             f"{pa.quantize_kv_static.launches}")
    # the logits the server samples from are finite at full width
    logits, cache = transformer.prefill(
        params, cfg, {"tokens": torch.as_tensor(prompts[0][None],
                                                device="cuda")},
        max_len=scfg.max_len)
    if logits.shape != (1, len(prompts[0]), cfg.vocab) or \
            not bool(torch.isfinite(logits).all()) or \
            cache.k.dtype != torch.bfloat16:
        fail("dense_wave: non-finite or misshapen logits, or a cache not in "
             "bf16, at full width")
    kv_bytes = 2 * cfg.n_layers * scfg.max_batch * scfg.max_len * \
        cfg.n_kv_heads * cfg.head_dim * 2
    del cache, logits
    res = {"arch": cfg.name, "card": card_line, "requests": len(fin),
           "new_tokens": n_tok,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "waves": len(srv.wave_prefill_s), "wall_s": wall,
           "wave_prefill_p50_s": percentile(srv.wave_prefill_s, 50),
           "wave_prefill_s": srv.wave_prefill_s,
           "decode_step_p50_s": percentile(srv.decode_step_s, 50),
           "decode_steps": len(srv.decode_step_s),
           "tokens_per_s": n_tok / wall, "peak_mem_bytes": peak,
           "kv_cache_bytes": kv_bytes, "launches": launches,
           "matmul_variants": variants}
    log(f"dense_wave: stablelm-1.6b full width through the wave Server, "
        f"waves of {scfg.max_batch}, bf16 KV cache of {scfg.max_len} rows "
        f"({kv_bytes / 2**30:.2f} GiB a wave); {len(fin)} requests in "
        f"{res['waves']} waves, {res['prompt_tokens']} prompt + {n_tok} new "
        f"tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} tok/s; wave "
        f"prefill p50 {res['wave_prefill_p50_s'] * 1e3:.1f} ms; decode step "
        f"p50 {res['decode_step_p50_s'] * 1e3:.2f} ms; "
        f"{res['decode_steps']} decode steps; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}; matmul launches by "
        f"variant {variants} [card: {card_line}]")
    return res


def dense_wave_cross_check(torch):
    """stablelm-1.6b ``.reduced()`` in fp32 (INT4 SplitQuant weights)
    through the wave ``Server`` on the card and on the CPU with the same
    weights, over two left-padded waves of mixed lengths, one request
    with a budget of 1: identical greedy tokens."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.tree import tree_to
    from repro_torch.launch.serve import build_params
    from repro_torch.runtime.serve_loop import Request, Server, ServeConfig
    cfg = get_arch("stablelm-1.6b").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", seed=0,
                             device="cpu")
    rng = np.random.default_rng(5)
    lens = (40, 7, 23, 2, 31, 16, 9, 55)
    budgets = (None, None, 1, None, None, None, None, None)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in lens]
    outs = {}
    for dev, p in (("cpu", params), ("cuda", tree_to(params, "cuda"))):
        srv = Server(cfg, p, ServeConfig(max_batch=4, max_new_tokens=16,
                                         max_len=128), device=dev)
        outs[dev] = [r.out for r in srv.serve(
            [Request(i, pr, b) for i, (pr, b) in
             enumerate(zip(prompts, budgets))])]
    same = outs["cpu"] == outs["cuda"]
    log(f"dense_wave cross-check: stablelm-1.6b reduced fp32, two waves of "
        f"4 left-padded to 40 and 55, 8 requests x 16 tokens (one 1): card "
        f"tokens {'==' if same else '!='} CPU tokens")
    if not same or [len(o) for o in outs["cpu"]] != \
            [16, 16, 1, 16, 16, 16, 16, 16]:
        fail(f"dense_wave cross-check: card {outs['cuda']} != cpu "
             f"{outs['cpu']}")
    return {"requests": len(prompts), "identical": same}


# ----------------------------------------------- the engine's options ---
def cache_dtypes(phase: str, want: str) -> dict:
    """The attention kernels' and the K/V write's launches by cache dtype
    since the last reset: every one over a ``want`` cache."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    out = {"decode_attention": dict(da.decode_attention.dtype_launches),
           "prefill_attention": dict(pa.prefill_attention.dtype_launches),
           "kv_write": dict(pa.write_kv_rows.dtype_launches)}
    for name, d in out.items():
        if any(v for k, v in d.items() if k != want):
            fail(f"{phase}: {name} launched over caches by dtype {d}; "
                 f"expected {want} only")
    return out


def mode_counts() -> dict:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    return {"decode_modes": dict(da.decode_attention.mode_launches),
            "prefill_modes": dict(pa.prefill_attention.mode_launches),
            "write_modes": dict(pa.write_kv_rows.mode_launches)}


def engine_bf16_phase(torch, counters, params, card_line):
    """stablelm-1.6b at full width over an fp slot cache in bf16
    (``launch.serve.bf16_cache_workload``: 8 slots x 1024 rows, 1.6 GB,
    96-token chunks, 16 requests, greedy). Gates: every request its 32
    tokens; every decode-attention, prefill-attention and K/V-write launch
    over the bf16 cache in mode fp; one write a layer and forward pass;
    every matmul launch ``bf16_wgmma``."""
    from repro_torch.launch.serve import bf16_cache_workload
    cfg, ecfg, _, warmup, prompts = bf16_cache_workload()
    phase = "engine_bf16"
    eng, fin, wall, launches = serve_run(torch, counters, phase, cfg, params,
                                         ecfg, warmup, prompts)
    if eng.cache.k.dtype != torch.bfloat16:
        fail(f"{phase}: the cache is {eng.cache.k.dtype}, not bf16")
    variants = only_variant(counters, "splitquant_matmul", phase)
    modes = only_modes(counters, phase, {"fp"}, {"fp"})
    dtypes = cache_dtypes(phase, "bfloat16")
    writes = one_write_per_layer(
        phase, cfg.n_layers, {"fp": eng.n_decode_steps + eng.n_prefill_chunks})
    n_tok = sum(len(r.out) for r in fin)
    res = {"arch": cfg.name, "card": card_line, "kv_cache": "bf16",
           "requests": len(fin), "new_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "ttft_p50_s": percentile([r.ttft for r in fin], 50),
           "decode_step_p50_s": percentile(eng.decode_step_s, 50),
           "prefill_chunk_p50_s": percentile(eng.prefill_chunk_s, 50),
           "decode_steps": eng.n_decode_steps,
           "prefill_chunks": eng.n_prefill_chunks,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "kv_cache_bytes": eng.cache.nbytes(), "launches": launches,
           "matmul_variants": variants,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes, "cache_dtypes": dtypes,
           "outputs": [r.out for r in fin]}
    log(f"{phase}: stablelm-1.6b full width over a bf16 fp cache "
        f"({res['kv_cache_bytes'] / 2**30:.2f} GiB), {len(fin)} requests, "
        f"{n_tok} new tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} "
        f"tok/s; TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms; decode step p50 "
        f"{res['decode_step_p50_s'] * 1e3:.2f} ms; prefill chunk p50 "
        f"{res['prefill_chunk_p50_s'] * 1e3:.2f} ms; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; launches {launches}; by "
        f"cache dtype {dtypes}; K/V writes by mode {writes} (one a layer and "
        f"forward pass) [card: {card_line}]")
    return res


def oneshot_phase(torch, counters, params, card_line):
    """One-shot prefill (``prefill_chunk=0``) at full width over the int8
    dynamic cache, the first 8 requests of the smoke workload. Gates:
    every request its budget; one prefill and one fp materialization a
    request; no prefill-attention launch; one K/V write a layer per
    admission and per decode step, and one decode attention a layer per
    decode step."""
    import dataclasses
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.launch.serve import smoke_workload
    cfg, ecfg, _, warmup, prompts = smoke_workload()
    prompts = prompts[:8]
    ecfg = dataclasses.replace(ecfg, prefill_chunk=0)
    phase = "oneshot"
    eng, fin, wall, launches = serve_run(torch, counters, phase, cfg, params,
                                         ecfg, warmup, prompts)
    L, n = cfg.n_layers, len(prompts)
    if eng.n_prefills != n or eng.materializations_in_run != n or \
            eng.n_prefill_chunks:
        fail(f"{phase}: {eng.n_prefills} one-shot prefills, "
             f"{eng.materializations_in_run} materializations and "
             f"{eng.n_prefill_chunks} chunks for {n} requests")
    if counters["prefill_attention"].launches:
        fail(f"{phase}: prefill attention launched "
             f"{counters['prefill_attention'].launches} times")
    writes = dict(pa.write_kv_rows.mode_launches)
    want = {"fp": 0, "dynamic": L * (n + eng.n_decode_steps), "static": 0}
    dmodes = dict(da.decode_attention.mode_launches)
    if writes != want or dmodes != {"fp": 0, "dynamic":
                                    L * eng.n_decode_steps, "static": 0} or \
            pa.quantize_kv.launches or pa.quantize_kv_static.launches:
        fail(f"{phase}: K/V writes by mode {writes} (expected {want}); decode "
             f"attention by mode {dmodes}; standalone quantizes "
             f"{pa.quantize_kv.launches} / {pa.quantize_kv_static.launches}")
    variants = only_variant(counters, "splitquant_matmul", phase)
    dtypes = cache_dtypes(phase, "int8")
    n_tok = sum(len(r.out) for r in fin)
    res = {"arch": cfg.name, "card": card_line, "kv_cache": "int8 dynamic",
           "requests": n, "new_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "ttft_p50_s": percentile([r.ttft for r in fin], 50),
           "prefill_p50_s": percentile(eng.prefill_s, 50),
           "decode_step_p50_s": percentile(eng.decode_step_s, 50),
           "prefills": eng.n_prefills,
           "materializations": eng.materializations_in_run,
           "decode_steps": eng.n_decode_steps,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "matmul_variants": variants,
           "cache_dtypes": dtypes, **mode_counts()}
    log(f"{phase}: one-shot prefill, int8 dynamic cache, {n} requests, "
        f"{n_tok} new tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} "
        f"tok/s; TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms; one-shot prefill "
        f"p50 {res['prefill_p50_s'] * 1e3:.1f} ms; decode step p50 "
        f"{res['decode_step_p50_s'] * 1e3:.2f} ms; {eng.n_prefills} prefills, "
        f"{eng.materializations_in_run} fp materializations; K/V writes by "
        f"mode {writes} ({L} x (admissions + decode steps)); launches "
        f"{launches} [card: {card_line}]")
    return res


def sampling_phase(torch, counters, params, card_line):
    """Temperature sampling on the card. 1: ``sample_tokens`` on a fixed
    seeded logits row over the full vocab (100352: N(0, 1) but for 64 hot
    tokens at 10 + U(0, 1.5)), T = 0.7, 1e5 draws in batches of 2000
    rows: the 64 hot tokens and the rest within the 1 - 1e-6 chi-square
    bound (64 degrees of freedom) of softmax(logits / T), each bin
    expecting at least 5. 2: the bf16-cache engine at T = 0.7 over 8
    requests: every budget served, every token inside the vocab."""
    import dataclasses
    from repro_torch.engine.engine import sample_tokens
    from repro_torch.launch.serve import bf16_cache_workload
    cfg, ecfg, _, warmup, prompts = bf16_cache_workload()
    V, n, T, batch = cfg.vocab, 100_000, 0.7, 2000
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(V, generator=g)
    hot = torch.randperm(V, generator=g)[:64].sort().values
    logits[hot] = 10.0 + 1.5 * torch.rand(64, generator=g)
    p = torch.softmax(logits.double() / T, -1)
    expect = n * torch.cat([p[hot], 1 - p[hot].sum()[None]])
    if float(expect.min()) < 5:
        fail(f"sampling: a bin expects {float(expect.min()):.2f} < 5 draws")
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = logits.to("cuda").expand(batch, V)
    counts = torch.zeros(V, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n // batch):
        counts += torch.bincount(sample_tokens(row, T, gen), minlength=V)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    counts = counts.cpu().double()
    o = torch.cat([counts[hot], (n - counts[hot].sum())[None]])
    chi2 = float(((o - expect) ** 2 / expect).sum())
    if not chi2 < CHI2_64:
        fail(f"sampling: chi-square {chi2:.2f} >= {CHI2_64} over 65 bins")
    log(f"sampling: {n} draws at T={T} over a {V}-token row in "
        f"{t_draw:.3f} s ({n // batch} batches of {batch} rows); chi-square "
        f"{chi2:.2f} < {CHI2_64} (65 bins, hot mass "
        f"{float(p[hot].sum()):.4f}, least expected bin "
        f"{float(expect.min()):.1f}) [card: {card_line}]")
    ecfg = dataclasses.replace(ecfg, temperature=T)
    eng, fin, wall, launches = serve_run(torch, counters, "sampling", cfg,
                                         params, ecfg, warmup, prompts[:8])
    dtypes = cache_dtypes("sampling", "bfloat16")
    n_tok = sum(len(r.out) for r in fin)
    res = {"card": card_line, "draws": n, "temperature": T, "vocab": V,
           "chi2": chi2, "chi2_bound": CHI2_64, "draw_s": t_draw,
           "hot_mass": float(p[hot].sum()),
           "engine": {"requests": len(fin), "new_tokens": n_tok,
                      "wall_s": wall, "tokens_per_s": n_tok / wall,
                      "decode_step_p50_s": percentile(eng.decode_step_s, 50),
                      "distinct_tokens": len({t for r in fin for t in r.out}),
                      "cache_dtypes": dtypes},
           "launches": launches, **mode_counts()}
    log(f"sampling: the bf16-cache engine at T={T}, {len(fin)} requests x "
        f"{ecfg.max_new_tokens} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tok/s, {res['engine']['distinct_tokens']} "
        f"distinct tokens")
    return res


def percentile_phase(torch, card_line):
    """The percentile-clipped baseline at full width on the card:
    ``quantize_tree(method="percentile")`` (99%, INT4, k=1) of the seeded
    stablelm-1.6b tree, timed; then one 2048 x 5632 bf16 leaf quantized
    on the card and on the CPU: codes, scales and zeros identical."""
    from repro_torch.core.quantize import QuantConfig
    from repro_torch.core.splitquant import baseline_quant_tensor
    from repro_torch.launch.serve import build_params, smoke_workload
    cfg = smoke_workload()[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, report = build_params(cfg, device="cuda", bits=4,
                                  method="percentile", seed=0)
    torch.cuda.synchronize()
    t_tree = time.perf_counter() - t0
    methods = {e["method"] for e in report["per_path"].values()}
    if methods != {"percentile"} or not report["quantized"]:
        fail(f"percentile_quant: methods {methods}")
    head = params["lm_head"]
    if head.k != 1 or not bool(torch.isfinite(head.scale).all()):
        fail("percentile_quant: the lm_head is not one finite range")
    del params
    g = torch.Generator().manual_seed(6)
    w = (torch.randn((2048, 5632), generator=g) * 0.02).to(torch.bfloat16)
    qcfg = QuantConfig(bits=4, percentile=0.99)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = baseline_quant_tensor(w.to("cuda"), qcfg)
    torch.cuda.synchronize()
    t_leaf = time.perf_counter() - t0
    cpu = baseline_quant_tensor(w, qcfg)
    same = all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
               for f in ("q", "scale", "zero"))
    if not same:
        fail(f"percentile_quant: the card's leaf differs from the CPU's "
             f"(scale {card.scale.tolist()} vs {cpu.scale.tolist()})")
    res = {"card": card_line, "tree_s": t_tree,
           "matrices": len(report["quantized"]),
           "deployed_bytes": report["deployed_bytes"],
           "leaf_s": t_leaf, "leaf_identical_to_cpu": same,
           "lm_head_elements": head.shape[0] * head.shape[1]}
    log(f"percentile_quant: quantize_tree(method=percentile, 99%, INT4) of "
        f"stablelm-1.6b at full width ({res['matrices']} matrices, the "
        f"lm_head {res['lm_head_elements']} elements) on the card in "
        f"{t_tree:.2f} s; a 2048 x 5632 leaf in {t_leaf * 1e3:.1f} ms, codes "
        f"and scales identical to the CPU's [card: {card_line}]")
    return res


@contextlib.contextmanager
def _no_kmeans():
    """Make the port's k-means raise for as long as the context is open
    (serving from a recipe must never cluster)."""
    import repro_torch.core.kmeans as kmeans_mod
    import repro_torch.core.splitquant as splitquant_mod

    def boom(*a, **kw):
        raise AssertionError("k-means ran while serving from a recipe")

    names = [(m, n) for m in (kmeans_mod, splitquant_mod)
             for n in ("kmeans_1d", "kmeans_1d_batched")]
    saved = [getattr(m, n) for m, n in names]
    for m, n in names:
        setattr(m, n, boom)
    try:
        yield
    finally:
        for (m, n), f in zip(names, saved):
            setattr(m, n, f)


def _same_packed(torch, a, b, path="") -> None:
    """Fail unless two trees hold the same dense tensors and bit-identical
    packed weights."""
    from repro_torch.kernels.ops import PackedWeight
    if isinstance(b, dict):
        for key in b:
            _same_packed(torch, a[key], b[key], f"{path}/{key}")
    elif isinstance(b, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_packed(torch, x, y, f"{path}/{i}")
    elif isinstance(b, PackedWeight):
        same = isinstance(a, PackedWeight) and \
            (a.bits, a.k, a.shape, a.orig_dtype) == \
            (b.bits, b.k, b.shape, b.orig_dtype) and \
            all(torch.equal(getattr(a, f), getattr(b, f))
                for f in ("qp", "cp", "recip", "shift", "scale", "zero"))
        if not same:
            fail(f"recipe: the restored {path} differs from the saved one")
    elif not (a.dtype == b.dtype and torch.equal(a, b)):
        fail(f"recipe: the restored {path} differs from the saved one")


def _ckpt_bytes(tree) -> int:
    """The bytes of a checkpoint of ``tree``: every quantized weight as
    1-byte codes and 1-byte cluster ids plus fp32 scales and zeros, every
    dense leaf in fp32."""
    from repro_torch.kernels.ops import PackedWeight
    if isinstance(tree, dict):
        return sum(_ckpt_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_ckpt_bytes(v) for v in tree)
    if isinstance(tree, PackedWeight):
        return 2 * tree.shape[0] * tree.shape[1] + 8 * tree.scale.numel()
    return 4 * tree.numel()


def recipe_phase(torch, counters, card_line):
    """Calibrate, save and serve a mixed-precision recipe at full width:
    ``layer_sensitivity`` of the seeded bf16 stablelm-1.6b tree at bits
    (2, 4, 8), SplitQuant k=3, over one seeded calibration batch of
    2 x 128 tokens; ``greedy_allocate`` at the budget midway between
    uniform INT2 and uniform INT4; ``quantize_tree`` with its overrides;
    static KV scales from ``collect_kv_stats`` on the mixed tree; a
    checkpoint and a QuantRecipe in a temporary directory (free space
    checked first); ``load_recipe_params`` with k-means made to fail; then
    the smoke workload's 16 requests served from the recipe, gated on
    the in-memory mixed tree's tokens (same scales, same run), on matmul
    launches at every allocated bit-width (``bits_launches``), all
    ``bf16_wgmma``, and on static attention and write launches only."""
    import os
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.calib import (QuantRecipe, greedy_allocate,
                                   layer_sensitivity, sensitivity_summary,
                                   uniform_bytes)
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.apply import QuantPolicy, quantize_tree
    from repro_torch.core.quantize import QuantConfig
    from repro_torch.engine import Engine
    from repro_torch.kernels import splitquant_matmul as sqm
    from repro_torch.launch.serve import load_recipe_params, smoke_workload
    from repro_torch.models import get_model, transformer

    cfg, ecfg, quant, warmup, prompts = smoke_workload()
    dense = get_model(cfg).init(cfg, seed=quant["seed"], device="cuda")
    toks = np.random.default_rng(11).integers(0, cfg.vocab, size=(2, 128))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = layer_sensitivity(
        0, cfg, dense, lambda p, b: transformer.forward(p, cfg, b)[0],
        {"tokens": toks}, policy=QuantPolicy(k=3), bits_list=(2, 4, 8))
    torch.cuda.synchronize()
    t_sens = time.perf_counter() - t0
    top3 = sensitivity_summary(table, bits=2)[:3]
    lo, hi = uniform_bytes(table, 2), uniform_bytes(table, 4)
    budget = (lo + hi) // 2
    alloc = greedy_allocate(table, budget)
    if not alloc["feasible"] or alloc["total_bytes"] > budget:
        fail(f"recipe: allocation at {budget} bytes: feasible "
             f"{alloc['feasible']}, {alloc['total_bytes']} bytes")
    t0 = time.perf_counter()
    mixed, report = quantize_tree(dense, QuantPolicy(
        cfg=QuantConfig(bits=4)), seed=0, overrides=alloc["overrides"])
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    got_bits = {p: e["bits"] for p, e in report["per_path"].items()}
    if got_bits != alloc["assignment"]:
        fail(f"recipe: quantize_tree bits {got_bits} != the allocation's "
             f"{alloc['assignment']}")
    chosen = sorted(set(alloc["assignment"].values()))
    scales, t_cal = calibrate(torch, cfg, mixed, "cuda")
    need = _ckpt_bytes(mixed)
    with tempfile.TemporaryDirectory() as rdir:
        free = shutil.disk_usage(rdir).free
        if free < 1.2 * need:
            fail(f"recipe: {free / 2**30:.1f} GiB free under {rdir}, the "
                 f"checkpoint needs about {need / 2**30:.1f} GiB")
        t0 = time.perf_counter()
        ckpt.save(os.path.join(rdir, "ckpt"), 0, mixed)
        QuantRecipe(
            name=f"{cfg.name}-mixed-splitquant", arch=cfg.name,
            policies=alloc["overrides"], kv_scales=scales,
            kv_qchunks=ecfg.kv_qchunks, ckpt_dir="ckpt",
            meta={"budget_bytes": budget,
                  "deployed_bytes": report["deployed_bytes"],
                  "avg_bits": alloc["avg_bits"], "reduced": False,
                  "sensitivity_top": top3}).save(rdir)
        t_save = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(rdir) for f in fs)
        t0 = time.perf_counter()
        with _no_kmeans():
            restored, rec, rscales = load_recipe_params(
                rdir, dense, arch=cfg.name, reduced=False)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    del dense
    _same_packed(torch, restored, mixed)
    ref = Engine(cfg, mixed, ecfg, device="cuda", kv_scales=scales)
    for p in prompts:
        ref.submit(p)
    want = [r.out for r in ref.drain()]
    del ref, mixed
    eng, fin, wall, launches = serve_run(
        torch, counters, "recipe", cfg, restored, ecfg, warmup, prompts,
        kv_scales=rscales)
    by_bits = dict(sqm.splitquant_matmul.bits_launches)
    variants = only_variant(counters, "splitquant_matmul", "recipe")
    modes = only_modes(counters, "recipe", {"static"}, {"static"})
    writes = one_write_per_layer(
        "recipe", cfg.n_layers,
        {"static": eng.n_decode_steps + eng.n_prefill_chunks})
    if any(by_bits[b] <= 0 for b in chosen) or \
            any(n for b, n in by_bits.items() if b not in chosen):
        fail(f"recipe: matmul launches by bits {by_bits}; the allocation "
             f"chose {chosen}")
    outs = [r.out for r in fin]
    if outs != want:
        fail("recipe: the engine over the restored recipe gave other tokens "
             "than the engine over the in-memory mixed tree")
    n_tok = sum(len(o) for o in outs)
    peak = torch.cuda.max_memory_allocated()
    res = {"card": card_line, "sensitivity_s": t_sens,
           "sensitivity_top3_kl_int2": top3,
           "table_bytes": {b: uniform_bytes(table, b) for b in (2, 4, 8)},
           "budget_bytes": budget, "total_bytes": alloc["total_bytes"],
           "avg_bits": alloc["avg_bits"], "assignment": alloc["assignment"],
           "quantize_s": t_quant, "calibration_s": t_cal,
           "deployed_bytes": report["deployed_bytes"],
           "checkpoint_bytes": ckpt_bytes, "free_bytes": free,
           "save_s": t_save, "load_s": t_load, "requests": len(fin),
           "new_tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_p50_s": percentile([r.ttft for r in fin], 50),
           "decode_step_p50_s": percentile(eng.decode_step_s, 50),
           "peak_mem_bytes": peak, "launches": launches,
           "bits_launches": by_bits, "matmul_variants": variants,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes, "identical_to_in_memory": True}
    log(f"recipe: layer_sensitivity of {len(table)} groups x bits (2, 4, 8) "
        f"over 2 x 128 tokens in {t_sens:.2f} s; most sensitive at INT2 "
        f"(kl): {', '.join(f'{p} {kl:.4f}' for p, kl in top3)}")
    log(f"recipe: budget {budget} B (uniform INT2 {lo}, INT4 {hi}); "
        f"greedy allocation {alloc['total_bytes']} B, {alloc['avg_bits']:.3f} "
        f"bits on average, bits by path {alloc['assignment']}; quantized in "
        f"{t_quant:.2f} s; KV scales in {t_cal:.2f} s")
    log(f"recipe: checkpoint + recipe {ckpt_bytes / 1e9:.3f} GB written in "
        f"{t_save:.2f} s ({free / 2**30:.1f} GiB were free), restored by "
        f"load_recipe_params with no k-means in {t_load:.2f} s, bit-identical")
    log(f"recipe: {len(fin)} requests from the restored recipe, tokens == the "
        f"in-memory mixed tree's; {n_tok} new tokens in {wall:.3f} s = "
        f"{res['tokens_per_s']:.1f} tok/s; TTFT p50 "
        f"{res['ttft_p50_s'] * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} "
        f"GiB; matmul launches by bits {by_bits}, by variant {variants}; "
        f"attention by mode {modes}; K/V writes by mode {writes} "
        f"[card: {card_line}]")
    return res


def options_cross_check(torch):
    """stablelm-1.6b ``.reduced()`` in fp32 (INT4 SplitQuant weights) on
    the card and on the CPU with the same weights: the greedy engine over
    a bf16 and a float16 fp cache, the one-shot int8 engine and the
    ``fused_attn=False`` engine each give identical tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.tree import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg = get_arch("stablelm-1.6b").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", seed=0,
                             device="cpu")
    prompts = seeded_prompts(cfg.vocab, 8, 16, 200, seed=3)
    res = {}
    for name, kw in (("bf16_cache", dict(kv_mode="fp", kv_dtype="bfloat16")),
                     ("f16_cache", dict(kv_mode="fp", kv_dtype="float16")),
                     ("oneshot_int8", dict(kv_mode="int8", prefill_chunk=0)),
                     ("materialize", dict(kv_mode="int8",
                                          fused_attn=False))):
        outs = {}
        for dev, p in (("cpu", params), ("cuda", tree_to(params, "cuda"))):
            eng = Engine(cfg, p, EngineConfig(n_slots=4, max_len=256,
                                              max_new_tokens=16, **kw),
                         device=dev)
            for pr in prompts:
                eng.submit(pr)
            outs[dev] = [r.out for r in eng.drain()]
        same = outs["cpu"] == outs["cuda"]
        log(f"options cross-check ({name}): stablelm-1.6b reduced fp32, 8 "
            f"requests x 16 tokens: card tokens {'==' if same else '!='} CPU "
            f"tokens")
        if not same:
            fail(f"options cross-check ({name}): card {outs['cuda']} != cpu "
                 f"{outs['cpu']}")
        res[name] = {"requests": len(prompts), "identical": same}
    return res


@contextlib.contextmanager
def routing_margins(ffn):
    """Records each routing's ``ffn.routing_margin`` (a 0-d tensor) into
    the list it yields, by wrapping ``ffn.route`` until the block ends.
    Untimed runs only: it adds a top-(K+1) to every MoE layer."""
    rec, route = [], ffn.route

    def recording(p, xt, cfg):
        out = route(p, xt, cfg)
        rec.append(ffn.routing_margin(out[0], cfg.top_k))
        return out
    ffn.route = recording
    try:
        yield rec
    finally:
        ffn.route = route


def moe_phase(torch, counters, card_line):
    """moonshot-v1-16b-a3b as the JAX package's config gives it
    (``moe_smoke_workload``: 48 layers, 1 dense + 47 MoE of 64 experts
    top-6 with 2 shared, MHA 16 x 128; SplitQuant INT4 k=3 built layer by
    layer on the card) through the engine over the int8 dynamic slot
    cache, 16 requests of 32 tokens, with a ``SnapshotWriter`` of the
    engine's registry in a temporary directory (``serve_run``). Gates: as
    ``serve_run``; one K/V write a layer and forward pass over the 48
    layers; the grouped matmul launched 3 x 47 times a decode step and a
    prefill chunk; the dense matmul and the attention kernels in their
    bf16 variants and dynamic modes only; no expert stack dequantized
    (``ffn.EXPERT_DEQUANTIZATIONS`` unchanged); finite logits at full
    width; the snapshot file read back by ``load_snapshots``, its last
    snapshot counting the run's tokens. Printed: build seconds and peak,
    deployed bytes, tokens/s, TTFT, decode-step and prefill-chunk p50,
    peak memory, KV cache bytes, launches by variant and mode, and the
    routing margin (the smallest gap between a token's 6th and 7th router
    probability) of the untimed logits check after the run."""
    import os
    import tempfile
    from repro_torch.launch.serve import build_params, moe_smoke_workload
    from repro_torch.models import ffn, transformer
    from repro_torch.obs import load_snapshots
    cfg, ecfg, quant, warmup, prompts = moe_smoke_workload()
    phase = "moe"
    n_dense, n_moe = transformer.stack_depths(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, report = build_params(cfg, device="cuda", **quant)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    weight_bytes = torch.cuda.memory_allocated()
    log(f"{phase}: {cfg.name} full width ({cfg.n_layers} layers: {n_dense} "
        f"dense of FFN {cfg.dense_d_ff}, {n_moe} MoE of {cfg.n_experts} "
        f"experts top-{cfg.top_k} + {cfg.n_shared_experts} shared, d_ff "
        f"{cfg.d_ff}; d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab}): init + SplitQuant INT4 k=3 of "
        f"{len(report['quantized'])} leaves layer by layer on the card in "
        f"{t_build:.2f} s, build peak {build_peak / 2**30:.2f} GiB; "
        f"deployed {report['deployed_bytes'] / 1e9:.3f} GB (the JAX count), "
        f"{weight_bytes / 2**30:.2f} GiB on the card")
    deq0 = ffn.EXPERT_DEQUANTIZATIONS
    with tempfile.TemporaryDirectory() as tmp:
        snap_path = os.path.join(tmp, "metrics.jsonl")
        eng, fin, wall, launches = serve_run(
            torch, counters, phase, cfg, params, ecfg, warmup, prompts,
            snapshot_path=snap_path)
        header, snaps = load_snapshots(snap_path)
    peak = torch.cuda.max_memory_allocated()
    passes = eng.n_decode_steps + eng.n_prefill_chunks
    variants = dict(counters["splitquant_matmul"].variant_launches)
    if variants["grouped"] != 3 * n_moe * passes or \
            variants["fp32_cuda_core"] or not variants["bf16_wgmma"]:
        fail(f"{phase}: matmul launches by variant {variants}; expected "
             f"grouped = 3 x {n_moe} MoE layers x {passes} forward passes, "
             f"bf16_wgmma > 0, no fp32_cuda_core")
    deq = ffn.EXPERT_DEQUANTIZATIONS - deq0
    if deq:
        fail(f"{phase}: {deq} expert stacks dequantized on the card path")
    pvariants = only_variant(counters, "prefill_attention", phase)
    dvariants = only_variant(counters, "decode_attention", phase)
    modes = only_modes(counters, phase, {"dynamic"}, {"dynamic"})
    writes = one_write_per_layer(phase, cfg.n_layers, {"dynamic": passes})
    n_tok = sum(len(r.out) for r in fin)
    if header.get("kind") != "header" or "provenance" not in header or \
            [r["seq"] for r in snaps] != \
            list(range(eng.snapshots_written)) or len(snaps) < 2 or \
            snaps[-1]["metrics"]["engine_tokens_generated"] != n_tok:
        fail(f"{phase}: metrics snapshots read back wrong: header "
             f"{header.get('kind')}, seqs {[r['seq'] for r in snaps]}, last "
             f"tokens {snaps[-1]['metrics'].get('engine_tokens_generated')}")
    with routing_margins(ffn) as margins:
        finite_logits(torch, phase, cfg, params, eng, fin)
    margin = float(torch.stack(margins).min())
    ttft = [r.ttft for r in fin]
    res = {"arch": cfg.name, "card": card_line, "build_s": t_build,
           "build_peak_bytes": build_peak, "weight_bytes": weight_bytes,
           "deployed_bytes": report["deployed_bytes"],
           "quantized_leaves": len(report["quantized"]),
           "requests": len(fin), "new_tokens": n_tok,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_p50_s": percentile(ttft, 50),
           "ttft_p90_s": percentile(ttft, 90),
           "decode_step_p50_s": percentile(eng.decode_step_s, 50),
           "prefill_chunk_p50_s": percentile(eng.prefill_chunk_s, 50),
           "decode_steps": eng.n_decode_steps,
           "prefill_chunks": eng.n_prefill_chunks,
           "peak_mem_bytes": peak, "kv_cache_bytes": eng.cache.nbytes(),
           "launches": launches, "matmul_variants": variants,
           "prefill_variants": pvariants, "decode_variants": dvariants,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes, "routing_margin": margin,
           "routings": len(margins), "expert_dequantizations": deq,
           "snapshots": len(snaps), "outputs": [r.out for r in fin]}
    log(f"{phase}: {len(fin)} requests, {res['prompt_tokens']} prompt + "
        f"{n_tok} new tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} "
        f"tok/s; TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms; decode step p50 "
        f"{res['decode_step_p50_s'] * 1e3:.2f} ms; prefill chunk p50 "
        f"{res['prefill_chunk_p50_s'] * 1e3:.2f} ms; {eng.n_decode_steps} "
        f"decode steps, {eng.n_prefill_chunks} prefill chunks; peak memory "
        f"{peak / 2**30:.2f} GiB; KV cache "
        f"{res['kv_cache_bytes'] / 2**20:.1f} MiB; launches {launches}; "
        f"matmul launches by variant {variants} (grouped = 3 x {n_moe} x "
        f"{passes} passes); prefill attention by variant {pvariants}, by "
        f"mode {modes['prefill_attention']}; decode attention by variant "
        f"{dvariants}, by mode {modes['decode_attention']}; K/V writes by "
        f"mode {writes} (one a layer and forward pass over "
        f"{cfg.n_layers} layers); expert stacks dequantized {deq}; routing "
        f"margin of the logits check after the run {margin:.3e} over "
        f"{len(margins)} routings; {len(snaps)} metrics snapshots read "
        f"back [card: {card_line}]")
    del eng
    return res, params


def _outs(eng) -> dict:
    """Each request's tokens so far, finished or in a slot."""
    live = [r for r in eng.sched.slots if r is not None]
    return {r.uid: list(r.out) for r in eng.sched.finished + live}


def moe_cross_check(torch):
    """moonshot-v1-16b-a3b ``.reduced()`` in fp32 (1 dense + 1 MoE layer
    of 8 experts top-2, INT4 SplitQuant) through the engine over an int8
    dynamic cache, 8 requests x 16 tokens, on the card (the fp32 grouped
    kernel) and on the CPU (JAX's literal form, eq. 4): identical greedy
    tokens. The two engines step in turns; if they part, the step and
    each device's routing margin in it are printed."""
    from repro_torch.configs import get_arch
    from repro_torch.tree import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.kernels import splitquant_matmul as sqm
    from repro_torch.launch.serve import build_params, seeded_prompts
    from repro_torch.models import ffn
    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", seed=0,
                             device="cpu")
    prompts = seeded_prompts(cfg.vocab, 8, 16, 200, seed=1)
    ecfg = EngineConfig(n_slots=4, max_len=256, max_new_tokens=16,
                        kv_mode="int8", prefill_chunk=96)
    engs = {dev: Engine(cfg, p, ecfg, device=dev) for dev, p in
            (("cpu", params), ("cuda", tree_to(params, "cuda")))}
    for e in engs.values():
        for pr in prompts:
            e.submit(pr)
    g0 = sqm.splitquant_matmul.variant_launches["grouped"]
    parted, margins, step = None, {}, 0
    while not all(e.sched.idle for e in engs.values()):
        for dev, e in engs.items():
            with routing_margins(ffn) as rec:
                if not e.sched.idle:
                    e.step()
            margins[dev] = float(torch.stack(rec).min()) if rec else None
        if parted is None and _outs(engs["cpu"]) != _outs(engs["cuda"]):
            parted = {"step": step, "routing_margin": dict(margins)}
        step += 1
    grouped = sqm.splitquant_matmul.variant_launches["grouped"] - g0
    outs = {dev: [r.out for r in sorted(e.sched.finished,
                                        key=lambda r: r.uid)]
            for dev, e in engs.items()}
    same = outs["cpu"] == outs["cuda"]
    log(f"moe cross-check: {cfg.name} reduced fp32, int8 KV, 8 requests x "
        f"16 tokens, {step} steps, {grouped} grouped fp32 launches on the "
        f"card: card tokens {'==' if same else '!='} CPU tokens"
        + ("" if parted is None else
           f"; parted at step {parted['step']}, routing margin of that "
           f"step {parted['routing_margin']}"))
    if not same or not grouped:
        fail(f"moe cross-check: card {outs['cuda']} != cpu {outs['cpu']} "
             f"or no grouped launch ({grouped}); parted {parted}")
    return {"requests": len(prompts), "identical": same, "steps": step,
            "grouped_launches": grouped, "parted": parted}


def moe_spec_phase(torch, counters, params, moe_res, card_line):
    """moonshot-v1-16b-a3b at full width (the moe phase's INT4 target
    tree, no second target) through the speculative engine: spec_k 3, an
    INT2 SplitQuant k=3 draft of the same seeded weights built part by
    part on the card and kept packed (``draft_dequantize=False``: its
    experts run through the grouped kernel at bits 2; dequantized, its
    stacks would be 56 GB of bf16), the moe phase's cache and chunks, the
    first 8 of its requests. Gates: as ``serve_run`` (every request its
    32 tokens, each kernel of the path launched); the grouped matmul 3 x
    47 times each forward pass of the target (chunks, verify passes,
    decode steps) and of the draft (its mirrored chunks and draft steps),
    at bits 2 at least 3 x 47 times each draft pass; one K/V write a layer
    and pass over the 48 layers (dynamic for both caches); no expert stack
    dequantized. Printed, not gated: the share of tokens equal to the moe
    phase's greedy output, acceptance, tokens/s, spec-step p50."""
    import dataclasses
    from repro_torch.launch.serve import build_params, moe_smoke_workload
    from repro_torch.models import ffn, transformer
    cfg, ecfg, quant, warmup, prompts = moe_smoke_workload()
    prompts = prompts[:8]
    n_moe = transformer.stack_depths(cfg)[1]
    ecfg = dataclasses.replace(ecfg, spec_k=3, draft_dequantize=False)
    t0 = time.perf_counter()
    draft, _ = build_params(cfg, device="cuda", **dict(quant, bits=2))
    torch.cuda.synchronize()
    t_draft = time.perf_counter() - t0
    deq0 = ffn.EXPERT_DEQUANTIZATIONS
    eng, fin, wall, launches = serve_run(
        torch, counters, "moe_spec", cfg, params, ecfg, warmup, prompts,
        draft_params=draft)
    deq = ffn.EXPERT_DEQUANTIZATIONS - deq0
    del draft
    sqm = counters["splitquant_matmul"]
    variants, by_bits = dict(sqm.variant_launches), dict(sqm.bits_launches)
    target = eng.n_prefill_chunks + eng.n_verify_calls + eng.n_decode_steps
    drafted = eng.n_prefill_chunks + eng._spec.n_draft_steps
    if variants["grouped"] != 3 * n_moe * (target + drafted) or \
            by_bits[2] < 3 * n_moe * drafted or variants["fp32_cuda_core"]:
        fail(f"moe_spec: matmul launches by variant {variants}, by bits "
             f"{by_bits}; expected grouped = 3 x {n_moe} x ({target} target "
             f"+ {drafted} draft passes), >= 3 x {n_moe} x {drafted} at bits "
             f"2, no fp32_cuda_core")
    if deq:
        fail(f"moe_spec: {deq} expert stacks dequantized")
    modes = only_modes(counters, "moe_spec", {"dynamic"},
                       {"dynamic", "verify_dynamic"})
    writes = one_write_per_layer("moe_spec", cfg.n_layers,
                                 {"dynamic": target + drafted})
    n_tok = sum(len(r.out) for r in fin)
    greedy = moe_res["outputs"][:8]
    same = sum(a == b for r, g in zip(fin, greedy)
               for a, b in zip(r.out, g))
    res = {"arch": cfg.name, "card": card_line, "spec_k": ecfg.spec_k,
           "requests": len(fin), "new_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "draft_build_s": t_draft,
           "acceptance_rate": eng.sched.acceptance_rate(),
           "draft_proposed": eng.sched.spec_proposed,
           "draft_accepted": eng.sched.spec_accepted,
           "spec_steps": eng.n_spec_steps, "verify_calls": eng.n_verify_calls,
           "rollbacks": eng.n_rollbacks,
           "draft_steps": eng._spec.n_draft_steps,
           "spec_step_p50_s": percentile(eng.spec_step_s, 50),
           "ttft_p50_s": percentile([r.ttft for r in fin], 50),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "matmul_variants": variants,
           "bits_launches": by_bits, "expert_dequantizations": deq,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes,
           "identical_to_moe_greedy_share": same / n_tok}
    # where each request first parts from greedy, and the target's top-2
    # logit margin there (a near-tie that bf16 verify and decode break
    # apart, or not)
    firsts = [next((j for j, (a, b) in enumerate(zip(r.out, g)) if a != b),
                   None) for r, g in zip(fin, greedy)]
    res["first_difference"] = firsts
    res["top2_margin_there"] = [
        None if j is None else top2_margin(
            torch, cfg, params, None, list(prompts[i]) + list(fin[i].out[:j]))
        for i, j in enumerate(firsts)]
    # the first request's second token (its first decode step) through
    # both paths
    res["verify_vs_decode"] = drift = verify_drift(torch, cfg, params,
                                                   list(prompts[0]))
    log(f"moe_spec: {cfg.name} full width, spec_k {ecfg.spec_k}, INT2 draft "
        f"built in {t_draft:.1f} s and kept packed; {len(fin)} requests, "
        f"{n_tok} new tokens in {wall:.3f} s = {res['tokens_per_s']:.2f} "
        f"tok/s; acceptance {res['acceptance_rate']:.3f} "
        f"({res['draft_accepted']}/{res['draft_proposed']}); "
        f"{eng.n_spec_steps} spec steps ({eng.n_verify_calls} verify calls, "
        f"{eng.n_rollbacks} rollbacks, {res['draft_steps']} draft steps); "
        f"spec step p50 {res['spec_step_p50_s'] * 1e3:.1f} ms; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; matmul by variant "
        f"{variants}, by bits {by_bits}; prefill attention by mode "
        f"{modes['prefill_attention']}; K/V writes by mode {writes}; expert "
        f"stacks dequantized {deq}; {100 * same / n_tok:.1f}% of tokens "
        f"identical to the moe phase's greedy output (first difference by "
        f"request {firsts}; the target's top-2 logit margin there "
        f"{[None if m is None else round(m, 4) for m in res['top2_margin_there']]}"
        f"; request 0's second token through a decode step and as a verify "
        f"row: argmax {drift['decode_argmax']} vs {drift['verify_argmax']}, "
        f"largest logit difference {drift['max_abs_logit_diff']:.4f}, experts "
        f"apart in {len(drift['moe_layers_routed_apart'])} of "
        f"{drift['moe_layers']} MoE layers, the first "
        f"{(drift['moe_layers_routed_apart'] or [None])[0]}) "
        f"[card: {card_line}]")
    return res


def verify_drift(torch, cfg, params, prompt, window=(5, 7, 11)) -> dict:
    """Where a verify row and the decode step it replaces part: ``prompt``
    prefilled into two fresh one-slot int8 caches, then the token after
    it through a decode step on one and as row 0 of a verify window on
    the other. Returns both argmaxes, their largest logit difference and
    the MoE layers whose experts for that token differ (untimed: it wraps
    ``ffn.route``)."""
    from repro_torch.engine.kvcache import init_slot_cache
    from repro_torch.models import ffn, transformer

    def fresh():
        cache = init_slot_cache(cfg, 1, len(prompt) + len(window) + 1,
                                mode="int8", device="cuda")
        t = torch.as_tensor(prompt, device="cuda")[None]
        for done in range(0, len(prompt), 96):
            n = min(96, len(prompt) - done)
            logits = transformer.prefill_chunk_slots(
                params, cfg, cache, t[:, done:done + n], 0, done, n)
        return cache, int(logits[0].argmax())
    experts, route = [], ffn.route

    def recording(p, xt, c):
        out = route(p, xt, c)
        experts.append(out[2][0].sort().values.tolist())
        return out
    (ca, tok), (cb, _) = fresh(), fresh()
    P = len(prompt)
    ffn.route = recording
    try:
        dec = transformer.decode_step_slots(
            params, cfg, ca, torch.tensor([[tok]], device="cuda"),
            torch.tensor([P], device="cuda"))[0, 0].float()
        by_decode, experts[:] = list(experts), []
        ver = transformer.verify_step_slots(
            params, cfg, cb, torch.tensor([[tok, *window]], device="cuda"),
            0, P, len(window) + 1)[0, 0].float()
        by_verify = list(experts)
    finally:
        ffn.route = route
    return {"decode_argmax": int(dec.argmax()),
            "verify_argmax": int(ver.argmax()),
            "max_abs_logit_diff": float((dec - ver).abs().max()),
            "moe_layers_routed_apart": [
                i for i, (a, b) in enumerate(zip(by_decode, by_verify))
                if a != b],
            "moe_layers": len(by_decode)}


@contextlib.contextmanager
def dropped_pairs(ffn):
    """Records, by wrapping ``ffn.dispatch`` until the block ends, each
    MoE dispatch of more than 512 tokens a block (the drop regime): the
    list it yields gets its (n_blocks, Tb·K) mask of dropped pairs, a
    device tensor (no synchronization)."""
    rec, dispatch = [], ffn.dispatch

    def recording(eidx, n_blocks, E, C):
        out = dispatch(eidx, n_blocks, E, C)
        if eidx.shape[0] // n_blocks > 512:
            rec.append(~out[2])
        return out
    ffn.dispatch = recording
    try:
        yield rec
    finally:
        ffn.dispatch = dispatch


def moe_wave_phase(torch, counters, params, card_line):
    """moonshot-v1-16b-a3b at full width (the moe phase's tree) through
    the wave ``Server``: the moe phase's 16 requests in waves of 8,
    left-padded, a bf16 ``KVCache`` of 1024 rows a wave, attention in
    plain PyTorch. A wave prefill routes its 8 x S tokens (pads included)
    as one block: above 512 a block each expert takes int(Tb·6·1.25) //
    64 pairs and the rest drop. The counts are set to 0 just before the
    run and read just after. Gates: every request its 32 tokens; the
    matmul launched in its bf16 tensor-core and grouped forms only; no
    attention kernel, K/V write or quantizer; no expert stack dequantized;
    dropped pairs > 0 in some wave prefill. Printed: the dropped pairs,
    tokens/s, wave-prefill and decode-step p50, peak memory."""
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.launch.serve import moe_smoke_workload
    from repro_torch.models import ffn
    from repro_torch.runtime.serve_loop import Request, Server, ServeConfig
    cfg, _, _, warmup, prompts = moe_smoke_workload()
    scfg = ServeConfig(max_batch=8, max_new_tokens=32, max_len=1024)
    Server(cfg, params, ServeConfig(max_batch=8, max_new_tokens=2,
                                    max_len=1024),
           device="cuda").serve([Request(0, warmup)])
    srv = Server(cfg, params, scfg, device="cuda")
    deq0 = ffn.EXPERT_DEQUANTIZATIONS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    with dropped_pairs(ffn) as drops:
        t0 = time.perf_counter()
        fin = srv.serve([Request(i, p) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    variants = dict(counters["splitquant_matmul"].variant_launches)
    deq = ffn.EXPERT_DEQUANTIZATIONS - deq0
    peak = torch.cuda.max_memory_allocated()
    dropped = [int(d.sum()) for d in drops]
    pairs = [d.numel() for d in drops]
    n_tok = sum(len(r.out) for r in fin)
    if len(fin) != len(prompts) or \
            any(len(r.out) != scfg.max_new_tokens for r in fin) or \
            any(not 0 <= t < cfg.vocab for r in fin for t in r.out):
        fail(f"moe_wave: expected {len(prompts)} requests x "
             f"{scfg.max_new_tokens} in-vocab tokens, got "
             f"{[len(r.out) for r in fin]}")
    others = {n: c for n, c in launches.items() if n != "splitquant_matmul"}
    if any(others.values()) or pa.quantize_kv.launches or \
            pa.quantize_kv_static.launches or not variants["grouped"] or \
            not variants["bf16_wgmma"] or variants["fp32_cuda_core"]:
        fail(f"moe_wave: launches {launches}, matmul by variant {variants}; "
             f"expected the bf16 and grouped matmul only")
    if deq:
        fail(f"moe_wave: {deq} expert stacks dequantized")
    if not any(dropped):
        fail(f"moe_wave: no pair dropped in the wave prefills ({pairs} "
             f"pairs routed in the drop regime)")
    res = {"arch": cfg.name, "card": card_line, "requests": len(fin),
           "new_tokens": n_tok,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "waves": len(srv.wave_prefill_s), "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "wave_prefill_p50_s": percentile(srv.wave_prefill_s, 50),
           "wave_prefill_s": srv.wave_prefill_s,
           "decode_step_p50_s": percentile(srv.decode_step_s, 50),
           "decode_steps": len(srv.decode_step_s), "peak_mem_bytes": peak,
           "dropped_pairs": dropped, "routed_pairs": pairs,
           "launches": launches, "matmul_variants": variants,
           "expert_dequantizations": deq}
    log(f"moe_wave: {cfg.name} full width through the wave Server, waves "
        f"of 8, bf16 KV cache of 1024 rows; {len(fin)} requests in "
        f"{res['waves']} waves, {res['prompt_tokens']} prompt + {n_tok} new "
        f"tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} tok/s; wave "
        f"prefill p50 {res['wave_prefill_p50_s'] * 1e3:.1f} ms; decode step "
        f"p50 {res['decode_step_p50_s'] * 1e3:.2f} ms; dropped pairs "
        f"{sum(dropped)} of {sum(pairs)} routed in the drop regime "
        f"({len(drops)} MoE dispatches above 512 tokens: {dropped}); peak "
        f"memory {peak / 2**30:.2f} GiB; matmul by variant {variants} "
        f"[card: {card_line}]")
    return res


def kimi_phase(torch, counters, card_line):
    """kimi-k2-1t-a32b at full width, 5 of its 61 layers
    (``kimi_smoke_workload``: the dense prelude and 4 MoE layers of 384
    experts top-8 + 1 shared; d_model 7168, GQA 64/8 at head_dim 112;
    SplitQuant INT4 k=3 built part by part on the card, each expert stack
    quantized before the next is drawn) through the engine over the int8
    dynamic slot cache (sub-channel chunks of 28), 16 requests of 32
    tokens. Gates, as the moe phase's: ``serve_run``'s; one K/V write a
    layer and forward pass over the 5 layers; the grouped matmul launched
    3 x 4 times a decode step and a prefill chunk; the dense matmul and
    the attention kernels in their bf16 variants and dynamic modes only;
    no expert stack dequantized; finite logits at full width. Printed:
    build seconds and peak, deployed bytes, tokens/s, TTFT, decode-step
    and chunk p50, peak memory, launches by variant and mode."""
    from repro_torch.launch.serve import build_params, kimi_smoke_workload
    from repro_torch.models import ffn, transformer
    cfg, ecfg, quant, warmup, prompts = kimi_smoke_workload()
    phase = "kimi"
    n_dense, n_moe = transformer.stack_depths(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, report = build_params(cfg, device="cuda", **quant)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    weight_bytes = torch.cuda.memory_allocated()
    log(f"{phase}: {cfg.name} full width, {cfg.n_layers} of its 61 layers "
        f"({n_dense} dense of FFN {cfg.dense_d_ff}, {n_moe} MoE of "
        f"{cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared_experts} "
        f"shared, d_ff {cfg.d_ff}; d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads / {cfg.n_kv_heads} kv-heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab}): init + SplitQuant INT4 k=3 of "
        f"{len(report['quantized'])} leaves part by part on the card in "
        f"{t_build:.2f} s, build peak {build_peak / 2**30:.2f} GiB; deployed "
        f"{report['deployed_bytes'] / 1e9:.3f} GB (the JAX count), "
        f"{weight_bytes / 2**30:.2f} GiB on the card [card: {card_line}]")
    deq0 = ffn.EXPERT_DEQUANTIZATIONS
    eng, fin, wall, launches = serve_run(torch, counters, phase, cfg, params,
                                         ecfg, warmup, prompts)
    peak = torch.cuda.max_memory_allocated()
    passes = eng.n_decode_steps + eng.n_prefill_chunks
    variants = dict(counters["splitquant_matmul"].variant_launches)
    if variants["grouped"] != 3 * n_moe * passes or \
            variants["fp32_cuda_core"] or not variants["bf16_wgmma"]:
        fail(f"{phase}: matmul launches by variant {variants}; expected "
             f"grouped = 3 x {n_moe} MoE layers x {passes} forward passes, "
             f"bf16_wgmma > 0, no fp32_cuda_core")
    deq = ffn.EXPERT_DEQUANTIZATIONS - deq0
    if deq:
        fail(f"{phase}: {deq} expert stacks dequantized on the card path")
    pvariants = only_variant(counters, "prefill_attention", phase)
    dvariants = only_variant(counters, "decode_attention", phase)
    modes = only_modes(counters, phase, {"dynamic"}, {"dynamic"})
    writes = one_write_per_layer(phase, cfg.n_layers, {"dynamic": passes})
    finite_logits(torch, phase, cfg, params, eng, fin)
    n_tok = sum(len(r.out) for r in fin)
    ttft = [r.ttft for r in fin]
    res = {"arch": cfg.name, "card": card_line, "n_layers": cfg.n_layers,
           "build_s": t_build, "build_peak_bytes": build_peak,
           "weight_bytes": weight_bytes,
           "deployed_bytes": report["deployed_bytes"],
           "quantized_leaves": len(report["quantized"]),
           "requests": len(fin), "new_tokens": n_tok,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_p50_s": percentile(ttft, 50),
           "decode_step_p50_s": percentile(eng.decode_step_s, 50),
           "prefill_chunk_p50_s": percentile(eng.prefill_chunk_s, 50),
           "decode_steps": eng.n_decode_steps,
           "prefill_chunks": eng.n_prefill_chunks,
           "peak_mem_bytes": peak, "kv_cache_bytes": eng.cache.nbytes(),
           "launches": launches, "matmul_variants": variants,
           "prefill_variants": pvariants, "decode_variants": dvariants,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes, "expert_dequantizations": deq,
           "outputs": [r.out for r in fin]}
    log(f"{phase}: {len(fin)} requests, {res['prompt_tokens']} prompt + "
        f"{n_tok} new tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} "
        f"tok/s; TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms; decode step p50 "
        f"{res['decode_step_p50_s'] * 1e3:.2f} ms; prefill chunk p50 "
        f"{res['prefill_chunk_p50_s'] * 1e3:.2f} ms; {eng.n_decode_steps} "
        f"decode steps, {eng.n_prefill_chunks} prefill chunks; peak memory "
        f"{peak / 2**30:.2f} GiB; KV cache "
        f"{res['kv_cache_bytes'] / 2**20:.1f} MiB; launches {launches}; "
        f"matmul launches by variant {variants} (grouped = 3 x {n_moe} x "
        f"{passes} passes); prefill attention by variant {pvariants}, by "
        f"mode {modes['prefill_attention']}; decode attention by variant "
        f"{dvariants}, by mode {modes['decode_attention']}; K/V writes by "
        f"mode {writes} (one a layer and forward pass over "
        f"{cfg.n_layers} layers); expert stacks dequantized {deq} "
        f"[card: {card_line}]")
    del eng, params
    torch.cuda.empty_cache()
    return res


def _reduced_moon():
    """Reduced moonshot-v1-16b-a3b in fp32, INT4 SplitQuant (seed 0), on
    the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_params
    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    return cfg, build_params(cfg, bits=4, method="splitquant", seed=0,
                             device="cpu")[0]


def moe_spec_cross_check(torch):
    """Reduced moonshot-v1-16b-a3b in fp32 (INT4 target, INT8 draft kept
    packed: the fp32 grouped kernel on the card, JAX's literal form on
    the CPU), spec_k 3 over an int8 dynamic cache, 8 requests x 16
    tokens: the card's speculative tokens equal the CPU's speculative
    tokens and the card's greedy tokens."""
    from repro_torch.tree import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg, params = _reduced_moon()
    draft, _ = build_params(cfg, bits=8, method="splitquant", seed=0,
                            device="cpu")
    prompts = seeded_prompts(cfg.vocab, 8, 16, 200, seed=2)
    outs, counts = {}, {}
    for dev, spec_k in (("cpu", 3), ("cuda", 3), ("cuda", 0)):
        p, d = (params, draft) if dev == "cpu" else \
            (tree_to(params, "cuda"), tree_to(draft, "cuda"))
        eng = Engine(cfg, p, EngineConfig(
            n_slots=4, max_len=256, max_new_tokens=16, kv_mode="int8",
            prefill_chunk=96, spec_k=spec_k, draft_dequantize=False),
            device=dev, draft_params=d if spec_k else None)
        for pr in prompts:
            eng.submit(pr)
        outs[(dev, spec_k)] = [r.out for r in eng.drain()]
        counts[(dev, spec_k)] = (eng.sched.spec_proposed,
                                 eng.sched.spec_accepted)
    same = outs[("cuda", 3)] == outs[("cpu", 3)] == outs[("cuda", 0)]
    log(f"moe_spec cross-check: {cfg.name} reduced fp32, int8 KV, spec_k 3 "
        f"with a packed INT8 draft, 8 requests x 16 tokens: card spec tokens "
        f"{'==' if same else '!='} CPU spec tokens == card greedy tokens; "
        f"proposed / accepted card {counts[('cuda', 3)]}, CPU "
        f"{counts[('cpu', 3)]}")
    if not same:
        fail(f"moe_spec cross-check: card spec {outs[('cuda', 3)]}, cpu spec "
             f"{outs[('cpu', 3)]}, card greedy {outs[('cuda', 0)]}")
    return {"requests": len(prompts), "identical": same,
            "proposed_accepted": {f"{d}_{k}": list(c)
                                  for (d, k), c in counts.items()}}


def moe_wave_cross_check(torch):
    """Reduced moonshot-v1-16b-a3b in fp32 (INT4) through the wave
    ``Server`` on the card and on the CPU: a first wave of four prompts
    left-padded to 200 tokens (800 routed as one block, capacity 250 an
    expert: pairs dropped) and a second of two: identical greedy tokens
    and some pairs dropped (whether the dropped pairs are the CPU's is
    printed: a near-tie in the fp32 router can move one)."""
    import numpy as np
    from repro_torch.tree import tree_to
    from repro_torch.models import ffn
    from repro_torch.runtime.serve_loop import Request, Server, ServeConfig
    cfg, params = _reduced_moon()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=n)
               for n in (200, 17, 60, 3, 9, 31)]
    outs, drops = {}, {}
    for dev, p in (("cpu", params), ("cuda", tree_to(params, "cuda"))):
        srv = Server(cfg, p, ServeConfig(max_batch=4, max_new_tokens=8,
                                         max_len=208), device=dev)
        with dropped_pairs(ffn) as rec:
            outs[dev] = [r.out for r in srv.serve(
                [Request(i, pr) for i, pr in enumerate(prompts)])]
        drops[dev] = [d.cpu() for d in rec]
    same = outs["cpu"] == outs["cuda"]
    same_drops = len(drops["cpu"]) == len(drops["cuda"]) and all(
        torch.equal(a, b) for a, b in zip(drops["cpu"], drops["cuda"]))
    n_drop = [int(d.sum()) for d in drops["cuda"]]
    log(f"moe_wave cross-check: {cfg.name} reduced fp32, waves of 4 and 2 "
        f"(the first 800 tokens, one block), 6 requests x 8 tokens: card "
        f"tokens {'==' if same else '!='} CPU tokens; dropped pairs "
        f"{n_drop} on the card, {'==' if same_drops else '!='} the CPU's")
    if not same or not any(n_drop):
        fail(f"moe_wave cross-check: card {outs['cuda']} vs cpu "
             f"{outs['cpu']}; dropped pairs {n_drop}")
    return {"requests": len(prompts), "identical": same,
            "dropped_pairs": n_drop, "drops_identical": same_drops}


def kimi_cross_check(torch):
    """Reduced kimi-k2-1t-a32b at head_dim 112 (sub-channel chunks of
    28), GQA 8/1, fp32, INT4 SplitQuant, through the engine over an int8
    dynamic cache, 8 requests x 16 tokens, on the card (the fp32 decode
    and prefill kernels at D=112) and on the CPU: identical greedy
    tokens."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.tree import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg = dataclasses.replace(get_arch("kimi-k2-1t-a32b").reduced(),
                              head_dim_override=112, n_heads=8, n_kv_heads=1)
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
    log(f"kimi cross-check: {cfg.name} reduced at head_dim 112, GQA 8/1, "
        f"fp32, int8 KV (chunks of 28), 8 requests x 16 tokens: card tokens "
        f"{'==' if same else '!='} CPU tokens")
    if not same:
        fail(f"kimi cross-check: card {outs['cuda']} != cpu {outs['cpu']}")
    return {"requests": len(prompts), "identical": same}


# ------------------------------------- head_dim 256 and float16 caches ---
#: the cache modes of the attention kernels' head_dim-256 and float16
#: cases: int8 with per-entry or static scales, fp32, bf16 and float16
CACHE_MODES = ("dynamic", "static", "fp32", "bf16", "f16")


def _cache_in(torch, gen, mode, shape, C):
    """A cache of seeded bf16 K/V of ``shape`` (..., Hkv, D) in ``mode``:
    (k, v, scales, K and V as fp32 for SDPA). Static scales are (Hkv, C)
    from the values' own range."""
    from repro_torch.kernels.decode_attention import dequant_chunk
    from repro_torch.kernels.prefill_attention import (quantize_kv_ref,
                                                       quantize_kv_static_ref)
    k, v = (torch.randn(shape, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    if mode in ("fp32", "bf16", "f16"):
        dt = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "f16": torch.float16}[mode]
        k, v = k.to(dt), v.to(dt)
        return k, v, (), k.float(), v.float()
    if mode == "dynamic":
        (qk, ks, kz), (qv, vs, vz) = quantize_kv_ref(k, C), \
            quantize_kv_ref(v, C)
    else:
        (ks, kz), (vs, vz) = static_scales_of(torch, k, C), \
            static_scales_of(torch, v, C)
        qk, qv = quantize_kv_static_ref(k, ks, kz), \
            quantize_kv_static_ref(v, vs, vz)
    return qk, qv, (ks, kz, vs, vz), dequant_chunk(qk, ks, kz), \
        dequant_chunk(qv, vs, vz)


def _row_bytes(mode, D, C) -> int:
    """Bytes of one cache row of one kv-head, K and V, as the bound counts
    them (static scales are per-layer constants, counted once)."""
    return 2 * {"static": D, "dynamic": D + 2 * C * 4, "fp32": 4 * D,
                "bf16": 2 * D, "f16": 2 * D}[mode]


#: (arch, Hq, Hkv, D, cache modes) of the head_dim-256 and float16 cases
D256_F16_CASES = (("paligemma-3b", 8, 1, 256, CACHE_MODES),
                  ("stablelm-1.6b", 32, 32, 64, ("f16",)),
                  ("chatglm3-6b", 32, 2, 128, ("f16",)))


def d256_f16_attention_cases(torch, timer, drep, prep):
    """Decode attention (8 slots of 1024 rows) and prefill attention (a
    96-token chunk and a 4-row verify window at position 384 of a
    1024-row slot) at paligemma-3b's MQA 8/1 and head_dim 256 in every
    cache mode (int8 dynamic and static, fp32, bf16, float16), and at
    stablelm-1.6b's and chatglm3-6b's layouts over a float16 cache: each
    against its plain version, beside SDPA over the same K/V widened; the
    chunk's codes equal the plain quantizers'. The bound counts each live
    row of K and V once in the cache's type."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.prefill_attention import (
        prefill_attention, prefill_attention_ref, quantize_kv_ref,
        quantize_kv_static_ref, window_kv)
    gen = torch.Generator(device="cuda").manual_seed(13)
    N, T, C = 8, 1024, 4
    for arch, Hq, Hkv, D, modes in D256_F16_CASES:
        G = Hq // Hkv
        for mode in modes:
            q, _, _, kv_pos, q_pos, _ = _decode_inputs(torch, gen, N, T, Hq,
                                                       Hkv, D, C)
            ck, cv, sc, kd, vd = _cache_in(torch, gen, mode,
                                           (N, T, Hkv, D), C)
            got = decode_attention(q, ck, cv, kv_pos, q_pos, *sc)
            want = decode_attention_ref(q, ck, cv, kv_pos, q_pos, *sc)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()) or \
                    not bool((got[2] == 0).all()):
                fail(f"decode {arch} {mode}: non-finite output or non-zero "
                     f"empty slot")
            valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
            ks_, vs_ = (x.to(torch.bfloat16).transpose(1, 2)
                        .repeat_interleave(G, 1) for x in (kd, vd))
            lib = timer(lambda: F.scaled_dot_product_attention(
                q[:, :, None], ks_, vs_, attn_mask=valid[:, None, None, :]))
            E = int(valid.sum())
            nbytes = E * Hkv * _row_bytes(mode, D, C) + N * T * 4 + N * 4 + \
                2 * N * Hq * D * 2 + (4 * Hkv * C * 4 if mode == "static"
                                      else 0)
            drep.add(f"{arch} N={N} T={T} Hq={Hq} Hkv={Hkv} D={D} {mode} "
                     f"cache", max_err(got, want),
                     2 ** -7 * max(1.0, float(want.float().abs().max())),
                     timer(lambda: decode_attention(q, ck, cv, kv_pos, q_pos,
                                                    *sc)),
                     timer(lambda: decode_attention_ref(q, ck, cv, kv_pos,
                                                        q_pos, *sc)),
                     lib, nbytes, 4 * E * Hq * D)
            log_against_sdpa(drep, host_us(torch, lambda: decode_attention(
                q, ck, cv, kv_pos, q_pos, *sc)))

            pos_start = 384
            for Sq, verify in ((96, False), (4, True)):
                f = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                           device="cuda").to(torch.bfloat16)
                q, kn, vn = f(Sq, Hq, D), f(Sq, Hkv, D), f(Sq, Hkv, D)
                ck, cv, sc, kd, vd = _cache_in(torch, gen, mode,
                                               (T, Hkv, D), C)
                kv_pos = torch.full((T,), -1, dtype=torch.int32,
                                    device="cuda")
                kv_pos[:pos_start + 1] = torch.arange(
                    pos_start + 1, device="cuda", dtype=torch.int32)
                args = (q, kn, vn, ck, cv, kv_pos, pos_start, Sq, *sc)
                got, gaux = prefill_attention(*args, verify=verify)
                want = prefill_attention_ref(*args, verify=verify)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got).all()):
                    fail(f"prefill {arch} {mode}: non-finite output")
                if mode == "static":
                    waux = (quantize_kv_static_ref(kn, *sc[:2]),
                            quantize_kv_static_ref(vn, *sc[2:]))
                elif mode == "dynamic":
                    wk_, wv_ = quantize_kv_ref(kn, C), quantize_kv_ref(vn, C)
                    waux = (wk_[0], wv_[0], wk_[1], wk_[2], wv_[1], wv_[2])
                else:
                    waux = ()
                if len(gaux) != len(waux) or not all(
                        torch.equal(a, b) for a, b in zip(gaux, waux)):
                    fail(f"prefill {arch} {mode}: the chunk's codes differ "
                         f"from the plain quantizer's")
                wkd, wvd = window_kv(kn, vn, ck.dtype, sc, verify)
                lib = _sdpa_prefill(torch, timer, q, kd, vd, wkd, wvd,
                                    kv_pos, pos_start, Sq)
                Ec = int(((kv_pos >= 0) & (kv_pos < pos_start)).sum())
                pairs = Sq * (Sq + 1) // 2
                out = {"static": 2 * Sq * Hkv * D,
                       "dynamic": 2 * Sq * Hkv * (D + 2 * C * 4)}.get(mode,
                                                                     0)
                nbytes = Ec * Hkv * _row_bytes(mode, D, C) + T * 4 + \
                    2 * Sq * Hq * D * 2 + 2 * Sq * Hkv * D * 2 + out + \
                    (4 * Hkv * C * 4 if mode == "static" else 0)
                prep.add(f"{arch} {'verify ' if verify else ''}{mode} cache "
                         f"Sq={Sq} pos_start={pos_start} T={T} Hkv={Hkv} "
                         f"D={D}", max_err(got, want),
                         2 ** -7 * max(1.0, float(want.float().abs().max())),
                         timer(lambda: prefill_attention(*args,
                                                         verify=verify)),
                         timer(lambda: prefill_attention_ref(
                             *args, verify=verify)),
                         lib, nbytes, 4 * Hq * D * (Ec * Sq + pairs))
                log_against_sdpa(prep, host_us(
                    torch, lambda: prefill_attention(*args, verify=verify)))


# ---------------------------------------------------------------- VLM ---
@contextlib.contextmanager
def plain_calls():
    """Count the calls of the kernels' plain versions while inside (a CUDA
    tensor must never reach one: each wrapper launches or raises)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import splitquant_matmul as sqm
    from repro_torch.kernels import wkv_chunked as wk
    names = ((sqm, "splitquant_matmul_ref"),
             (sqm, "grouped_splitquant_matmul_ref"),
             (da, "decode_attention_ref"), (pa, "prefill_attention_ref"),
             (pa, "write_kv_rows_ref"), (pa, "quantize_kv_ref"),
             (pa, "quantize_kv_static_ref"), (wk, "wkv_chunked_ref"),
             (wk, "wkv_chunked_bwd_ref"))
    calls = dict.fromkeys((n for _, n in names), 0)
    orig = [(m, n, getattr(m, n)) for m, n in names]

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    for m, n, fn in orig:
        setattr(m, n, counting(n, fn))
    try:
        yield calls
    finally:
        for m, n, fn in orig:
            setattr(m, n, fn)


def no_plain(phase: str, calls: dict) -> None:
    if any(calls.values()):
        fail(f"{phase}: a CUDA tensor reached a plain version: {calls}")


def vlm_phase(torch, counters, card_line):
    """paligemma-3b at full width and depth (``vlm_smoke_workload``: 18
    layers, d_model 2048, MQA 8/1 at head_dim 256, geglu d_ff 16384, vocab
    257216, a tied head; SplitQuant INT4 k=3 built layer by layer on the
    card) through the engine over the int8 dynamic slot cache (chunks of
    64 columns), 16 requests of 32 tokens. Gates: ``serve_run``'s; one
    K/V write a layer and forward pass; the matmul and both attention
    kernels in their bf16 variants and the dynamic mode only, every
    attention and write launch over the int8 cache; no plain version
    called; finite logits at full width. Printed: build seconds and peak,
    deployed bytes, tokens/s, TTFT, decode-step and chunk p50, peak
    memory, launches by variant and mode. Returns (result, params)."""
    from repro_torch.launch.serve import build_params, vlm_smoke_workload
    cfg, ecfg, quant, warmup, prompts = vlm_smoke_workload()
    phase = "vlm"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, report = build_params(cfg, device="cuda", **quant)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    weight_bytes = torch.cuda.memory_allocated()
    log(f"{phase}: {cfg.name} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv-head of "
        f"{cfg.head_dim}, {cfg.ffn_type} d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"tied head, patch_proj {tuple(params['patch_proj'].shape)}): init + "
        f"SplitQuant INT4 k=3 of {len(report['quantized'])} matrices layer by "
        f"layer on the card in {t_build:.2f} s, build peak "
        f"{build_peak / 2**30:.2f} GiB; deployed "
        f"{report['deployed_bytes'] / 1e9:.3f} GB (the JAX count), "
        f"{weight_bytes / 2**30:.2f} GiB on the card [card: {card_line}]")
    with plain_calls() as plain:
        eng, fin, wall, launches = serve_run(torch, counters, phase, cfg,
                                             params, ecfg, warmup, prompts)
    no_plain(phase, plain)
    peak = torch.cuda.max_memory_allocated()
    if eng.cache.k.shape[-1] != 256:
        fail(f"{phase}: the cache's head_dim is {eng.cache.k.shape[-1]}")
    passes = eng.n_decode_steps + eng.n_prefill_chunks
    variants = only_variant(counters, "splitquant_matmul", phase)
    pvariants = only_variant(counters, "prefill_attention", phase)
    dvariants = only_variant(counters, "decode_attention", phase)
    modes = only_modes(counters, phase, {"dynamic"}, {"dynamic"})
    dtypes = cache_dtypes(phase, "int8")
    writes = one_write_per_layer(phase, cfg.n_layers, {"dynamic": passes})
    finite_logits(torch, phase, cfg, params, eng, fin)
    n_tok = sum(len(r.out) for r in fin)
    res = {"arch": cfg.name, "card": card_line, "head_dim": cfg.head_dim,
           "build_s": t_build, "build_peak_bytes": build_peak,
           "weight_bytes": weight_bytes,
           "deployed_bytes": report["deployed_bytes"],
           "quantized_leaves": len(report["quantized"]),
           "requests": len(fin), "new_tokens": n_tok,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_p50_s": percentile([r.ttft for r in fin], 50),
           "decode_step_p50_s": percentile(eng.decode_step_s, 50),
           "prefill_chunk_p50_s": percentile(eng.prefill_chunk_s, 50),
           "decode_steps": eng.n_decode_steps,
           "prefill_chunks": eng.n_prefill_chunks,
           "peak_mem_bytes": peak, "kv_cache_bytes": eng.cache.nbytes(),
           "launches": launches, "matmul_variants": variants,
           "prefill_variants": pvariants, "decode_variants": dvariants,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes, "cache_dtypes": dtypes,
           "plain_calls": plain, "outputs": [r.out for r in fin]}
    log(f"{phase}: {len(fin)} requests, {res['prompt_tokens']} prompt + "
        f"{n_tok} new tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} "
        f"tok/s; TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms; decode step p50 "
        f"{res['decode_step_p50_s'] * 1e3:.2f} ms; prefill chunk p50 "
        f"{res['prefill_chunk_p50_s'] * 1e3:.2f} ms; {eng.n_decode_steps} "
        f"decode steps, {eng.n_prefill_chunks} prefill chunks; peak memory "
        f"{peak / 2**30:.2f} GiB; KV cache {res['kv_cache_bytes'] / 2**20:.1f}"
        f" MiB; launches {launches}; matmul by variant {variants}; prefill "
        f"attention by variant {pvariants}, by mode "
        f"{modes['prefill_attention']}; decode attention by variant "
        f"{dvariants}, by mode {modes['decode_attention']} (all at head_dim "
        f"256); K/V writes by mode {writes} (one a layer and forward pass "
        f"over {cfg.n_layers} layers); plain versions called {plain} "
        f"[card: {card_line}]")
    del eng
    return res, params


#: the vlm_prefix phase's batch: prompts of this many tokens after the
#: 256 patch embeds
PREFIX_TOKENS = 32


def vlm_prefix_phase(torch, counters, params, card_line):
    """paligemma-3b at full width: one ``transformer.prefill`` of 8
    seeded prompts of :data:`PREFIX_TOKENS` tokens, each after 256 seeded
    patch embeds (bf16, numpy seed 0), into a cache of 256 + 32 rows.
    Gates: logits (8, 256 + 32, vocab) and finite; ``embed_inputs``
    alone launches the matmul once (``patch_proj``, K = 1152, M = 8 x
    256), the prefill 1 + 7 x 18 times, all ``bf16_wgmma``, and no other
    kernel (the prefill attends in plain PyTorch); no plain version
    called."""
    import numpy as np
    from repro_torch.launch.serve import vlm_smoke_workload
    from repro_torch.models import transformer
    cfg = vlm_smoke_workload()[0]
    phase = "vlm_prefix"
    rng = np.random.default_rng(0)
    B, P, S = 8, cfg.n_prefix_embeds, PREFIX_TOKENS
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                       device="cuda"),
             "patch_embeds": torch.as_tensor(rng.standard_normal(
                 (B, P, transformer.VLM_PATCH_DIM)).astype(np.float32),
                 device="cuda").to(torch.bfloat16)}
    transformer.prefill(params, cfg, batch, max_len=P + S)     # warm-up
    torch.cuda.synchronize()
    reset_counts(counters)
    x, _ = transformer.embed_inputs(params, cfg, batch)
    proj = counters["splitquant_matmul"].launches
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    with plain_calls() as plain:
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(params, cfg, batch,
                                            max_len=P + S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    no_plain(phase, plain)
    launches = launch_counts(counters)
    variants = only_variant(counters, "splitquant_matmul", phase)
    want = 1 + 7 * cfg.n_layers
    others = {n: c for n, c in launches.items() if n != "splitquant_matmul"}
    if proj != 1 or launches["splitquant_matmul"] != want or \
            any(others.values()):
        fail(f"{phase}: matmul launches {proj} for embed_inputs (want 1) "
             f"and {launches['splitquant_matmul']} for the prefill (want "
             f"{want}); other kernels {others}")
    if tuple(logits.shape) != (B, P + S, cfg.vocab) or \
            tuple(x.shape) != (B, P + S, cfg.d_model) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{phase}: logits {tuple(logits.shape)} (want "
             f"{(B, P + S, cfg.vocab)}) or non-finite")
    res = {"arch": cfg.name, "card": card_line, "batch": B,
           "patch_embeds": P, "tokens": S, "wall_s": wall,
           "tokens_per_s": B * (P + S) / wall,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "patch_proj_launches": proj,
           "matmul_variants": variants, "plain_calls": plain}
    log(f"{phase}: {cfg.name} full width, prefill of {B} prompts x ({P} patch "
        f"embeds + {S} tokens) in {wall * 1e3:.1f} ms "
        f"({res['tokens_per_s']:.0f} positions/s), logits "
        f"{tuple(logits.shape)} finite; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; patch_proj through the "
        f"matmul kernel ({proj} launch, K = {transformer.VLM_PATCH_DIM}); "
        f"launches {launches}, matmul by variant {variants} "
        f"[card: {card_line}]")
    del logits, cache, x
    return res


def vlm_wave_phase(torch, counters, params, card_line):
    """paligemma-3b at full width through the wave ``Server`` with its pad
    mask (the vlm workload's 16 requests in waves of 8, a bf16 ``KVCache``
    of 1024 rows, attention in plain PyTorch). Gates: every request its
    32 tokens; the matmul launched, only ``bf16_wgmma``, and no other
    kernel; no plain version called."""
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.launch.serve import vlm_smoke_workload
    from repro_torch.runtime.serve_loop import Request, Server, ServeConfig
    cfg, _, _, warmup, prompts = vlm_smoke_workload()
    phase = "vlm_wave"
    scfg = ServeConfig(max_batch=8, max_new_tokens=32, max_len=1024)
    Server(cfg, params, ServeConfig(max_batch=8, max_new_tokens=2,
                                    max_len=scfg.max_len),
           device="cuda").serve([Request(0, warmup)])
    srv = Server(cfg, params, scfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    with plain_calls() as plain:
        t0 = time.perf_counter()
        fin = srv.serve([Request(i, p) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    no_plain(phase, plain)
    launches = launch_counts(counters)
    variants = only_variant(counters, "splitquant_matmul", phase)
    if any(len(r.out) != scfg.max_new_tokens for r in fin) or \
            len(fin) != len(prompts) or \
            any(not 0 <= t < cfg.vocab for r in fin for t in r.out):
        fail(f"{phase}: expected {len(prompts)} requests x "
             f"{scfg.max_new_tokens} tokens in vocab, got "
             f"{[len(r.out) for r in fin]}")
    others = {n: c for n, c in launches.items() if n != "splitquant_matmul"}
    if any(others.values()) or pa.quantize_kv.launches or \
            pa.quantize_kv_static.launches:
        fail(f"{phase}: kernels off the path were launched: {others}")
    n_tok = sum(len(r.out) for r in fin)
    res = {"arch": cfg.name, "card": card_line, "requests": len(fin),
           "new_tokens": n_tok, "waves": len(srv.wave_prefill_s),
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "wave_prefill_p50_s": percentile(srv.wave_prefill_s, 50),
           "wave_prefill_s": srv.wave_prefill_s,
           "decode_step_p50_s": percentile(srv.decode_step_s, 50),
           "decode_steps": len(srv.decode_step_s),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "matmul_variants": variants,
           "plain_calls": plain, "outputs": [r.out for r in fin]}
    log(f"{phase}: {cfg.name} full width through the wave Server (pad mask), "
        f"waves of 8, bf16 KV cache of {scfg.max_len} rows; {len(fin)} "
        f"requests in {res['waves']} waves, {n_tok} new tokens in {wall:.3f} "
        f"s = {res['tokens_per_s']:.1f} tok/s; wave prefill "
        f"{[round(s * 1e3, 1) for s in srv.wave_prefill_s]} ms; decode step "
        f"p50 {res['decode_step_p50_s'] * 1e3:.2f} ms; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; launches {launches}; "
        f"matmul by variant {variants} [card: {card_line}]")
    return res


def engine_f16_phase(torch, counters, params, card_line):
    """stablelm-1.6b at full width over an fp slot cache in float16
    (``launch.serve.f16_cache_workload``), as ``engine_bf16``: every
    request its 32 tokens; every decode-attention, prefill-attention and
    K/V-write launch over the float16 cache in mode fp; one write a layer
    and forward pass; every matmul launch ``bf16_wgmma``."""
    from repro_torch.launch.serve import f16_cache_workload
    cfg, ecfg, _, warmup, prompts = f16_cache_workload()
    phase = "engine_f16"
    eng, fin, wall, launches = serve_run(torch, counters, phase, cfg, params,
                                         ecfg, warmup, prompts)
    if eng.cache.k.dtype != torch.float16:
        fail(f"{phase}: the cache is {eng.cache.k.dtype}, not float16")
    variants = only_variant(counters, "splitquant_matmul", phase)
    modes = only_modes(counters, phase, {"fp"}, {"fp"})
    dtypes = cache_dtypes(phase, "float16")
    writes = one_write_per_layer(
        phase, cfg.n_layers, {"fp": eng.n_decode_steps + eng.n_prefill_chunks})
    n_tok = sum(len(r.out) for r in fin)
    res = {"arch": cfg.name, "card": card_line, "kv_cache": "float16",
           "requests": len(fin), "new_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "ttft_p50_s": percentile([r.ttft for r in fin], 50),
           "decode_step_p50_s": percentile(eng.decode_step_s, 50),
           "prefill_chunk_p50_s": percentile(eng.prefill_chunk_s, 50),
           "decode_steps": eng.n_decode_steps,
           "prefill_chunks": eng.n_prefill_chunks,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "kv_cache_bytes": eng.cache.nbytes(), "launches": launches,
           "matmul_variants": variants,
           "decode_modes": modes["decode_attention"],
           "prefill_modes": modes["prefill_attention"],
           "write_modes": writes, "cache_dtypes": dtypes,
           "outputs": [r.out for r in fin]}
    log(f"{phase}: stablelm-1.6b full width over a float16 fp cache "
        f"({res['kv_cache_bytes'] / 2**30:.2f} GiB), {len(fin)} requests, "
        f"{n_tok} new tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} "
        f"tok/s; TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms; decode step p50 "
        f"{res['decode_step_p50_s'] * 1e3:.2f} ms; prefill chunk p50 "
        f"{res['prefill_chunk_p50_s'] * 1e3:.2f} ms; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; launches {launches}; by "
        f"cache dtype {dtypes}; K/V writes by mode {writes} (one a layer and "
        f"forward pass) [card: {card_line}]")
    return res


def _reduced_vlm(wide: bool):
    """Reduced paligemma-3b in fp32 (MQA 4/1 at head_dim 32), or its
    head_dim-256 variant (MQA 2/1, d_model 512), INT4 SplitQuant (seed
    0), on the CPU."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_params
    cfg = get_arch("paligemma-3b").reduced()
    if wide:
        cfg = dataclasses.replace(cfg, n_heads=2, n_kv_heads=1, d_model=512)
    return cfg, build_params(cfg, bits=4, method="splitquant", seed=0,
                             device="cpu")[0]


def vlm_cross_check(torch):
    """Reduced paligemma-3b (head_dim 32) and its head_dim-256 variant, in
    fp32, through the engine over an int8 dynamic cache, 8 requests x 16
    tokens, on the card and on the CPU: identical greedy tokens."""
    from repro_torch.tree import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import seeded_prompts
    res = {}
    for wide in (False, True):
        cfg, params = _reduced_vlm(wide)
        prompts = seeded_prompts(cfg.vocab, 8, 16, 200, seed=1)
        outs = {}
        for dev, p in (("cpu", params), ("cuda", tree_to(params, "cuda"))):
            eng = Engine(cfg, p, EngineConfig(
                n_slots=4, max_len=256, max_new_tokens=16, kv_mode="int8",
                prefill_chunk=96), device=dev)
            for pr in prompts:
                eng.submit(pr)
            outs[dev] = [r.out for r in eng.drain()]
        same = outs["cpu"] == outs["cuda"]
        log(f"vlm cross-check: {cfg.name} reduced at head_dim {cfg.head_dim}"
            f", MQA {cfg.n_heads}/1, fp32, int8 KV, 8 requests x 16 tokens: "
            f"card tokens {'==' if same else '!='} CPU tokens")
        if not same:
            fail(f"vlm cross-check (D={cfg.head_dim}): card {outs['cuda']} "
                 f"!= cpu {outs['cpu']}")
        res[f"D={cfg.head_dim}"] = {"requests": len(prompts),
                                    "identical": same}
    return res


#: the reduced prefix cross-check's tolerance: fp32 logits on the card
#: and the CPU, the same sums in another order, relative to their scale
PREFIX_TOL = 1e-4


def vlm_prefix_cross_check(torch):
    """Reduced paligemma-3b (and its head_dim-256 variant) in fp32:
    ``transformer.prefill`` of 4 prompts of 24 tokens after 8 seeded patch
    embeds, on the card and on the CPU: logits within
    :data:`PREFIX_TOL` of their scale."""
    import numpy as np
    from repro_torch.tree import tree_to
    from repro_torch.models import transformer
    res = {}
    for wide in (False, True):
        cfg, params = _reduced_vlm(wide)
        rng = np.random.default_rng(2)
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                        (4, 24))),
                 "patch_embeds": torch.as_tensor(rng.standard_normal(
                     (4, cfg.n_prefix_embeds, transformer.VLM_PATCH_DIM))
                     .astype(np.float32))}
        want = transformer.prefill(params, cfg, batch, max_len=40)[0]
        got = transformer.prefill(tree_to(params, "cuda"), cfg,
                                  {k: v.cuda() for k, v in batch.items()},
                                  max_len=40)[0].cpu()
        scale = max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max())
        log(f"vlm prefix cross-check: {cfg.name} reduced at head_dim "
            f"{cfg.head_dim}, fp32, 4 prompts x (8 patch embeds + 24 tokens): "
            f"logits {tuple(got.shape)} card vs CPU max abs err {err:.3e} "
            f"(tol {PREFIX_TOL * scale:.3e})")
        if got.shape != want.shape or not err <= PREFIX_TOL * scale:
            fail(f"vlm prefix cross-check (D={cfg.head_dim}): err {err}")
        res[f"D={cfg.head_dim}"] = {"max_abs_err": err,
                                    "tol": PREFIX_TOL * scale}
    return res


def vlm_wave_cross_check(torch):
    """Reduced paligemma-3b in fp32 (INT4) through the wave ``Server`` on
    the card and on the CPU, two left-padded waves of 4, one request with
    a budget of 1: identical greedy tokens."""
    import numpy as np
    from repro_torch.tree import tree_to
    from repro_torch.runtime.serve_loop import Request, Server, ServeConfig
    cfg, params = _reduced_vlm(False)
    rng = np.random.default_rng(5)
    lens = (40, 7, 23, 2, 31, 16, 9, 55)
    budgets = (None, None, 1, None, None, None, None, None)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in lens]
    outs = {}
    for dev, p in (("cpu", params), ("cuda", tree_to(params, "cuda"))):
        srv = Server(cfg, p, ServeConfig(max_batch=4, max_new_tokens=16,
                                         max_len=128), device=dev)
        outs[dev] = [r.out for r in srv.serve(
            [Request(i, pr, b) for i, (pr, b) in
             enumerate(zip(prompts, budgets))])]
    same = outs["cpu"] == outs["cuda"]
    log(f"vlm_wave cross-check: {cfg.name} reduced fp32, two waves of 4, 8 "
        f"requests x 16 tokens (one 1): card tokens {'==' if same else '!='} "
        f"CPU tokens")
    if not same or [len(o) for o in outs["cpu"]] != \
            [16, 16, 1, 16, 16, 16, 16, 16]:
        fail(f"vlm_wave cross-check: card {outs['cuda']} != cpu "
             f"{outs['cpu']}")
    return {"requests": len(prompts), "identical": same}


# ------------------------------------------------- bert-tiny, training ---
#: (name, K, N, M) of bert-tiny's quantized products in Table 1's
#: evaluation: an evaluation batch is 100 sequences of 64 tokens, so the
#: layers' projections see 6400 rows and the pooler and classifier 100
#: ([CLS] rows); N = 6 and 2 are the classifiers of the two tasks
BERT_SHAPES = (("wq/wk/wv/wo", 128, 128, 6400), ("w_up", 128, 512, 6400),
               ("w_down", 512, 128, 6400), ("pooler", 128, 128, 100),
               ("classifier emotion", 128, 6, 100),
               ("classifier spam", 128, 2, 100))


def bert_matmul_cases(torch, timer, rep):
    """The matmul's fp32 variant (``sq_matmul_fp32_kernel`` on the CUDA
    cores) at bert-tiny's shapes, bits 2, 4 and 8, k = 3 (SplitQuant) and
    1 (baseline), against its plain version (relative 1e-4 of the
    output's scale) and ``torch.matmul`` on the dequantized fp32 weight
    with TF32 off. The bound is the table's rule; the time of the same
    operations at the fp32 rate outside the tensor cores (67 TFLOP/s) is
    printed beside it (``fp32_core_ms``)."""
    from repro_torch.kernels.ref import (dequant_weight_ref,
                                         splitquant_matmul_ref)
    from repro_torch.kernels.splitquant_matmul import (CUDA_CORE,
                                                       splitquant_matmul)
    from repro_torch.kernels import splitquant_matmul as sqm
    gen = torch.Generator(device="cuda").manual_seed(7)
    before = sqm.splitquant_matmul.variant_launches[CUDA_CORE]
    n = 0
    for name, K, N, M in BERT_SHAPES:
        for bits in (2, 4, 8):
            for k in (3, 1):
                qp = torch.randint(0, 256, (K * bits // 8, N), generator=gen,
                                   dtype=torch.uint8, device="cuda")
                cp = random_packed_cids(torch, gen, (K // 4, N), k)
                recip = (torch.rand((k, N), generator=gen, device="cuda")
                         + 0.5) / 2 ** bits
                shift = torch.randn((k, N), generator=gen,
                                    device="cuda") * 0.05
                w = dequant_weight_ref(qp, cp, recip, shift, bits,
                                       torch.float32)
                x = torch.randn((M, K), generator=gen, device="cuda")
                got = splitquant_matmul(x, qp, cp, recip, shift, bits=bits,
                                        k=k)
                want = splitquant_matmul_ref(x, qp, cp, recip, shift, bits)
                torch.cuda.synchronize()
                n += 1
                if not bool(torch.isfinite(got).all()):
                    fail(f"bert matmul {name} int{bits} k={k}: non-finite")
                tol = 1e-4 * max(1.0, float(want.abs().max()))
                nbytes = M * K * 4 + K * N * bits / 8 + K * N / 4 + \
                    2 * k * N * 4 + M * N * 4
                ms = timer(lambda: splitquant_matmul(x, qp, cp, recip, shift,
                                                     bits=bits, k=k))
                rep.add(f"bert-tiny {name} M={M} K={K} N={N} fp32 "
                        f"int{bits} k={k}", max_err(got, want), tol, ms,
                        timer(lambda: splitquant_matmul_ref(
                            x, qp, cp, recip, shift, bits)),
                        timer(lambda: torch.matmul(x, w)), nbytes,
                        2 * M * K * N)
                c = rep.cases[-1]
                c["bound_share"] = c["bound_ms"] / ms
                log(f"  {'':18s} {'':44s} {100 * c['bound_share']:.1f}% of "
                    f"its bound ({c['bound_by']}); fp32-core ops time "
                    f"{c['fp32_core_ms']:.5f} ms; "
                    f"{c['library_ms'] / ms:.2f}x the speed of torch.matmul "
                    f"(fp32, TF32 off)")
    launched = sqm.splitquant_matmul.variant_launches[CUDA_CORE] - before
    if launched < 3 * n:                 # each case: check + warm-up + reps
        fail(f"bert matmul cases: {launched} fp32 launches for {n} cases")


#: Table 1's FP32 accuracy regime of each task (the data module's
#: targets: paper 90.2% and 98.4%), and how far the card's may be
TABLE1_FP32 = {"emotion": 0.90, "spam": 0.98}
TABLE1_FP32_SLACK = 0.05


def table1_phase(torch, counters, card_line):
    """The paper's Table 1 on the card at the JAX package's defaults
    (``launch.table1``: epochs 8, 4000 samples a task, seed 0, both
    tasks): bert-tiny fine-tuned by AdamW on each task's 3200 training
    examples, then evaluated on its 800 test examples in FP32 and
    quantized (weights and biases) at INT2/4/8 by the baseline and by
    SplitQuant, without and with the §4.2 activation quantization at 8
    bits (W{b}A8). Every count is set to 0 just before the run and read
    just after. Gates: the quantized evaluations launched the matmul, all
    of it ``fp32_cuda_core``, at each of bits 2, 4 and 8; no plain version
    called; FP32 accuracy within 5%p of each task's regime. Printed: the
    grid, the INT2 differences in %p, training steps/s, seconds. Returns
    (result, {task: (cfg, params, test split)})."""
    from repro_torch.kernels import splitquant_matmul as sqm
    from repro_torch.launch import table1 as t1
    phase = "table1"
    reset_counts(counters)
    with plain_calls() as plain:
        run = t1.run_table1(epochs=8, n_samples=4000, seed=0, verbose=False,
                            quantize_acts=(False, True))
    no_plain(phase, plain)
    results = {"weights": run.grids[False], "acts": run.grids[True]}
    train_s, steps = run.train_s, run.train_steps
    launches = launch_counts(counters)
    variants = dict(sqm.splitquant_matmul.variant_launches)
    by_bits = dict(sqm.splitquant_matmul.bits_launches)
    if not launches["splitquant_matmul"] or \
            variants[sqm.CUDA_CORE] != launches["splitquant_matmul"] or \
            any(by_bits[b] <= 0 for b in (2, 4, 8)):
        fail(f"{phase}: matmul launches {launches['splitquant_matmul']}, by "
             f"variant {variants}, by bits {by_bits}; expected fp32_cuda_core "
             f"only, at each of bits 2, 4 and 8")
    others = {n: v for n, v in launches.items()
              if n != "splitquant_matmul" and v}
    if others:
        fail(f"{phase}: other kernels launched {others}")
    for key, grid in (("weights", results["weights"]),
                      ("acts", results["acts"])):
        log(f"{phase} ({'W{b}A8' if key == 'acts' else 'weights only'}):")
        for name, row in grid.items():
            cells = "  ".join(
                f"INT{b} base {row[f'int{b}_baseline']:.4f} SQ "
                f"{row[f'int{b}_splitquant']:.4f} "
                f"({100 * (row[f'int{b}_splitquant'] - row[f'int{b}_baseline']):+.1f}%p)"
                for b in (2, 4, 8))
            log(f"  {name:8s} FP32 {row['fp32']:.4f}  {cells}")
    for name, row in results["weights"].items():
        if abs(row["fp32"] - TABLE1_FP32[name]) > TABLE1_FP32_SLACK:
            fail(f"{phase}: {name} FP32 accuracy {row['fp32']:.4f} is more "
                 f"than {TABLE1_FP32_SLACK} from {TABLE1_FP32[name]}")
    int2 = {name: 100 * (r["int2_splitquant"] - r["int2_baseline"])
            for name, r in results["weights"].items()}
    res = {"card": card_line, "grid": results["weights"],
           "grid_w_a8": results["acts"], "int2_diff_pp": int2,
           "splitquant_beats_baseline_at_int2": {
               n: d > 0 for n, d in int2.items()},
           "train_steps": steps, "train_s": train_s,
           "train_steps_per_s": steps / train_s, "launches": launches,
           "matmul_variants": variants, "bits_launches": by_bits,
           "plain_calls": plain,
           "markdown": t1.markdown(results["weights"]),
           "markdown_w_a8": t1.markdown(results["acts"])}
    log(f"{phase}: INT2 SplitQuant - baseline {int2} %p (weights only; "
        f"recorded, not gated); training {steps} steps in {train_s:.2f} s = "
        f"{res['train_steps_per_s']:.1f} steps/s; matmul launches "
        f"{launches['splitquant_matmul']} by variant {variants}, by bits "
        f"{by_bits}; plain versions called {plain} [card: {card_line}]")
    log(res["markdown"])
    log(res["markdown_w_a8"])
    return res, run.models


#: the card-against-CPU check of Table 1's quantized evaluation: accuracy
#: equal within this many of the 800 test examples, logits within this
#: share of their scale
TABLE1_ACC_SLACK = 2
TABLE1_LOGIT_TOL = 1e-4


def table1_cross_check(torch, kept):
    """The emotion task's trained bert-tiny quantized at INT2 by both
    methods on the card, evaluated on the card (the fp32 matmul kernel)
    and, the same trees copied, on the CPU (its plain version): accuracy
    equal within 2 of the 800 test examples, logits within 1e-4 x their
    scale."""
    from repro_torch.tree import tree_to
    from repro_torch.data.classification import batches
    from repro_torch.launch import table1 as t1
    from repro_torch.models import bert_tiny
    cfg, params, te = kept["emotion"]
    out = {}
    for method in ("baseline", "splitquant"):
        q = t1.quantize(params, 2, method, seed=0)
        qc = tree_to(q, "cpu")
        accs, errs = [], []
        for tree, dev in ((q, "cuda"), (qc, "cpu")):
            accs.append(t1.evaluate(cfg, tree, te))
        with torch.no_grad():
            for bg, bc in zip(batches(te, 100, train=False, device="cuda"),
                              batches(te, 100, train=False, device="cpu")):
                lg = bert_tiny.forward(q, cfg, bg).cpu()
                lc = bert_tiny.forward(qc, cfg, bc)
                errs.append(max_err(lg, lc) /
                            max(1.0, float(lc.abs().max())))
        n = len(te.labels)
        diff = round(abs(accs[0] - accs[1]) * n)
        out[method] = {"acc_card": accs[0], "acc_cpu": accs[1],
                       "examples_apart": diff, "logit_rel_err": max(errs)}
        log(f"table1_cross_check: emotion INT2 {method}: card {accs[0]:.4f} "
            f"vs CPU {accs[1]:.4f} ({diff} of {n} examples apart); logits "
            f"within {max(errs):.2e} of their scale")
        if diff > TABLE1_ACC_SLACK or max(errs) > TABLE1_LOGIT_TOL:
            fail(f"table1_cross_check {method}: {out[method]}")
    return out


def train_phase(torch, counters, card_line):
    """``launch.train.main`` on stablelm-1.6b at full width on the card:
    bf16 parameters, batch 8 x seq 128, 8 steps, every layer recomputed in
    the backward pass, fp32 AdamW states. Gates: every loss finite and the
    driver's final line printed; no quantized kernel launched (the weights
    are float). Printed: step-time p50, tokens/s, peak memory."""
    from repro_torch.launch import train as tl
    from repro_torch.tree import tree_leaves
    phase = "train"
    torch.cuda.empty_cache()
    reset_counts(counters)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tl.main(["--arch", "stablelm-1.6b", "--steps", "8", "--batch",
                       "8", "--seq", "128", "--opt-dtype", "float32"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    text = buf.getvalue().rstrip()
    log("\n".join(f"{phase}: {line}" for line in text.splitlines()))
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != 8 or not all(map(math.isfinite, losses)) or \
            not text.splitlines()[-1].startswith("final loss"):
        fail(f"{phase}: losses {losses}; last line {text.splitlines()[-1:]}")
    launches = launch_counts(counters)
    if any(launches.values()):
        fail(f"{phase}: kernels launched {launches}; the float weights take "
             f"none")
    steps = out["step_s"]
    p50 = percentile(steps, 50)
    n_params = sum(p.numel() for p in tree_leaves(out["params"]))
    res = {"card": card_line, "arch": "stablelm-1.6b", "batch": 8,
           "seq": 128, "steps": len(steps), "losses": losses,
           "step_s": steps, "step_p50_s": p50,
           "tokens_per_s": 8 * 128 / p50, "peak_mem_bytes": peak,
           "params": n_params, "launches": launches}
    log(f"{phase}: {n_params / 1e9:.3f} B params bf16, fp32 AdamW states; "
        f"step p50 {p50 * 1e3:.1f} ms (first {steps[0] * 1e3:.1f} ms), "
        f"{res['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; losses {[round(v, 4) for v in losses]} "
        f"[card: {card_line}]")
    del out
    torch.cuda.empty_cache()
    return res


#: the training cross-check's tolerance: losses of the card's run within
#: this share of the CPU's
TRAIN_LOSS_TOL = 1e-4


def train_cross_check(torch):
    """(1) Reduced stablelm-1.6b in fp32, 3 AdamW steps from the same
    seeded weights (drawn on the CPU, copied) and batches on the card and
    on the CPU: losses within 1e-4 relative. (2) bert-tiny through
    ``train_loop.run`` with a checkpoint every 3 steps and one injected
    failure at step 7, against an uninterrupted run: it restores step 6,
    replays and finishes, and its final params equal the uninterrupted
    run's exactly. Both runs take deterministic algorithms
    (``torch.use_deterministic_algorithms``, cuBLAS's workspace
    ``CUBLAS_WORKSPACE_CONFIG`` set before the card starts): the
    embedding's backward sums with atomics otherwise."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.data.classification import emotion_like
    from repro_torch.models import bert_tiny
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop
    from repro_torch.tree import tree_leaves, tree_to
    cfg = get_arch("stablelm-1.6b").reduced()
    oc = adamw.OptConfig(lr=1e-4, warmup_steps=0, total_steps=3)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    base = tt.init(cfg, seed=0, device="cpu")
    losses = {}
    for dev in ("cuda", "cpu"):
        params = tree_to(base, dev)
        opt = adamw.init(oc, params)
        step = train_loop.make_train_step(
            lambda p, b: tt.loss_fn(p, cfg, b, remat=True), oc)
        losses[dev] = []
        for s in range(3):
            params, opt, m = step(params, opt,
                                  synthetic_lm_batch(dc, s, device=dev))
            losses[dev].append(float(m["loss"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    log(f"train_cross_check: reduced stablelm fp32, 3 steps: card "
        f"{losses['cuda']} vs CPU {losses['cpu']} (max rel {rel:.2e})")
    if rel > TRAIN_LOSS_TOL:
        fail(f"train_cross_check: losses apart by {rel:.2e} relative")

    bcfg = get_arch("bert-tiny")
    ds = emotion_like(n_samples=320, seq_len=64, seed=0)
    ocb = adamw.OptConfig(lr=3e-4, total_steps=10, warmup_steps=2,
                          weight_decay=0.01)
    step = train_loop.make_train_step(
        lambda p, b: bert_tiny.loss_fn(p, bcfg, b), ocb)
    from repro_torch.data.classification import batches
    data = list(batches(ds, 32, seed=0, device="cuda"))
    init = tree_to(bert_tiny.init(bcfg, ds.n_classes, max_len=64,
                                  device="cpu"), "cuda")
    fired, logs = [], []

    def inject(s):
        if s == 7 and not fired:
            fired.append(s)
            raise RuntimeError("injected failure")
    torch.use_deterministic_algorithms(True)
    try:
        ref, _, _ = train_loop.run(
            train_loop.TrainLoopConfig(total_steps=10, log_every=100),
            step, init, adamw.init(ocb, init), lambda s: data[s],
            log=lambda *a: None)
        with tempfile.TemporaryDirectory() as d:
            got, opt, hist = train_loop.run(
                train_loop.TrainLoopConfig(total_steps=10, ckpt_dir=d,
                                           ckpt_every=3, ckpt_async=False,
                                           log_every=100),
                step, init, adamw.init(ocb, init), lambda s: data[s],
                inject_failure=inject, log=logs.append)
    finally:
        torch.use_deterministic_algorithms(False)
    leaves = tree_leaves
    equal = all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(ref)))
    worst = max(float((a - b).abs().max())
                for a, b in zip(leaves(got), leaves(ref)))
    log(f"train_cross_check: bert-tiny, failure injected at step 7: "
        f"{[m for m in logs if m.startswith('[')]}; {len(hist)} steps run, "
        f"final params equal to the uninterrupted run's: {equal} (max "
        f"diff {worst:.3e})")
    if fired != [7] or int(opt.step) != 10 or len(hist) != 11 or not equal \
            or sum(m.startswith("[failure]") for m in logs) != 1:
        fail(f"train_cross_check: recovery {logs}, {len(hist)} steps, "
             f"equal {equal}")
    return {"stablelm_losses": losses, "stablelm_max_rel": rel,
            "bert_recovery_log": logs, "bert_steps_run": len(hist),
            "bert_params_equal": equal, "bert_max_diff": worst}


RWKV_TRAIN_STEPS = 8


def rwkv_train_phase(torch, counters, card_line):
    """``launch.train.main`` on rwkv6-3b at full width on the card: bf16
    parameters, batch 8 x seq 128, 8 steps, every layer recomputed in the
    backward pass, fp32 AdamW states. The counts are set to 0 just before
    and read just after. Gates: every loss finite and the driver's final
    line printed; the forward WKV kernel launched twice a layer and step
    (the pass and remat's recompute), its backward once, no other kernel
    (the weights are float) and no plain version. Printed: step-time p50,
    tokens/s, peak memory."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as tl
    from repro_torch.tree import tree_leaves
    phase = "rwkv_train"
    cfg = get_arch("rwkv6-3b")
    torch.cuda.empty_cache()
    reset_counts(counters)
    buf = io.StringIO()
    with plain_calls() as plain, contextlib.redirect_stdout(buf):
        out = tl.main(["--arch", "rwkv6-3b", "--steps",
                       str(RWKV_TRAIN_STEPS), "--batch", "8", "--seq", "128",
                       "--opt-dtype", "float32"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    no_plain(phase, plain)
    text = buf.getvalue().rstrip()
    log("\n".join(f"{phase}: {line}" for line in text.splitlines()))
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != RWKV_TRAIN_STEPS or \
            not all(map(math.isfinite, losses)) or \
            not text.splitlines()[-1].startswith("final loss"):
        fail(f"{phase}: losses {losses}; last line {text.splitlines()[-1:]}")
    launches = launch_counts(counters)
    want = {n: 0 for n in launches}
    want["wkv_chunked"] = 2 * cfg.n_layers * RWKV_TRAIN_STEPS
    want["wkv_chunked_bwd"] = cfg.n_layers * RWKV_TRAIN_STEPS
    if launches != want:
        fail(f"{phase}: launches {launches}, expected {want} (remat "
             f"recomputes each layer's forward once)")
    steps = out["step_s"]
    p50 = percentile(steps, 50)
    n_params = sum(p.numel() for p in tree_leaves(out["params"]))
    res = {"card": card_line, "arch": cfg.name, "shape": _rwkv_shape(cfg),
           "batch": 8, "seq": 128, "steps": len(steps), "losses": losses,
           "step_s": steps, "step_p50_s": p50,
           "tokens_per_s": 8 * 128 / p50, "peak_mem_bytes": peak,
           "params": n_params, "launches": launches, "plain_calls": plain}
    log(f"{phase}: {cfg.name} full width ({_rwkv_shape(cfg)}), "
        f"{n_params / 1e9:.3f} B params bf16, fp32 AdamW states; step p50 "
        f"{p50 * 1e3:.1f} ms (first {steps[0] * 1e3:.1f} ms), "
        f"{res['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; WKV launches {launches['wkv_chunked']} "
        f"forward, {launches['wkv_chunked_bwd']} backward; losses "
        f"{[round(v, 4) for v in losses]} [card: {card_line}]")
    del out
    torch.cuda.empty_cache()
    return res


def rwkv_train_cross_check(torch):
    """(1) Reduced rwkv6 in fp32, 3 AdamW steps at seq 32 (the chunked
    branch: the WKV kernel and its backward on the card) from the same
    seeded weights (drawn on the CPU, copied) and batches on the card and
    on the CPU: losses within ``TRAIN_LOSS_TOL`` relative. (2) The same
    model through ``train_loop.run`` on the card for 10 steps with a
    checkpoint every 3 steps and one injected failure at step 7, against
    an uninterrupted run: it restores step 6, replays and finishes, and
    its final params equal the uninterrupted run's exactly, under
    deterministic algorithms (the WKV kernels are deterministic by
    construction; the embedding's backward is not otherwise)."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.kernels import wkv_chunked as wk
    from repro_torch.models import rwkv6
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop
    from repro_torch.tree import tree_leaves, tree_to
    cfg = get_arch("rwkv6-3b").reduced()
    oc = adamw.OptConfig(lr=1e-4, warmup_steps=0, total_steps=3)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    base = rwkv6.init(cfg, seed=0, device="cpu")
    loss_fn = lambda p, b: rwkv6.loss_fn(p, cfg, b, remat=True)  # noqa: E731
    losses = {}
    before = wk.wkv_chunked_bwd.launches
    for dev in ("cuda", "cpu"):
        params = tree_to(base, dev)
        opt = adamw.init(oc, params)
        step = train_loop.make_train_step(loss_fn, oc)
        losses[dev] = []
        for s in range(3):
            params, opt, m = step(params, opt,
                                  synthetic_lm_batch(dc, s, device=dev))
            losses[dev].append(float(m["loss"]))
    bwd = wk.wkv_chunked_bwd.launches - before
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    log(f"rwkv_train_cross_check: reduced rwkv6 fp32, 3 steps at seq 32: "
        f"card {losses['cuda']} vs CPU {losses['cpu']} (max rel {rel:.2e}); "
        f"backward kernel launches {bwd}")
    if rel > TRAIN_LOSS_TOL or bwd != 3 * cfg.n_layers:
        fail(f"rwkv_train_cross_check: losses apart by {rel:.2e} relative, "
             f"{bwd} backward launches (expected {3 * cfg.n_layers})")

    ocr = adamw.OptConfig(lr=3e-4, total_steps=10, warmup_steps=2,
                          weight_decay=0.01)
    step = train_loop.make_train_step(loss_fn, ocr)
    data = [synthetic_lm_batch(dc, s, device="cuda") for s in range(10)]
    init = tree_to(base, "cuda")
    fired, logs = [], []

    def inject(s):
        if s == 7 and not fired:
            fired.append(s)
            raise RuntimeError("injected failure")
    torch.use_deterministic_algorithms(True)
    try:
        ref, _, _ = train_loop.run(
            train_loop.TrainLoopConfig(total_steps=10, log_every=100),
            step, init, adamw.init(ocr, init), lambda s: data[s],
            log=lambda *a: None)
        with tempfile.TemporaryDirectory() as d:
            got, opt, hist = train_loop.run(
                train_loop.TrainLoopConfig(total_steps=10, ckpt_dir=d,
                                           ckpt_every=3, ckpt_async=False,
                                           log_every=100),
                step, init, adamw.init(ocr, init), lambda s: data[s],
                inject_failure=inject, log=logs.append)
    finally:
        torch.use_deterministic_algorithms(False)
    equal = all(torch.equal(a, b)
                for a, b in zip(tree_leaves(got), tree_leaves(ref)))
    worst = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(got), tree_leaves(ref)))
    log(f"rwkv_train_cross_check: reduced rwkv6 on the card, failure "
        f"injected at step 7: {[m for m in logs if m.startswith('[')]}; "
        f"{len(hist)} steps run, final params equal to the uninterrupted "
        f"run's: {equal} (max diff {worst:.3e})")
    if fired != [7] or int(opt.step) != 10 or len(hist) != 11 or not equal \
            or sum(m.startswith("[failure]") for m in logs) != 1:
        fail(f"rwkv_train_cross_check: recovery {logs}, {len(hist)} steps, "
             f"equal {equal}")
    return {"losses": losses, "max_rel": rel, "recovery_log": logs,
            "steps_run": len(hist), "params_equal": equal,
            "max_diff": worst}


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
    from repro_torch.kernels.act_quant import (act_split_quantize,
                                               act_split_quantize_static)
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.prefill_attention import (prefill_attention,
                                                       write_kv_rows)
    from repro_torch.kernels.splitquant_matmul import splitquant_matmul
    from repro_torch.kernels.wkv_chunked import wkv_chunked, wkv_chunked_bwd

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
    nvcc_out = io.StringIO()
    with contextlib.redirect_stdout(nvcc_out):
        lib_path = build.build(verbose=True)
    build.library()
    t_build = time.perf_counter() - t0
    log(nvcc_out.getvalue().rstrip())
    log(f"build: {lib_path.name} in {t_build:.1f} s")
    log_ptxas(nvcc_out.getvalue())

    timer = Timer(torch)
    tiny = torch.zeros(1, device="cuda")
    floor_ms = timer(tiny.zero_)
    log(f"timer floor: one launch that fills 4 bytes {floor_ms:.4f} ms")
    reps = {n: KernelReport(n) for n in TPU_KERNELS}
    log("kernels vs plain versions (bf16, main-path shapes):")
    t_kernels = time.perf_counter()
    matmul_cases(torch, timer, reps["splitquant_matmul"])
    bias_cases(torch, timer, reps["splitquant_matmul"])
    grouped_cases(torch, timer, reps["splitquant_matmul"])
    bert_matmul_cases(torch, timer, reps["splitquant_matmul"])
    decode_cases(torch, timer, reps["decode_attention"])
    decode_bf16_cases(torch, timer, reps["decode_attention"])
    prefill_cases(torch, timer, reps["prefill_attention"])
    prefill_mode_cases(torch, timer, reps["prefill_attention"])
    kv_write_cases(torch, timer, reps["kv_write"], reps["kv_write_static"])
    d256_f16_attention_cases(torch, timer, reps["decode_attention"],
                             reps["prefill_attention"])
    kv_write_cases(torch, timer, reps["kv_write"], reps["kv_write_static"],
                   archs=(("paligemma-3b", 1, 256),),
                   modes=WRITE_CASE_MODES + ("fp f16",))
    kv_write_cases(torch, timer, reps["kv_write"], reps["kv_write_static"],
                   archs=WRITE_ARCHS[:2], modes=("fp f16",),
                   standalone=False)
    wkv_cases(torch, timer, reps["wkv_chunked"])
    wkv_bwd_cases(torch, timer, reps["wkv_chunked_bwd"])
    counters = {"splitquant_matmul": splitquant_matmul,
                "act_split_quantize": act_split_quantize,
                "act_split_quantize_static": act_split_quantize_static,
                "prefill_attention": prefill_attention,
                "kv_write": write_kv_rows, "wkv_chunked": wkv_chunked,
                "decode_attention": decode_attention,
                "kv_write_static": write_kv_rows,
                "wkv_chunked_bwd": wkv_chunked_bwd}
    reset_counts(counters)
    aq_observed = act_quant_cases(torch, timer, reps["act_split_quantize"],
                                  reps["act_split_quantize_static"])
    aq_launches = {n: counters[n].launches for n, p in PATHS.items()
                   if not p}
    PHASE_S["kernels"] = time.perf_counter() - t_kernels
    log(f"phase kernels: {PHASE_S['kernels']:.1f} s")
    del timer       # its 512 MiB flush buffer is not the servers' memory

    from repro_torch.launch.serve import build_params, smoke_workload
    cfg, _, quant, _, _ = smoke_workload()
    t0 = time.perf_counter()
    params, report = build_params(cfg, device="cuda", **quant)
    torch.cuda.synchronize()
    log(f"stablelm-1.6b full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}): init + SplitQuant INT4 k=3 of "
        f"{len(report['quantized'])} matrices on the card in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({report['deployed_bytes'] / 2**20:.1f} MiB deployed)")
    eng = timed("engine", engine_phase, torch, counters, params)
    scales, t_cal = calibrate(torch, cfg, params, "cuda")
    log(f"static KV scales: collect_kv_stats over 4 seeded prompts of 256 "
        f"tokens on the card in {t_cal:.2f} s")
    sta = timed("static", engine_phase, torch, counters, params,
                kv_scales=scales)
    log(f"static vs dynamic scales: tokens/s {sta['tokens_per_s']:.1f} vs "
        f"{eng['tokens_per_s']:.1f}; TTFT p50 {sta['ttft_p50_s'] * 1e3:.1f} vs "
        f"{eng['ttft_p50_s'] * 1e3:.1f} ms; decode step p50 "
        f"{sta['decode_step_p50_s'] * 1e3:.2f} vs "
        f"{eng['decode_step_p50_s'] * 1e3:.2f} ms; peak memory "
        f"{sta['peak_mem_bytes'] / 2**30:.2f} vs "
        f"{eng['peak_mem_bytes'] / 2**30:.2f} GiB; KV cache "
        f"{sta['kv_cache_bytes'] / 2**20:.1f} vs "
        f"{eng['kv_cache_bytes'] / 2**20:.1f} MiB")
    cha = timed("chaos", chaos_phase, torch, counters, params, eng,
                card_line)
    obs = timed("observe", observe_phase, torch, counters, params, cha,
                card_line)
    recv = timed("recovery", recovery_phase, torch, counters, params,
                 scales, sta, card_line)
    spec = timed("spec", spec_phase, torch, counters, params, scales, sta)
    dense = timed("dense_wave", dense_wave_phase, torch, counters, params,
                  card_line)
    bf16 = timed("engine_bf16", engine_bf16_phase, torch, counters, params,
                 card_line)
    f16 = timed("engine_f16", engine_f16_phase, torch, counters, params,
                card_line)
    one = timed("oneshot", oneshot_phase, torch, counters, params, card_line)
    samp = timed("sampling", sampling_phase, torch, counters, params,
                 card_line)
    del params
    torch.cuda.empty_cache()
    rec = timed("recipe", recipe_phase, torch, counters, card_line)
    torch.cuda.empty_cache()
    pq = timed("percentile_quant", percentile_phase, torch, card_line)
    vlm, vlm_params = timed("vlm", vlm_phase, torch, counters, card_line)
    vpre = timed("vlm_prefix", vlm_prefix_phase, torch, counters,
                 vlm_params, card_line)
    vwave = timed("vlm_wave", vlm_wave_phase, torch, counters, vlm_params,
                  card_line)
    del vlm_params
    torch.cuda.empty_cache()
    moe, moe_params = timed("moe", moe_phase, torch, counters, card_line)
    mspec = timed("moe_spec", moe_spec_phase, torch, counters, moe_params,
                  moe, card_line)
    mwave = timed("moe_wave", moe_wave_phase, torch, counters, moe_params,
                  card_line)
    del moe_params             # moonshot's trees before kimi's build
    torch.cuda.empty_cache()
    kimi = timed("kimi", kimi_phase, torch, counters, card_line)
    torch.cuda.empty_cache()
    t1, t1_kept = timed("table1", table1_phase, torch, counters, card_line)
    train = timed("train", train_phase, torch, counters, card_line)
    rtrain = timed("rwkv_train", rwkv_train_phase, torch, counters,
                   card_line)
    t1xc = timed("table1_cross_check", table1_cross_check, torch, t1_kept)
    del t1_kept
    trxc = timed("train_cross_check", train_cross_check, torch)
    rtrxc = timed("rwkv_train_cross_check", rwkv_train_cross_check, torch)
    xc = timed("cross_check", cross_check, torch)
    sxc = timed("spec_cross_check", spec_cross_check, torch)
    dxc = timed("dense_wave_cross_check", dense_wave_cross_check, torch)
    oxc = timed("options_cross_check", options_cross_check, torch)
    mxc = timed("moe_cross_check", moe_cross_check, torch)
    msxc = timed("moe_spec_cross_check", moe_spec_cross_check, torch)
    mwxc = timed("moe_wave_cross_check", moe_wave_cross_check, torch)
    kxc = timed("kimi_cross_check", kimi_cross_check, torch)
    vxc = timed("vlm_cross_check", vlm_cross_check, torch)
    vpxc = timed("vlm_prefix_cross_check", vlm_prefix_cross_check, torch)
    vwxc = timed("vlm_wave_cross_check", vlm_wave_cross_check, torch)
    from repro_torch.launch.serve import (griffin_smoke_workload,
                                          rwkv_smoke_workload)
    from repro_torch.models import griffin, rwkv6
    rwkv = timed("rwkv", wave_phase, torch, counters, "rwkv6",
                 rwkv_smoke_workload, rwkv6, _rwkv_shape, _wave_kernels,
                 card_line)[0]             # rwkv6's weights not kept
    rxc = timed("rwkv_cross_check", rwkv_cross_check, torch)
    torch.cuda.empty_cache()
    grif, grif_params = timed("griffin", wave_phase, torch, counters,
                              "griffin", griffin_smoke_workload, griffin,
                              _griffin_shape, _only_matmul, card_line)
    gring = timed("griffin_ring", griffin_ring_phase, torch, counters,
                  grif_params, card_line)
    del grif_params
    torch.cuda.empty_cache()
    whis = timed("whisper", whisper_phase, torch, counters, card_line)
    gxc = timed("griffin_cross_check", griffin_cross_check, torch)
    wxc = timed("whisper_cross_check", whisper_cross_check, torch)

    serving = {"engine": eng, "static": sta, "spec": spec,
               "engine_bf16": bf16, "oneshot": one, "sampling": samp,
               "recipe": rec, "chaos": cha, "recovery": recv,
               "observe": obs, "moe": moe, "moe_spec": mspec, "kimi": kimi,
               "engine_f16": f16, "vlm": vlm}
    runs = {"engine": eng["launches"], "static": sta["launches"],
            "spec": spec["launches"], "dense_wave": dense["launches"],
            "wave": rwkv["launches"], "engine_bf16": bf16["launches"],
            "oneshot": one["launches"], "sampling": samp["launches"],
            "recipe": rec["launches"], "chaos": cha["launches"],
            "recovery": recv["launches"], "observe": obs["launches"],
            "moe": moe["launches"], "moe_spec": mspec["launches"],
            "moe_wave": mwave["launches"], "kimi": kimi["launches"],
            "engine_f16": f16["launches"], "vlm": vlm["launches"],
            "vlm_prefix": vpre["launches"], "vlm_wave": vwave["launches"],
            "table1": t1["launches"], "train": train["launches"],
            "rwkv_train": rtrain["launches"], "griffin": grif["launches"], "griffin_ring": gring["launches"],
            "whisper": whis["launches"]}
    by_dtype = {"engine_bf16": bf16["cache_dtypes"],
                "engine_f16": f16["cache_dtypes"], "vlm": vlm["cache_dtypes"],
                "oneshot": one["cache_dtypes"],
                "sampling": samp["engine"]["cache_dtypes"]}
    extra = {"splitquant_matmul": {"launches_by_variant": {
        "engine": eng["matmul_variants"], "static": sta["matmul_variants"],
        "dense_wave": dense["matmul_variants"],
        "wave": rwkv["matmul_variants"],
        "engine_bf16": bf16["matmul_variants"],
        "oneshot": one["matmul_variants"],
        "recipe": rec["matmul_variants"],
        "chaos": cha["matmul_variants"],
        "recovery": recv["matmul_variants"],
        "observe": obs["matmul_variants"],
        "moe": moe["matmul_variants"], "moe_spec": mspec["matmul_variants"],
        "moe_wave": mwave["matmul_variants"],
        "kimi": kimi["matmul_variants"],
        "engine_f16": f16["matmul_variants"], "vlm": vlm["matmul_variants"],
        "vlm_prefix": vpre["matmul_variants"],
        "vlm_wave": vwave["matmul_variants"],
        "table1": t1["matmul_variants"],
        "griffin": grif["matmul_variants"],
        "griffin_ring": gring["matmul_variants"],
        "whisper": whis["matmul_variants"]},
        "launches_by_bits": {"recipe": rec["bits_launches"],
                             "moe_spec": mspec["bits_launches"],
                             "table1": t1["bits_launches"]}},
        "prefill_attention": {"launches_by_variant": {
            "engine": eng["prefill_variants"],
            "static": sta["prefill_variants"],
            "chaos": cha["prefill_variants"],
            "recovery": recv["prefill_variants"],
            "observe": obs["prefill_variants"],
            "moe": moe["prefill_variants"],
            "kimi": kimi["prefill_variants"],
            "vlm": vlm["prefill_variants"]},
            "launches_by_mode": {k: r["prefill_modes"]
                                 for k, r in serving.items()},
            "launches_by_cache_dtype": {k: d["prefill_attention"]
                                        for k, d in by_dtype.items()}},
        "decode_attention": {"launches_by_variant": {
            "engine": eng["decode_variants"],
            "static": sta["decode_variants"],
            "chaos": cha["decode_variants"],
            "recovery": recv["decode_variants"],
            "observe": obs["decode_variants"],
            "moe": moe["decode_variants"],
            "kimi": kimi["decode_variants"],
            "vlm": vlm["decode_variants"]},
            "launches_by_mode": {k: r["decode_modes"]
                                 for k, r in serving.items()},
            "launches_by_cache_dtype": {k: d["decode_attention"]
                                        for k, d in by_dtype.items()}}}
    for n, ms in WRITE_NAMES.items():
        extra[n] = {"launches_by_mode": {
            k: {m: r["write_modes"][m] for m in ms}
            for k, r in serving.items() if k in PATHS[n]}}
    extra["kv_write"]["launches_by_cache_dtype"] = {
        k: d["kv_write"] for k, d in by_dtype.items()}
    kernels = [reps[n].entry(
        {p: runs[p][n] for p in PATHS[n]} or {"kernel phase": aq_launches[n]},
        **extra.get(n, {}))
        for n in TPU_KERNELS]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card_line, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_s": t_build,
         "timer_floor_ms": floor_ms, "engine": eng,
         "static": sta, "spec": spec, "static_calibration_s": t_cal,
         "cross_check": xc, "spec_cross_check": sxc, "dense_wave": dense,
         "dense_wave_cross_check": dxc, "rwkv6": rwkv,
         "rwkv6_cross_check": rxc, "engine_bf16": bf16, "oneshot": one,
         "sampling": samp, "recipe": rec, "percentile_quant": pq,
         "options_cross_check": oxc, "chaos": cha, "recovery": recv,
         "observe": obs, "moe": moe, "moe_cross_check": mxc,
         "moe_spec": mspec, "moe_spec_cross_check": msxc,
         "moe_wave": mwave, "moe_wave_cross_check": mwxc, "kimi": kimi,
         "kimi_cross_check": kxc, "engine_f16": f16, "vlm": vlm,
         "vlm_prefix": vpre, "vlm_wave": vwave, "vlm_cross_check": vxc,
         "vlm_prefix_cross_check": vpxc, "vlm_wave_cross_check": vwxc,
         "table1": t1, "table1_cross_check": t1xc, "train": train,
         "train_cross_check": trxc, "rwkv_train": rtrain,
         "rwkv_train_cross_check": rtrxc, "griffin": grif,
         "griffin_ring": gring, "whisper": whis,
         "griffin_cross_check": gxc, "whisper_cross_check": wxc,
         "phase_s": PHASE_S,
         "act_quant_observed": aq_observed,
         "kernels": kernels,
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
