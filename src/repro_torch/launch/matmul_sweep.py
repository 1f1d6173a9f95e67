"""Time the SplitQuant matmul at the serving shapes for several K-split
targets, on the card.

    python -m repro_torch.launch.matmul_sweep [--out chiprun_out]

For every quantized matrix shape of stablelm-1.6b's engine and rwkv6-3b's
wave loop, at the row counts of a decode step (8), a prompt chunk (96)
and a wave prefill (2048), it times the bf16 kernel (CUDA events, L2
flushed before each launch, median of 20 after 3 warm-ups) with the plan
aiming its K splits at 1, 2, 3 and 4 blocks per SM, and bf16
``torch.matmul`` on the dequantized weight beside it. This is the
measurement behind :func:`~repro_torch.kernels.splitquant_matmul.blocks_per_sm`.
Writes ``matmul_sweep.json`` under ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from ..kernels import splitquant_matmul as sqm
from ..kernels.packing import pack_cids
from ..kernels.ref import dequant_weight_ref

SHAPES = {"stablelm-1.6b": ((2048, 2048), (2048, 5632), (5632, 2048),
                            (2048, 100352)),
          "rwkv6-3b": ((2560, 2560), (2560, 8960), (8960, 2560),
                       (2560, 65536))}
ROWS = (8, 96, 2048)
TARGETS = (1, 2, 3, 4)


def median_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in pairs)[reps // 2]


def sweep() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = sqm.blocks_per_sm
    rows = []
    try:
        for arch, shapes in SHAPES.items():
            for K, N in shapes:
                qp = torch.randint(0, 256, (K // 2, N), generator=gen,
                                   dtype=torch.uint8, device="cuda")
                cp = pack_cids(torch.randint(0, 3, (K, N), generator=gen,
                                             device="cuda").to(torch.uint8))
                recip = (torch.rand((3, N), generator=gen,
                                    device="cuda") + 0.5) / 16
                shift = torch.randn((3, N), generator=gen, device="cuda") * 0.05
                w = dequant_weight_ref(qp, cp, recip, shift, 4, torch.bfloat16)
                for M in ROWS:
                    x = torch.randn((M, K), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    row = {"arch": arch, "M": M, "K": K, "N": N,
                           "torch_matmul_ms": median_ms(
                               lambda: torch.matmul(x, w), flush),
                           "chosen_blocks_per_sm": chosen(sqm.TENSOR_CORE, M)}
                    for t in TARGETS:
                        sqm.blocks_per_sm = lambda variant, m, t=t: t
                        sqm.plan.cache_clear()
                        row[f"splits@{t}"] = sqm.plan(M, K, N, torch.bfloat16,
                                                      sms).splits
                        row[f"ms@{t}"] = median_ms(
                            lambda: sqm.splitquant_matmul(
                                x, qp, cp, recip, shift, bits=4, k=3), flush)
                    sqm.blocks_per_sm = chosen
                    sqm.plan.cache_clear()
                    rows.append(row)
                    print(f"{arch:14s} M={M:5d} K={K:5d} N={N:6d} torch.matmul "
                          f"{row['torch_matmul_ms']:.4f} ms | " + " | ".join(
                              f"{t}/SM ({row[f'splits@{t}']} splits) "
                              f"{row[f'ms@{t}']:.4f}" for t in TARGETS),
                          flush=True)
    finally:
        sqm.blocks_per_sm = chosen
        sqm.plan.cache_clear()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("matmul_sweep times kernels on a CUDA card; none found")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    rows = sweep()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "matmul_sweep.json").write_text(json.dumps(
        {"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
