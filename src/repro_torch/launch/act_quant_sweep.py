"""Time the dynamic act-quant kernel at every plan of its launcher, on the
card.

    python -m repro_torch.launch.act_quant_sweep [--out chiprun_out]

At rwkv6-3b's activation widths (a wave of 2048 rows at 2560 and 8960
columns, 4 chunks) in bf16, and at 8960 in fp32, it runs the kernel with
each of the 16 (warps a (row, chunk), 16-byte vectors a lane) plans the
launcher takes, checks codes, scales and zeros against the plain version
(every plan is exact: a plan too small for a chunk takes rounds), and
times it (CUDA events, L2 flushed before each launch, median of 20
after 3 warm-ups). This is the measurement behind
:func:`~repro_torch.kernels.act_quant.dynamic_plan`. Writes
``act_quant_sweep.json`` under ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from ..kernels import act_quant as aq
from .matmul_sweep import median_ms

CASES = ((2560, torch.bfloat16), (8960, torch.bfloat16),
         (8960, torch.float32))
ROWS, N_CHUNKS = 2048, 4
SIZES = (1, 2, 4, 8)


def sweep() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for N, dtype in CASES:
        x = (torch.randn((ROWS, N), generator=gen, device="cuda") *
             2).to(dtype)
        want = aq.act_split_quantize_ref(x, bits=8, n_chunks=N_CHUNKS)
        plan = aq.dynamic_plan(N // N_CHUNKS, x.element_size())
        row = {"N": N, "dtype": str(dtype).split(".")[1], "plan": list(plan)}
        for w in SIZES:
            for v in SIZES:
                got = aq.launch_dynamic(x, 8, N_CHUNKS, (w, v))
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError(f"plan ({w}, {v}) at N={N} "
                                       f"{dtype} is not exact")
                row[f"ms@{w}x{v}"] = median_ms(
                    lambda p=(w, v): aq.launch_dynamic(x, 8, N_CHUNKS, p),
                    flush)
        rows.append(row)
        best = sorted((row[f"ms@{w}x{v}"], w, v) for w in SIZES
                      for v in SIZES)
        print(f"N={N} {row['dtype']}: plan {tuple(row['plan'])} "
              f"{row['ms@%dx%d' % tuple(row['plan'])]:.4f} ms; fastest "
              + ", ".join(f"({w}, {v}) {t:.4f}" for t, w, v in best[:4]),
              flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("act_quant_sweep times a kernel on a CUDA card; "
                         "none found")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    rows = sweep()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "act_quant_sweep.json").write_text(json.dumps(
        {"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
