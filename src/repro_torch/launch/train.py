"""Training driver of the port (``repro.launch.train``): seeded random
parameters of a decoder family, AdamW, the synthetic LM stream through
the prefetcher, and the fault-tolerant loop with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --reduced --steps 20 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --steps 8 --batch 8 --seq 128          # full width, on the card

The order is the JAX driver's: init, AdamW init, ``synthetic_lm_batch``
through ``Prefetcher``, ``train_loop.run``, and the final line ``final
loss … (start …)``; every layer is recomputed in the backward pass
(``remat``). The dense, MoE and VLM families train (a VLM on text
batches), and so do griffin (the hybrid family) and rwkv6 (the ssm family:
its time-mix through the WKV kernel and its backward kernel on the card),
as in the JAX launcher, which trains every family whose ``loss_fn`` takes
``synthetic_lm_batch``.
Without ``--device`` the run takes the card and raises when there is
none. It prints the loop's step time (the wall between step
starts, each step waited for on the card), tokens/s and, on the card,
the peak memory.

Not ported: ``--production-mesh`` (a device mesh; sharding is ROADMAP
queue 1 item 6). whisper-tiny (audio) does not train: the LM batch
carries no ``frames``, which its forward needs. bert-tiny trains
on classification batches in :mod:`repro_torch.launch.table1`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch
from ..data import DataConfig, Prefetcher, synthetic_lm_batch
from ..device import resolve_device
from ..models import get_model
from ..models.transformer import FAMILIES
from ..optim import adamw
from ..runtime import train_loop

#: the families trained here on synthetic LM batches
TRAINED = FAMILIES + ("hybrid", "ssm")

#: why a family does not train here
NOT_TRAINED = {
    "audio": "whisper-tiny's forward needs the stub frontend's frames, "
             "which the synthetic LM batch does not carry",
    "encoder": "bert-tiny trains on classification batches: "
               "python -m repro_torch.launch.table1",
}


def main(argv=None) -> dict:
    """Run the driver; returns {"params", "opt_state", "history",
    "step_s"} (the loop's wall between step starts, seconds)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", default=None, choices=[None, "int8"])
    ap.add_argument("--opt-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card, raising without "
                         "one)")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: the device mesh and its shardings are not "
            "ported (ROADMAP queue 1 item 6, sharding)")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family not in TRAINED:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) does not train in the port: "
            f"{NOT_TRAINED.get(cfg.family, 'not ported')}")
    device = resolve_device(args.device)
    model = get_model(cfg)

    opt_cfg = adamw.OptConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=min(100, args.steps // 10 + 1),
                              state_dtype=args.opt_dtype,
                              grad_compress=args.grad_compress)

    def loss_fn(p, b):
        return model.loss_fn(p, cfg, b, remat=True)

    params = model.init(cfg, seed=0, device=device)
    opt_state = adamw.init(opt_cfg, params)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    step_fn = train_loop.make_train_step(loss_fn, opt_cfg)
    starts = []

    def timed_step(p, o, b):
        starts.append(time.perf_counter())
        return step_fn(p, o, b)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    pre = Prefetcher(lambda step: synthetic_lm_batch(dc, step, device=device),
                     0, depth=2)
    lc = train_loop.TrainLoopConfig(total_steps=args.steps,
                                    ckpt_dir=args.ckpt_dir,
                                    ckpt_every=args.ckpt_every)
    params, opt_state, hist = train_loop.run(lc, timed_step, params,
                                             opt_state, pre.get)
    starts.append(time.perf_counter())
    pre.stop()
    step_s = list(np.diff(starts))
    if step_s:
        p50 = float(np.median(step_s))
        peak = (f", peak memory "
                f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
                if device.type == "cuda" else "")
        print(f"steps {len(step_s)}: step p50 {p50 * 1e3:.1f} ms, "
              f"{args.batch * args.seq / p50:.0f} tokens/s{peak}")
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(start {hist[0]['loss']:.4f})")
    return {"params": params, "opt_state": opt_state, "history": hist,
            "step_s": step_s}


if __name__ == "__main__":
    main()
