"""The paper's Table 1 on the port (the counterpart of the JAX package's
``benchmarks/table1.py`` and ``examples/reproduce_bert_tiny.py``):
bert-tiny x {emotion-like 6-way, spam-like binary} x {FP32, INT2/4/8} x
{baseline PTQ, SplitQuant}.

    PYTHONPATH=src python -m repro_torch.launch.table1 --device cpu \\
        --epochs 1 --samples 500        # a tiny run on the CPU
    PYTHONPATH=src python -m repro_torch.launch.table1  # the card
    PYTHONPATH=src python -m repro_torch.launch.table1 --quantize-acts

Without ``--device`` it runs on the card at the JAX package's defaults
(8 epochs, 4000 examples a task, seed 0) and raises when there is none.

The datasets are synthetic (:mod:`repro_torch.data.classification`: the
paper's HF checkpoints and datasets are not downloadable), made from a
numpy seed, so the claim reproduced is the paper's causal one: SplitQuant
recovers low-bit accuracy, less so as the bits grow. bert-tiny is
fine-tuned by AdamW from seeded random weights, then quantized weights
and biases and all (``quantize_tree``). A quantized tree is evaluated as
it is quantized: its packed matrices go through ``dense`` and the
SplitQuant matmul (fp32, the CUDA-core kernel on the card) and its
quantized biases are added dequantized; the JAX package evaluates
``dequantize_tree`` of it, the same logits up to fp32 summation order.
``--quantize-acts`` adds the §4.2 activation quantization at 8 bits
(W{b}A8): 3 chunks a range for SplitQuant, one range for the baseline.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_arch
from ..core.apply import QuantPolicy, quantize_tree
from ..core.quantize import QuantConfig
from ..data.classification import (ClsDataset, batches, emotion_like, split,
                                   spam_like)
from ..device import resolve_device
from ..models import bert_tiny
from ..optim import adamw
from ..runtime.train_loop import make_train_step

DATASETS = (("emotion", emotion_like), ("spam", spam_like))
BITS = (2, 4, 8)
#: examples a fine-tuning step
TRAIN_BATCH = 32


def train_bert(ds: ClsDataset, *, epochs=4, batch_size=TRAIN_BATCH, lr=3e-4,
               seed=0, device=None):
    """Fine-tune bert-tiny (seeded init) on ``ds`` with AdamW (warmup 50,
    weight decay 0.01), a shuffled batch a step, on ``device`` (the card
    unless ``device="cpu"``). Returns (cfg, params)."""
    device = resolve_device(device)
    cfg = get_arch("bert-tiny")
    params = bert_tiny.init(cfg, ds.n_classes, max_len=ds.seq_len,
                            seed=seed, device=device)
    steps = (ds.tokens.shape[0] // batch_size) * epochs
    opt_cfg = adamw.OptConfig(lr=lr, total_steps=steps, warmup_steps=50,
                              weight_decay=0.01)
    opt = adamw.init(opt_cfg, params)
    step = make_train_step(lambda p, b: bert_tiny.loss_fn(p, cfg, b),
                           opt_cfg)
    for b in batches(ds, batch_size, seed=seed, epochs=epochs,
                     device=device):
        params, opt, _ = step(params, opt, b)
    return cfg, params


@torch.no_grad()
def evaluate(cfg, params, ds: ClsDataset, *, batch_size=100,
             act_cfg: QuantConfig | None = None, act_chunks=1) -> float:
    """Accuracy of ``params`` (dense or quantized) on ``ds`` in batches of
    ``batch_size`` on the device the parameters live on."""
    device = params["embed"].device
    correct = total = 0
    for b in batches(ds, batch_size, train=False, device=device):
        logits = bert_tiny.forward(params, cfg, b, act_quant=act_cfg,
                                   act_chunks=act_chunks)
        correct += int((logits.argmax(-1) == b["labels"]).sum())
        total += b["labels"].shape[0]
    return correct / total


def quantize(params, bits: int, method: str, seed=0):
    """The tree quantized at ``bits`` by ``method`` (k = 3 for
    SplitQuant), biases included."""
    policy = QuantPolicy(cfg=QuantConfig(bits=bits), method=method, k=3)
    return quantize_tree(params, policy, seed=seed)[0]


def act_quant(bits: int, method: str, quantize_acts: bool):
    """(act_cfg, act_chunks) of the W{bits}A8 convention, or (None, 1)."""
    if not quantize_acts:
        return None, 1
    return (QuantConfig(bits=max(bits, 8)),
            3 if method == "splitquant" else 1)


def quantized_accuracy(cfg, params, ds, bits: int, method: str, seed=0,
                       quantize_acts=False) -> float:
    """Weight (and bias) PTQ, optionally with §4.2 activation
    quantization: "splitquant" takes 3-chunk activation ranges,
    "baseline" one whole-tensor range."""
    act_cfg, act_chunks = act_quant(bits, method, quantize_acts)
    return evaluate(cfg, quantize(params, bits, method, seed), ds,
                    act_cfg=act_cfg, act_chunks=act_chunks)


def table1_rows(cfg, params, te: ClsDataset, seed=0,
                acts=(False,)) -> dict:
    """{quantize_acts: {"fp32", "int{b}_baseline", "int{b}_splitquant"}}
    accuracies on the test split for each of ``acts``; each (bits,
    method) tree is quantized once and evaluated under each."""
    fp32 = evaluate(cfg, params, te)
    rows = {a: {"fp32": fp32} for a in acts}
    for bits in BITS:
        for method in ("baseline", "splitquant"):
            q = quantize(params, bits, method, seed)
            for a in acts:
                act_cfg, act_chunks = act_quant(bits, method, a)
                rows[a][f"int{bits}_{method}"] = evaluate(
                    cfg, q, te, act_cfg=act_cfg, act_chunks=act_chunks)
    return rows


def datasets(n_samples: int, seed: int):
    """[(name, train split, test split)]: each task's first 80% and the
    rest."""
    out = []
    for name, maker in DATASETS:
        ds = maker(n_samples=n_samples, seed=seed)
        out.append((name, *split(ds, int(0.8 * n_samples))))
    return out


def print_row(name: str, row: dict) -> None:
    print(f"\n== {name} (FP32 {row['fp32']:.3f}) ==")
    for bits in BITS:
        b_, s_ = row[f"int{bits}_baseline"], row[f"int{bits}_splitquant"]
        print(f"  INT{bits}: baseline {b_:.3f}  splitquant {s_:.3f}"
              f"  diff {100 * (s_ - b_):+.1f}%p")


def markdown(results: dict) -> str:
    """The paper's Table 1 layout."""
    lines = ["| dataset | FP32 | INT2 base | INT2 SQ | diff | INT4 base | "
             "INT4 SQ | diff | INT8 base | INT8 SQ | diff |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for ds, r in results.items():
        cells = [f"{r['fp32']:.1%}"]
        for b in BITS:
            base, sq = r[f"int{b}_baseline"], r[f"int{b}_splitquant"]
            cells += [f"{base:.1%}", f"{sq:.1%}",
                      f"{100 * (sq - base):+.1f}%p"]
        lines.append(f"| {ds} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


@dataclasses.dataclass
class Table1Run:
    """What :func:`run_table1` measured. ``grids[quantize_acts]`` is
    {dataset: row}; ``models`` is each dataset's (cfg, trained params,
    test split); ``train_s`` is the fine-tuning's wall time over
    ``train_steps`` steps, both tasks."""
    grids: dict
    models: dict
    train_s: float
    train_steps: int


def run_table1(*, epochs=8, n_samples=4000, seed=0, verbose=True,
               quantize_acts=False, device=None) -> Table1Run:
    """Train on 80% of each task, evaluate FP32 and each (bits, method) on
    the other 20%. ``quantize_acts`` is a bool, or a tuple of them: one
    grid each from the same trained models."""
    device = resolve_device(device)
    acts = ((quantize_acts,) if isinstance(quantize_acts, bool)
            else tuple(quantize_acts))
    run = Table1Run({a: {} for a in acts}, {}, 0.0, 0)
    for name, tr, te in datasets(n_samples, seed):
        _sync(device)
        t0 = time.perf_counter()
        cfg, params = train_bert(tr, epochs=epochs, seed=seed, device=device)
        _sync(device)
        run.train_s += time.perf_counter() - t0
        run.train_steps += (tr.tokens.shape[0] // TRAIN_BATCH) * epochs
        run.models[name] = (cfg, params, te)
        for a, row in table1_rows(cfg, params, te, seed, acts).items():
            run.grids[a][name] = row
            if verbose:
                print_row(f"{name}, W{{b}}A8" if a else name, row)
    return run


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--samples", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize-acts", action="store_true",
                    help="W{b}A8: quantize the §4.2 activations at 8 bits")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card, raising without "
                         "one)")
    args = ap.parse_args(argv)
    run = run_table1(epochs=args.epochs, n_samples=args.samples,
                     seed=args.seed, quantize_acts=args.quantize_acts,
                     device=args.device)
    results = run.grids[args.quantize_acts]
    print("\n== markdown (paper Table 1 structure) ==")
    print(markdown(results))
    return results


if __name__ == "__main__":
    main()
