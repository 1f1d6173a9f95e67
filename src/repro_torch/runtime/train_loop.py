"""Fault-tolerant training loop (port of ``repro.runtime.train_loop``).

* checkpoint/restart: atomic checkpoints of ``(params, opt_state)`` every
  ``ckpt_every`` steps, in the JAX package's format
  (:mod:`repro_torch.checkpoint.ckpt`); on a failure the loop restores the
  last good step and resumes (the data pipeline is stateless, so resuming
  sets the step counter);
* straggler mitigation: a per-step wall-time EWMA; a step slower than
  ``straggler_factor`` x the EWMA is logged and counted;
* retry budget: failures retry up to ``max_failures`` times, then the
  last one is raised. With no checkpoint to restore, a step is retried
  from the params and optimizer state it started from, and only if the
  failure changed none of them in place (AdamW updates its moments in
  place): otherwise the failure is raised, since a retry would apply
  part of the step twice.

The failures caught are JAX's: ``RuntimeError`` (which a CUDA error
raises, or its subclass ``torch.AcceleratorError``) and ``ValueError``. A step ends when the card has run it: the loop waits on
the loss's stream where JAX calls ``block_until_ready``, so an
asynchronous device error surfaces inside the step that caused it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..checkpoint import ckpt as ckpt_lib
from ..optim import adamw
from ..tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_async: bool = True
    max_failures: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


class StragglerMonitor:
    def __init__(self, factor: float):
        self.factor = factor
        self.ewma: Optional[float] = None
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        self.ewma = dt if self.ewma is None else 0.9 * self.ewma + 0.1 * dt
        if slow:
            self.flagged += 1
        return slow


#: the profiler range (``torch.profiler.record_function``) a train step's
#: AdamW update runs in; it costs nothing measurable when no profiler runs
UPDATE_RANGE = "adamw update"


def make_train_step(loss_fn: Callable, opt_cfg: adamw.OptConfig):
    """loss_fn(params, batch) → (loss, metrics). Returns
    step(params, opt_state, batch) → (params, opt_state, metrics): the
    gradients of every floating-point leaf by ``torch.autograd`` (zero
    for a leaf the loss does not reach, as JAX's), then
    :func:`~repro_torch.optim.adamw.update` inside :data:`UPDATE_RANGE`.
    The parameters given are not changed; the step returns new ones."""

    def train_step(params, opt_state, batch):
        params = tree_map(
            lambda p: p.detach().requires_grad_(p.is_floating_point()),
            params)
        loss, metrics = loss_fn(params, batch)
        leaves = [p for p in tree_leaves(params) if p.requires_grad]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_leaf = {id(p): g for p, g in zip(leaves, grads)}
        grads = tree_map(
            lambda p: torch.zeros_like(p) if by_leaf.get(id(p)) is None
            else by_leaf[id(p)], params)
        params = tree_map(lambda p: p.detach(), params)
        with torch.profiler.record_function(UPDATE_RANGE):
            params, opt_state, opt_metrics = adamw.update(
                opt_cfg, opt_state, params, grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **opt_metrics,
                                   "loss": loss.detach()}

    return train_step


def _versions(tree) -> list:
    """The in-place version counters of a tree's tensors."""
    return [t._version for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _wait(t: torch.Tensor) -> None:
    """Block until the card has run everything queued on ``t``'s stream."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def run(loop_cfg: TrainLoopConfig, train_step, params, opt_state,
        make_batch: Callable[[int], dict], *, inject_failure=None,
        log: Callable = print):
    """Run to total_steps with checkpoint/restart. ``inject_failure(step)``
    (tests) may raise to exercise the recovery path. A restore puts the
    checkpoint's arrays on the devices of the current ``params`` and
    ``opt_state``.

    Returns (params, opt_state, history)."""
    step = 0
    if loop_cfg.ckpt_dir:
        last = ckpt_lib.latest_step(loop_cfg.ckpt_dir)
        if last is not None:
            (params, opt_state), step = ckpt_lib.restore(
                loop_cfg.ckpt_dir, (params, opt_state))
            log(f"[restore] resumed from step {step}")

    monitor = StragglerMonitor(loop_cfg.straggler_factor)
    failures = 0
    history = []
    while step < loop_cfg.total_steps:
        t0 = time.perf_counter()
        start = (params, opt_state, _versions((params, opt_state)))
        try:
            if inject_failure is not None:
                inject_failure(step)
            batch = make_batch(step)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            _wait(metrics["loss"])
        except (RuntimeError, ValueError) as e:
            failures += 1
            log(f"[failure] step {step}: {type(e).__name__}: {e}")
            if failures > loop_cfg.max_failures:
                raise
            if loop_cfg.ckpt_dir and \
                    ckpt_lib.latest_step(loop_cfg.ckpt_dir) is not None:
                (params, opt_state), step = ckpt_lib.restore(
                    loop_cfg.ckpt_dir, (params, opt_state))
                log(f"[recover] restored step {step}, retrying")
                continue
            params, opt_state, versions = start
            if _versions((params, opt_state)) != versions:
                log(f"[failure] step {step} changed the state in place and "
                    f"no checkpoint exists: not retried")
                raise
            continue
        start = None

        dt = time.perf_counter() - t0
        if monitor.observe(dt):
            log(f"[straggler] step {step} took {dt*1e3:.1f} ms "
                f"(ewma {monitor.ewma*1e3:.1f} ms)")
        step += 1
        history.append({k: float(v) for k, v in metrics.items()})
        if step % loop_cfg.log_every == 0:
            log(f"step {step:5d} loss {history[-1]['loss']:.4f} "
                f"({dt*1e3:.0f} ms)")
        if loop_cfg.ckpt_dir and step % loop_cfg.ckpt_every == 0:
            ckpt_lib.save(loop_cfg.ckpt_dir, step, (params, opt_state),
                          blocking=not loop_cfg.ckpt_async)
    if loop_cfg.ckpt_dir:
        ckpt_lib.wait_for_async()
        ckpt_lib.save(loop_cfg.ckpt_dir, step, (params, opt_state),
                      blocking=True)
    return params, opt_state, history
