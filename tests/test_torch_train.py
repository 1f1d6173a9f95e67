"""Port parity, training: the synthetic LM pipeline and its prefetcher,
AdamW (fp32 and bf16 states, clipping, int8 gradient compression), the
fault-tolerant train loop, training checkpoints of ``(params,
opt_state)`` across the packages, ``transformer.loss_fn`` (dense, MoE
with its aux loss, VLM on its text tokens; with and without remat) and
``launch.train``, against the JAX package on the same seeded weights and
batches.

Tolerances: token batches, compressed gradient codes, checkpoint arrays
and step counters identical; AdamW over 5 steps of bert-tiny: params
within 1e-5 x their largest entry, the loss history within 1e-5
relative (XLA's CPU code contracts some products and sums into FMAs, an
ulp a step); ``transformer.loss_fn``: loss within 1e-5 relative,
gradients within 1e-4 x the largest gradient entry; remat on and off
identical. JAX references are shared through ``functools.cache``; torch
runs on one intra-op thread.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jck
from repro.configs import get_arch
from repro.data import DataConfig as JDataConfig
from repro.data import synthetic_lm_batch as j_lm_batch
from repro.data import classification as jcls
from repro.models import bert_tiny as jbert
from repro.models import get_model
from repro.optim import adamw as jadamw

from repro_torch import bridge
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch as t_arch
from repro_torch.data import DataConfig, Prefetcher, synthetic_lm_batch
from repro_torch.data import classification as tcls
from repro_torch.launch import table1 as ttable1
from repro_torch.launch import train as ttrain
from repro_torch.models import bert_tiny as tbert
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop
from repro_torch.tree import tree_map

from test_torch_bert import _flat, _grads, _with_grad
from test_torch_quant import _to_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _np(a):
    return np.asarray(a)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# --------------------------------------------------------------- pipeline ---
@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 0, 1),
                                                 (3, 1, 4), (3, 3, 4)])
def test_synthetic_lm_batch_is_bit_identical(step, shard, n_shards):
    jc = JDataConfig(vocab=1000, seq_len=16, global_batch=8, seed=5)
    tc = DataConfig(vocab=1000, seq_len=16, global_batch=8, seed=5)
    want = j_lm_batch(jc, step, shard, n_shards)
    got = synthetic_lm_batch(tc, step, shard, n_shards, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        assert got[k].shape == (8 // n_shards, 16)
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]))


def test_prefetcher_in_order_and_after_a_rewind():
    made = []

    def make(step):
        made.append(step)
        return {"step": step}
    pre = Prefetcher(make, 0, depth=2)
    assert [pre.get(s)["step"] for s in range(5)] == list(range(5))
    # a restart from step 2: the batches come again, in order
    assert [pre.get(s)["step"] for s in range(2, 8)] == list(range(2, 8))
    pre.stop()


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = t_arch("bert-tiny")
    ds = tcls.spam_like(n_samples=40, seq_len=8)
    calls = [lambda: tbert.init(cfg, 2),
             lambda: next(tcls.batches(ds, 8)),
             lambda: synthetic_lm_batch(DataConfig(64, 8, 2), 0),
             lambda: ttrain.main(["--arch", "stablelm-1.6b", "--reduced",
                                  "--steps", "1"]),
             lambda: ttable1.train_bert(ds, epochs=1),
             lambda: ttable1.main(["--epochs", "1", "--samples", "200"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ------------------------------------------------------------------ AdamW ---
def test_schedule_and_global_norm_match_jax():
    for kw in ({}, {"warmup_steps": 0}, {"warmup_steps": 3,
                                          "total_steps": 10}):
        jc, tc = jadamw.OptConfig(**kw), adamw.OptConfig(**kw)
        for step in (0, 1, 2, 5, 50, 150, 10000, 20000):
            want = jadamw.schedule(jc, jnp.int32(step))
            got = adamw.schedule(tc, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert _rel(got, want) <= 2 ** -23 * 2, (kw, step)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": [{"w": rng.standard_normal(9).astype(np.float32)}]}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = tree_map(torch.from_numpy, tree)
    assert _rel(adamw.global_norm(ttree), jadamw.global_norm(jtree)) <= 1e-6


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_compress_int8_codes_match_jax(dtype):
    rng = np.random.default_rng(1)
    g = rng.standard_normal((33, 17)).astype(np.float32) * 1e-3
    e = rng.standard_normal((33, 17)).astype(np.float32) * 1e-5
    jg, je = jnp.asarray(g), jnp.asarray(e)
    tg, te = torch.from_numpy(g), torch.from_numpy(e)
    if dtype == "bfloat16":
        jg, je = jg.astype(jnp.bfloat16), je.astype(jnp.bfloat16)
        tg, te = tg.to(torch.bfloat16), te.to(torch.bfloat16)
    jd, jr = jadamw.compress_int8(jg, je)
    td, tr = adamw.compress_int8(tg, te)
    assert td.dtype == tg.dtype and tr.dtype == te.dtype
    np.testing.assert_array_equal(td.float().numpy(),
                                  _np(jd.astype(jnp.float32)))
    np.testing.assert_array_equal(tr.float().numpy(),
                                  _np(jr.astype(jnp.float32)))
    # the codes: 127 steps each side of zero, one step amax / 127
    gf = g.astype(np.float32) + e if dtype == np.float32 else None
    if gf is not None:
        step = (np.abs(gf).max() + 1e-12) / 127
        codes = td.numpy() / step
        assert np.abs(codes - np.rint(codes)).max() <= 1e-3
        assert np.abs(np.rint(codes)).max() == 127


@functools.cache
def _bert_setup():
    cfg = get_arch("bert-tiny")
    params = jax.jit(jbert.init, static_argnums=(1, 2),
                     static_argnames="max_len",
                     compiler_options=FAST_COMPILE)(KEY, cfg, 6, max_len=24)
    ds = jcls.emotion_like(n_samples=160, seq_len=24, seed=4)
    return cfg, params, ds


@functools.cache
def _jax_bert_grad():
    """bert-tiny's loss and gradients, jitted once for every case."""
    cfg, _, _ = _bert_setup()

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def grad(p, b):
        (l, _), g = jax.value_and_grad(
            lambda pp: jbert.loss_fn(pp, cfg, b), has_aux=True)(p)
        return l, g
    return grad


OPT_CASES = {
    "fp32": dict(lr=1e-3, warmup_steps=2, total_steps=5, clip_norm=None),
    "fp32_clip": dict(lr=1e-3, warmup_steps=2, total_steps=5,
                      clip_norm=0.05, weight_decay=0.01),
    "bf16_states": dict(lr=1e-3, warmup_steps=2, total_steps=5,
                        state_dtype="bfloat16"),
    # no clipping here (fp32_clip holds it): the clip factor's last bit
    # (the port sums the norm over per-layer leaves, XLA over stacked
    # ones in its own order) moves the codes that sit on a rounding tie
    "int8_compress": dict(lr=1e-3, warmup_steps=2, total_steps=5,
                          grad_compress="int8", clip_norm=None),
}


@functools.cache
def _jax_adamw_run(case):
    """Five jitted JAX steps of bert-tiny: each step's params, gradients
    and loss, and the final params and state."""
    _, params, ds = _bert_setup()
    oc = jadamw.OptConfig(**OPT_CASES[case])
    opt = jadamw.init(oc, params)
    grad = _jax_bert_grad()
    update = jax.jit(functools.partial(jadamw.update, oc),
                     compiler_options=FAST_COMPILE)
    steps = []
    for b in jcls.batches(ds, 32, seed=1, epochs=1):
        loss, g = grad(params, {k: jnp.asarray(v) for k, v in b.items()})
        steps.append((params, g, float(loss)))
        params, opt, _ = update(opt, params, g)
    return steps, params, opt


def _port_tree(tree):
    return bridge.from_jax_tree(_to_numpy_tree(tree), device="cpu")


def _port_loss_and_grads(params, cfg, batch):
    p = _with_grad(params, [])
    loss, _ = tbert.loss_fn(p, cfg, batch)
    loss.backward()
    return float(loss), _grads(p)


def _tree_close(got, want, rel, floor=0.0, atol=0.0):
    """Each leaf within ``rel`` x max(its largest entry, ``floor``), or
    within ``atol``."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k],
                                                          np.float64)
        err = np.abs(g - w).max()
        assert err <= max(rel * max(np.abs(w).max(), floor), atol), (k, err)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_over_five_bert_steps_matches_jax(case):
    """Five steps of bert-tiny from the same weights and batches along
    JAX's trajectory: at each step the port's loss (within 1e-5 relative)
    and gradients (within 1e-5 x the largest entry) on JAX's params, and
    the port's AdamW fed JAX's gradients; its params after five steps
    within 1e-5 x each leaf's largest entry (1e-3 at least: the biases
    start at 0), its moments and residuals within 1e-5 x theirs. bf16
    states: the moments within one bf16 rounding (2^-8), which an ulp of
    XLA's FMAs can flip, and the params within 5 x lr x 2^-8 (such a
    rounding moves a normalized step by at most that much a step). Free-running, the two trajectories
    part at the ulps of the gradient entries near eps = 1e-8, which Adam's
    normalization turns into steps of up to lr: see
    test_torch_bert.py::test_table1_trains_like_jax_for_a_few_steps."""
    steps, jp, jo = _jax_adamw_run(case)
    tcfg = t_arch("bert-tiny")
    oc = adamw.OptConfig(**OPT_CASES[case])
    params = _port_tree(steps[0][0])
    opt = adamw.init(oc, params)
    ds = tcls.emotion_like(n_samples=160, seq_len=24, seed=4)
    batches = list(tcls.batches(ds, 32, seed=1, epochs=1, device="cpu"))
    assert len(batches) == len(steps) == 5
    for (jparams, jgrads, jloss), b in zip(steps, batches):
        loss, grads = _port_loss_and_grads(_port_tree(jparams), tcfg, b)
        assert _rel(loss, jloss) <= 1e-5
        want = _flat(_to_numpy_tree(jgrads))
        top = max(np.abs(w).max() for w in want.values())
        got = _flat(grads)
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= 1e-5 * top, k
        params, opt, m = adamw.update(oc, opt, params, _port_tree(jgrads))
        assert m["lr"].dtype == torch.float32
    assert int(opt.step) == int(jo.step) == 5 and \
        opt.step.dtype == torch.int32
    dt = torch.bfloat16 if oc.state_dtype == "bfloat16" else torch.float32
    _tree_close(params, _to_numpy_tree(jp), 1e-5, floor=1e-3,
                atol=5 * oc.lr * 2 ** -8 if dt == torch.bfloat16 else 0.0)
    assert opt.m["layers"][0]["attn"]["wq"].dtype == dt
    rel = 2 ** -8 if dt == torch.bfloat16 else 1e-5
    to_np = lambda t: tree_map(  # noqa: E731
        lambda x: x.float().numpy(), t)
    for got, want in ((opt.m, jo.m), (opt.v, jo.v)):
        want = jax.tree_util.tree_map(lambda x: np.asarray(
            x.astype(jnp.float32)), want)
        _tree_close(to_np(got), _port_tree(want), rel)
    assert (opt.err is None) == (oc.grad_compress is None)
    if opt.err is not None:
        _tree_close(opt.err, _to_numpy_tree(jo.err), 1e-5)


# -------------------------------------------------------------- the loop ---
def _quadratic_step(lr=0.1, warmup=0):
    oc = adamw.OptConfig(lr=lr, warmup_steps=warmup)
    step = train_loop.make_train_step(
        lambda p, b: (torch.sum((p["w"] - b["target"]) ** 2), {}), oc)
    return oc, step


def test_train_loop_failure_recovery(tmp_path):
    oc, step = _quadratic_step()
    params = {"w": torch.zeros(4)}
    fails = {3, 9}

    def inject(s):
        if s in fails:
            fails.discard(s)
            raise RuntimeError("boom")
    logs = []
    lc = train_loop.TrainLoopConfig(total_steps=15, ckpt_dir=str(tmp_path),
                                    ckpt_every=2, ckpt_async=False,
                                    log_every=100)
    p, o, hist = train_loop.run(lc, step, params, adamw.init(oc, params),
                                lambda s: {"target": torch.ones(4)},
                                inject_failure=inject, log=logs.append)
    assert len(hist) >= 15        # replayed steps after a restore included
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert int(o.step) == 15
    assert sum("[recover] restored step 2" in m for m in logs) == 1
    assert sum("[recover] restored step 8" in m for m in logs) == 1
    # the final checkpoint resumes at once: nothing left to run
    p2, o2, hist2 = train_loop.run(lc, step, params, adamw.init(oc, params),
                                   lambda s: {"target": torch.ones(4)},
                                   log=logs.append)
    assert hist2 == [] and torch.equal(p2["w"], p["w"])


def test_train_loop_recovery_equals_an_uninterrupted_run(tmp_path):
    """A failure after a checkpoint, restored and replayed: the final
    params are the uninterrupted run's, bit for bit (the same CPU ops on
    the same restored values)."""
    oc, step = _quadratic_step(lr=0.05, warmup=2)
    make = lambda s: {"target": torch.full((4,), float(s % 3))}  # noqa
    lc = lambda d: train_loop.TrainLoopConfig(  # noqa: E731
        total_steps=10, ckpt_dir=d, ckpt_every=3, ckpt_async=True,
        log_every=100)
    params = {"w": torch.zeros(4)}
    p_ref, _, _ = train_loop.run(lc(None), step, params,
                                 adamw.init(oc, params), make,
                                 log=lambda *a: None)
    fired = []

    def inject(s):
        if s == 7 and not fired:
            fired.append(s)
            ckpt.wait_for_async()        # step 6's checkpoint has landed
            raise ValueError("injected")
    p, o, hist = train_loop.run(lc(str(tmp_path / "c")), step, params,
                                adamw.init(oc, params), make,
                                inject_failure=inject, log=lambda *a: None)
    assert fired == [7] and len(hist) == 11
    assert torch.equal(p["w"], p_ref["w"])


@pytest.mark.parametrize("where,with_ckpt", [("before", False),
                                             ("inside", False),
                                             ("inside", True)])
def test_train_loop_retry_never_applies_a_step_twice(where, with_ckpt,
                                                     tmp_path, monkeypatch):
    """AdamW updates its moments in place. A failure at step 7 before the
    update is retried from the step's own start, and one inside it (after
    the first leaf's moments moved) is restored from step 6's checkpoint:
    both end bit-equal to an uninterrupted run. Inside the update with no
    checkpoint, the loop raises instead of retrying."""
    oc = adamw.OptConfig(lr=0.05, warmup_steps=2)
    step = train_loop.make_train_step(
        lambda p, b: (torch.sum((p["w"] - b["t"]) ** 2) +
                      torch.sum((p["x"] - b["t"][:3]) ** 2), {}), oc)
    make = lambda s: {"t": torch.full((4,), float(s % 3))}  # noqa: E731
    params = {"w": torch.zeros(4), "x": torch.zeros(3)}
    lc = train_loop.TrainLoopConfig(
        total_steps=10, ckpt_dir=str(tmp_path) if with_ckpt else None,
        ckpt_every=3, ckpt_async=False, log_every=100)
    p_ref, _, _ = train_loop.run(
        dataclasses.replace(lc, ckpt_dir=None), step, params,
        adamw.init(oc, params), make, log=lambda *a: None)
    armed, fired = [False], []
    real_map = adamw.tree_map

    def tree_map(fn, tree, *rest):
        if not (armed[0] and len(rest) == 3):
            return real_map(fn, tree, *rest)
        armed[0] = False

        def first_leaf_then_fail(*leaves):
            if fired:
                raise RuntimeError("injected inside the update")
            fired.append(fn(*leaves))
            return fired[-1]
        return real_map(first_leaf_then_fail, tree, *rest)
    monkeypatch.setattr(adamw, "tree_map", tree_map)

    def inject(s):
        if s == 7 and not fired and not armed[0]:
            if where == "before":
                fired.append(s)
                raise RuntimeError("injected before the update")
            armed[0] = True
    run = lambda: train_loop.run(lc, step, params,  # noqa: E731
                                 adamw.init(oc, params), make,
                                 inject_failure=inject, log=lambda *a: None)
    if where == "inside" and not with_ckpt:
        with pytest.raises(RuntimeError, match="inside the update"):
            run()
        return
    p, o, _ = run()
    assert fired and int(o.step) == 10
    for k in params:
        assert torch.equal(p[k], p_ref[k])


def test_train_loop_gives_up_after_max_failures():
    oc = adamw.OptConfig()
    params = {"w": torch.zeros(2)}
    step = train_loop.make_train_step(
        lambda p, b: (torch.sum(p["w"] ** 2), {}), oc)

    def inject(s):
        raise RuntimeError("persistent failure")
    lc = train_loop.TrainLoopConfig(total_steps=5, max_failures=2,
                                    log_every=100)
    with pytest.raises(RuntimeError, match="persistent"):
        train_loop.run(lc, step, params, adamw.init(oc, params),
                       lambda s: {}, inject_failure=inject,
                       log=lambda *a: None)


def test_straggler_monitor():
    m = train_loop.StragglerMonitor(factor=2.0)
    assert not m.observe(0.1)
    for _ in range(5):
        m.observe(0.1)
    assert m.observe(1.0)
    assert m.flagged == 1


def test_unreached_leaves_get_zero_gradients():
    oc = adamw.OptConfig(lr=0.1, warmup_steps=0, weight_decay=0.0)
    step = train_loop.make_train_step(
        lambda p, b: (torch.sum(p["used"] ** 2), {}), oc)
    params = {"used": torch.ones(3), "unused": torch.ones(2)}
    p, o, _ = step(params, adamw.init(oc, params), {})
    assert torch.equal(p["unused"], params["unused"])
    assert not torch.equal(p["used"], params["used"])
    assert not params["used"].requires_grad


# --------------------------------------------------- training checkpoints ---
@functools.cache
def _jax_train_state():
    """Reduced stablelm after two JAX AdamW steps (non-zero moments)."""
    cfg = get_arch("stablelm-1.6b").reduced()
    params = get_model(cfg).init(KEY, cfg)
    oc = jadamw.OptConfig(lr=1e-3, warmup_steps=0, grad_compress="int8")
    opt = jadamw.init(oc, params)

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def step(p, o, b):
        (_, _), g = jax.value_and_grad(
            lambda pp: get_model(cfg).loss_fn(pp, cfg, b), has_aux=True)(p)
        p, o, _ = jadamw.update(oc, o, p, g)
        return p, o
    dc = JDataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    for s in range(2):
        params, opt = step(params, opt, j_lm_batch(dc, s))
    return cfg, params, opt


def _port_opt(jopt):
    """A JAX OptState's arrays in the port's layout."""
    conv = lambda t: bridge.from_jax_tree(_to_numpy_tree(t),  # noqa: E731
                                          device="cpu")
    return adamw.OptState(step=torch.tensor(int(jopt.step),
                                            dtype=torch.int32),
                          m=conv(jopt.m), v=conv(jopt.v),
                          err=None if jopt.err is None else conv(jopt.err))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_training_checkpoint_both_ways(writer, tmp_path):
    cfg, jparams, jopt = _jax_train_state()
    tparams = bridge.from_jax_tree(_to_numpy_tree(jparams), device="cpu")
    topt = _port_opt(jopt)
    d = str(tmp_path)
    if writer == "jax":
        jck.save(d, 2, (jparams, jopt))
        like = (tt.init(t_arch("stablelm-1.6b").reduced(), seed=3,
                        device="cpu"), None)
        like = (like[0], adamw.init(adamw.OptConfig(grad_compress="int8"),
                                    like[0]))
        (gp, go), step = ckpt.restore(d, like)
        assert isinstance(go, adamw.OptState)
        want_p, want_o = tparams, topt
    else:
        ckpt.save(d, 2, (tparams, topt))
        (jp, jo), step = jck.restore(d, (jparams, jopt))
        gp = bridge.from_jax_tree(_to_numpy_tree(jp), device="cpu")
        go = _port_opt(jo)
        want_p, want_o = tparams, topt
    assert step == 2 and int(go.step) == 2 and go.step.dtype == torch.int32
    for got, want in ((gp, want_p), (go.m, want_o.m), (go.v, want_o.v),
                      (go.err, want_o.err)):
        g, w = _flat(got), _flat(want)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    keys = jck._flatten((jparams, jopt))[0].keys()
    with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
        assert set(json.load(f)["keys"]) == set(keys)


def test_training_checkpoint_without_compression_has_no_err_key(tmp_path):
    params = {"layers": [{"w": torch.ones(2, 3)}, {"w": torch.zeros(2, 3)}],
              "b": torch.ones(4)}
    opt = adamw.init(adamw.OptConfig(), params)
    ckpt.save(str(tmp_path), 1, (params, opt))
    with open(os.path.join(str(tmp_path), "step_00000001",
                           "manifest.json")) as f:
        keys = json.load(f)["keys"]
    assert sorted(keys) == sorted([
        "[0]['b']", "[0]['layers']['w']", "[1].step", "[1].m['b']",
        "[1].m['layers']['w']", "[1].v['b']", "[1].v['layers']['w']"])
    (p, o), _ = ckpt.restore(str(tmp_path), (params, opt))
    assert o.err is None and torch.equal(p["layers"][0]["w"],
                                         params["layers"][0]["w"])


# ------------------------------------------------------ transformer loss ---
def _lm_batch(cfg, B=2, S=12, seed=0):
    dc = JDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed)
    b = {k: _np(v) for k, v in j_lm_batch(dc, 0).items()}
    if cfg.family == "vlm":
        b["patch_embeds"] = np.random.default_rng(seed).standard_normal(
            (B, 8, 1152)).astype(np.float32)
    return b


@functools.cache
def _jax_loss(arch):
    cfg = get_arch(arch).reduced()
    params = get_model(cfg).init(KEY, cfg)
    b = _lm_batch(cfg)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: get_model(cfg).loss_fn(p, cfg, {k: jnp.asarray(v)
                                                  for k, v in b.items()}),
        has_aux=True), compiler_options=FAST_COMPILE)(params)
    return cfg, params, b, float(loss), {k: float(v) for k, v in
                                         aux.items()}, grads


def _port_loss(params, cfg, b, remat):
    p = _with_grad(params, [])
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, aux = tt.loss_fn(p, cfg, tb, remat=remat)
    loss.backward()
    return float(loss), {k: float(v) for k, v in aux.items()}, _grads(p)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "moonshot-v1-16b-a3b",
                                  "paligemma-3b"])
def test_transformer_loss_and_grads_match_jax(arch):
    cfg, jparams, b, jl, jaux, jg = _jax_loss(arch)
    tcfg = t_arch(arch).reduced()
    port = bridge.from_jax_tree(_to_numpy_tree(jparams), device="cpu")
    loss, aux, grads = _port_loss(port, tcfg, b, remat=True)
    assert _rel(loss, jl) <= 1e-5
    assert _rel(aux["loss"], jaux["loss"]) <= 1e-5
    if cfg.n_experts:
        assert aux["aux"] > 0 and _rel(aux["aux"], jaux["aux"]) <= 1e-5
    else:
        assert aux["aux"] == jaux["aux"] == 0.0
    got, want = _flat(grads), _flat(_to_numpy_tree(jg))
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= 1e-4 * top, (k, err, top)
    # remat recomputes the layers in the backward pass: the same numbers
    loss2, aux2, grads2 = _port_loss(port, tcfg, b, remat=False)
    assert loss2 == loss and aux2 == aux
    g2 = _flat(grads2)
    for k in got:
        np.testing.assert_array_equal(g2[k], got[k], err_msg=k)


def test_vlm_loss_is_on_the_text_tokens():
    cfg, jparams, b, jl, _, _ = _jax_loss("paligemma-3b")
    tcfg = t_arch("paligemma-3b").reduced()
    port = bridge.from_jax_tree(_to_numpy_tree(jparams), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        logits, _ = tt.forward(port, tcfg, tb)
        want = torch.nn.functional.cross_entropy(
            logits[:, -b["labels"].shape[1]:].reshape(-1, tcfg.vocab),
            tb["labels"].long().reshape(-1))
        got, _ = tt.loss_fn(port, tcfg, tb, remat=False)
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)


# ------------------------------------------------------------------- CLIs ---
def test_train_cli_runs_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    out = ttrain.main(["--arch", "stablelm-1.6b", "--reduced", "--steps",
                       "4", "--batch", "2", "--seq", "16", "--ckpt-dir", d,
                       "--ckpt-every", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "final loss" in text.splitlines()[-1]
    assert len(out["history"]) == 4 and len(out["step_s"]) == 4
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert ckpt.latest_step(d) == 4
    again = ttrain.main(["--arch", "stablelm-1.6b", "--reduced", "--steps",
                         "6", "--batch", "2", "--seq", "16", "--ckpt-dir",
                         d, "--device", "cpu"])
    assert "[restore] resumed from step 4" in capsys.readouterr().out
    assert len(again["history"]) == 2 and int(again["opt_state"].step) == 6


@pytest.mark.parametrize("args,match", [
    (["--arch", "stablelm-1.6b", "--production-mesh"], "queue 1 item 6"),
    (["--arch", "whisper-tiny"], "frames"),
    (["--arch", "bert-tiny"], "table1")])
def test_train_cli_refuses_what_it_does_not_train(args, match):
    with pytest.raises(NotImplementedError, match=match):
        ttrain.main(args + ["--reduced", "--device", "cpu"])


def test_train_cli_trains_rwkv6_checkpoints_and_resumes(tmp_path, capsys):
    """rwkv6 (the ssm family) trains: its chunked time-mix (seq 32)
    through ``WkvChunked`` and the plain backward on the CPU, every layer
    recomputed; then a resume from the step-4 checkpoint."""
    d = str(tmp_path / "ck")
    args = ["--arch", "rwkv6-3b", "--reduced", "--batch", "2", "--seq", "32",
            "--ckpt-dir", d, "--ckpt-every", "2", "--device", "cpu"]
    out = ttrain.main(args + ["--steps", "4"])
    assert "final loss" in capsys.readouterr().out.splitlines()[-1]
    assert len(out["history"]) == 4
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["params"]["layers"][0]["att"]["time_faaaa"].abs().max() > 0
    assert ckpt.latest_step(d) == 4
    again = ttrain.main(args + ["--steps", "6"])
    assert "[restore] resumed from step 4" in capsys.readouterr().out
    assert len(again["history"]) == 2 and int(again["opt_state"].step) == 6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(["--arch", "rwkv6-3b", "--reduced", "--steps", "1"])


def test_train_cli_moe_with_compressed_bf16_states(capsys):
    out = ttrain.main(["--arch", "moonshot-v1-16b-a3b", "--reduced",
                       "--steps", "2", "--batch", "2", "--seq", "8",
                       "--grad-compress", "int8", "--opt-dtype", "bfloat16",
                       "--device", "cpu"])
    assert out["opt_state"].err is not None
    assert out["opt_state"].m["moe_layers"][0]["moe"]["w_gate"].dtype == \
        torch.bfloat16
    assert "final loss" in capsys.readouterr().out
