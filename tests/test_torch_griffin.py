"""Port parity, griffin (recurrentgemma-9b, the hybrid family): the
port's ``_causal_conv``, RG-LRU scan, ``forward``, ``prefill``,
``decode_step``, the windowed ring cache, quantized trees through the
bridge, the wave ``Server``, ``loss_fn`` and its gradients, against the
JAX package's on the same seeded weights (JAX's ``griffin.init`` through
the bridge), at two depths: ``reduced()`` (6 layers: 2 groups of (rec,
rec, attn), no tail) and ``n_layers=8`` (2 groups and 2 trailing
recurrent layers), window 16, with prompts shorter (12) and longer (24)
than the window.

Tolerances: ``associative_scan`` against eager ``lax.associative_scan``
bit-identical (each op rounds on its own in both); the conv and the
RG-LRU against JAX's jitted ones, and logits, caches and the forward,
atol 1e-4 x max(1, the reference's largest magnitude) in fp32 (XLA may
contract the scan's b·a + b into an FMA, and the products sum in another
order); ring positions, codes and the dequantized conv taps exact;
greedy tokens identical; the loss within 1e-5 relative and each
gradient leaf within 1e-4 of its largest entry. JAX references are
jitted and shared through ``functools.cache``; torch runs on one
intra-op thread.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.core import QuantConfig, QuantPolicy, quantize_tree
from repro.models import griffin as jg
from repro.runtime import serve_loop as jsl

from repro_torch import bridge
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import apply as tapply
from repro_torch.core.splitquant import SplitQuantTensor
from repro_torch.kernels.ops import PackedWeight
from repro_torch.models import get_model, griffin as tg
from repro_torch.runtime import serve_loop as tsl

from test_torch_bert import _flat, _grads, _with_grad
from test_torch_quant import _to_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

FAST_COMPILE = {"xla_backend_optimization_level": 0}
DEPTHS = (6, 8)
B, SHORT, LONG, STEPS = 2, 12, 24, 3


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _cfgs(n_layers):
    return (dataclasses.replace(j_arch("recurrentgemma-9b").reduced(),
                                n_layers=n_layers),
            dataclasses.replace(t_arch("recurrentgemma-9b").reduced(),
                                n_layers=n_layers))


@functools.cache
def _setup(n_layers):
    """(JAX cfg, port cfg, JAX params, port params): JAX's seeded init
    (jitted) with non-zero conv biases, carried by the bridge."""
    jcfg, cfg = _cfgs(n_layers)
    jp = jax.jit(jg.init, static_argnums=1,
                 compiler_options=FAST_COMPILE)(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(n_layers)

    def nudge(path, x):
        if "conv_b" in jax.tree_util.keystr(path):
            return x + jnp.asarray(
                rng.standard_normal(x.shape).astype(np.float32) * 0.1)
        return x
    jp = jax.tree_util.tree_map_with_path(nudge, jp)
    return jcfg, cfg, jp, bridge.from_jax_tree(_to_numpy_tree(jp),
                                               device="cpu")


def _tokens(S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


@functools.cache
def _jax_steps(n_layers, S):
    """JAX's prefill of a seeded (B, S) batch, then STEPS decode steps:
    [(logits, cache)] (the prefill's first), and the step tokens."""
    jcfg, _, jp, _ = _setup(n_layers)
    pre = jax.jit(lambda p, t: jg.prefill(p, jcfg, {"tokens": t}),
                  compiler_options=FAST_COMPILE)
    dec = jax.jit(lambda p, c, t, pos: jg.decode_step(p, jcfg, c, t, pos),
                  compiler_options=FAST_COMPILE)
    out = [pre(jp, _tokens(S, S))]
    steps = _tokens(STEPS, S + 1)
    for i in range(STEPS):
        out.append(dec(jp, out[-1][1], steps[:, i:i + 1], jnp.int32(S + i)))
    return out, steps


# -------------------------------------------------------- building blocks ---
@pytest.mark.parametrize("T", [1, 2, 3, 5, 8, 13, 37])
def test_associative_scan_bit_identical_to_lax(T):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (2, T, 8)).astype(np.float32)
    b = rng.standard_normal((2, T, 8)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]
    ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ta, tb = tg.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_jax(carry):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32) if carry \
        else None
    jy, jst = jax.jit(jg._causal_conv)(x, w, b, st)
    t = lambda a: None if a is None else torch.from_numpy(a)
    ty, tst = tg._causal_conv(t(x), t(w), t(b), t(st))
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("T", [1, 7, 24])
def test_rg_lru_matches_jax_with_a_carry(T):
    _, _, jp, port = _setup(6)
    jrec = jax.tree_util.tree_map(lambda a: a[0], jp["groups"]["rec1"])
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, 128)).astype(np.float32)
    h0 = rng.standard_normal((2, 128)).astype(np.float32)
    jh, jlast = jax.jit(jg._rg_lru)(jrec, x, h0)
    th, tlast = tg._rg_lru(port["groups"][0]["rec1"], torch.from_numpy(x),
                           torch.from_numpy(h0))
    _close(th, jh)
    _close(tlast, jlast)
    assert tlast.dtype == torch.float32


def test_init_matches_jax_shapes_and_layout():
    for n in DEPTHS:
        jcfg, cfg, jp, port = _setup(n)
        assert tg.layout(cfg) == jg.layout(jcfg) == {6: (2, 0),
                                                     8: (2, 2)}[n]
        own = tg.init(cfg, seed=0, device="cpu")
        shapes = lambda t: {k: v.shape for k, v in _flat(t).items()}
        assert shapes(own) == shapes(port) == shapes(_to_numpy_tree(jp))
        assert own["groups"][0]["rec1"]["rg_lru_wa"].dtype == torch.float32
    full = t_arch("recurrentgemma-9b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.window, full.lru_width, full.d_ff,
            full.vocab) == (38, 4096, 16, 1, 256, 2048, 4096, 12288, 256000)
    assert tg.layout(full) == (12, 2)
    assert get_model(full) is tg


# ------------------------------------------------------------- the model ---
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_forward_matches_jax(n_layers):
    jcfg, cfg, jp, port = _setup(n_layers)
    toks = _tokens(LONG, 1)
    want, none = jax.jit(lambda p, t: jg.forward(p, jcfg, {"tokens": t}),
                         compiler_options=FAST_COMPILE)(jp, toks)
    assert none is None
    with torch.no_grad():
        got, cache = tg.forward(port, cfg, {"tokens": torch.from_numpy(
            toks).long()})
    assert cache is None and got.dtype == torch.float32
    _close(got, want)


def _check_cache(got: tg.GriffinCache, want):
    for name, g, w in zip(tg.GriffinCache._fields, got, want):
        if name == "attn_pos":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)


@pytest.mark.parametrize("n_layers", DEPTHS)
@pytest.mark.parametrize("S", [SHORT, LONG])
def test_prefill_and_decode_match_jax(n_layers, S):
    """The prefill's logits and every part of the cache (the ring padded
    to the window's 16 rows at S=12, the last 16 positions in ring order
    at S=24), then STEPS decode steps, each writing ring row pos % 16."""
    _, cfg, _, port = _setup(n_layers)
    ref, steps = _jax_steps(n_layers, S)
    with torch.no_grad():
        logits, cache = tg.prefill(port, cfg, {"tokens": torch.from_numpy(
            _tokens(S, S)).long()}, max_len=64)
        _close(logits, ref[0][0])
        _check_cache(cache, ref[0][1])
        assert cache.attn_k.shape[2] == cfg.window == 16
        for i in range(STEPS):
            logits, cache = tg.decode_step(
                port, cfg, cache, torch.from_numpy(steps[:, i:i + 1]).long(),
                S + i)
            assert logits.shape == (B, 1, cfg.vocab)
            _close(logits, ref[i + 1][0])
            _check_cache(cache, ref[i + 1][1])
    sp = cache.attn_pos[0].tolist()
    assert sp[(S + STEPS - 1) % 16] == S + STEPS - 1


# ------------------------------------------------------ quantized trees ---
@functools.cache
def _jax_int4():
    """JAX's SplitQuant INT4 k=3 quantize_tree of the 8-layer weights,
    jitted once, and its report."""
    _, _, jp, _ = _setup(8)
    rep = {}

    def run(key, p):
        tree, r = quantize_tree(key, p, QuantPolicy(cfg=QuantConfig(bits=4)))
        rep.update(r)
        return tree
    return jax.jit(run, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(1), jp), rep


CONV_PATHS = {"groups/rec1/conv_w", "groups/rec1/conv_b",
              "groups/rec2/conv_w", "groups/rec2/conv_b", "tail/conv_w",
              "tail/conv_b"}


@functools.cache
def _port_int4():
    """The port's own SplitQuant INT4 k=3 quantize_tree of its seeded
    8-layer init, and its report."""
    _, cfg = _cfgs(8)
    return tapply.quantize_tree(tg.init(cfg, seed=0, device="cpu"),
                                tapply.QuantPolicy(
                                    cfg=tapply.QuantConfig(bits=4)))


def test_int4_tree_through_the_bridge():
    """JAX's INT4 tree: the conv taps (a (4, lru) leaf) packed like a
    matrix and the conv bias kept as a SplitQuantTensor, both dequantized
    bit-identical to JAX's; the gates never quantized; the prefill and a
    decode step over the packed tree within tolerance of the port's over
    its ``dequantize_tree`` (the fp32 forward the tests above hold to
    JAX's; the wave ``Server`` below holds the packed tree's tokens to
    JAX's); the port's own quantize_tree quantizes the same paths."""
    _, cfg, _, _ = _setup(8)
    qtree, rep = _jax_int4()
    assert CONV_PATHS <= set(rep["quantized"])
    assert not any("rg_lru" in p for p in rep["quantized"])
    port = bridge.from_jax_tree(_to_numpy_tree(qtree), device="cpu")
    for stack, names in (("groups", ("rec1", "rec2")), ("tail", (None,))):
        for i in range(2):
            for name in names:
                tp = port[stack][i] if name is None else \
                    port[stack][i][name]
                jq = qtree[stack] if name is None else qtree[stack][name]
                assert isinstance(tp["conv_w"], PackedWeight)
                assert isinstance(tp["conv_b"], SplitQuantTensor)
                assert isinstance(tp["rg_lru_wa"], torch.Tensor)
                for leaf in ("conv_w", "conv_b"):
                    np.testing.assert_array_equal(
                        tg.materialize(tp[leaf]).numpy(),
                        np.asarray(jq[leaf].dequantize())[i])
    deq = tapply.dequantize_tree(port)
    toks = torch.from_numpy(_tokens(LONG, 5)).long()
    nxt = torch.from_numpy(_tokens(1, 6)).long()
    with torch.no_grad():
        for p in (port, deq):
            lg, c = tg.prefill(p, cfg, {"tokens": toks})
            p["out"] = (lg, tg.decode_step(p, cfg, c, nxt, LONG)[0])
    for got, want in zip(port.pop("out"), deq.pop("out")):
        _close(got, want.numpy())
    own, orep = _port_int4()
    assert set(orep["per_path"]) == set(rep["quantized"])
    assert isinstance(own["tail"][1]["conv_w"], PackedWeight)


def test_layer_by_layer_build_equals_whole_tree():
    """``build_params`` hands each block to the quantizer as
    ``griffin.init`` draws it: the same codes, scales and report as
    ``quantize_tree(init(...))``."""
    from repro_torch.launch.serve import build_params
    _, cfg = _cfgs(8)
    parts, rep = build_params(cfg, bits=4, method="splitquant", seed=0,
                              device="cpu")
    whole, wrep = _port_int4()
    assert rep["per_path"] == wrep["per_path"]
    assert rep["deployed_bytes"] == wrep["deployed_bytes"]
    for a, b in zip(tapply._walk(parts, (), 1), tapply._walk(whole, (), 1)):
        assert a[0] == b[0]
        la, lb = a[4], b[4]
        if isinstance(la, PackedWeight):
            for f in ("qp", "cp", "scale", "zero"):
                assert torch.equal(getattr(la, f), getattr(lb, f)), a[0]
        elif isinstance(la, SplitQuantTensor):
            assert torch.equal(la.q, lb.q) and torch.equal(la.scale,
                                                           lb.scale)
        else:
            assert torch.equal(la, lb), a[0]


# --------------------------------------------------------------- serving ---
def test_server_matches_jax(monkeypatch):
    """JAX's wave ``Server`` and the port's over the 8-layer INT4 tree:
    two waves of four left-padded with token 0 and no pad mask (the pads
    enter the RG-LRU state and the ring, as in JAX), padded to 20 (past
    the window of 16) and to 14 (within it, the ring wrapping during
    decode), budgets mixed: identical greedy tokens."""
    jcfg, cfg, _, _ = _setup(8)
    qtree, _ = _jax_int4()
    port = bridge.from_jax_tree(_to_numpy_tree(qtree), device="cpu")
    rng = np.random.default_rng(9)
    lens = [5, 20, 11, 3, 9, 14, 2, 7]
    budgets = [None, 3, None, 0, 6, None, 1, None]
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in lens]
    monkeypatch.setattr(jg, "prefill", jax.jit(
        jg.prefill, static_argnames=("cfg", "max_len"),
        compiler_options=FAST_COMPILE))
    scfg = dict(max_batch=4, max_new_tokens=6)
    jreqs = [jsl.Request(i, p, b) for i, (p, b) in
             enumerate(zip(prompts, budgets))]
    jsl.Server(jcfg, qtree, jsl.ServeConfig(**scfg)).serve(jreqs)
    srv = tsl.Server(cfg, port, tsl.ServeConfig(**scfg), device="cpu")
    treqs = srv.serve([tsl.Request(i, p, b) for i, (p, b) in
                       enumerate(zip(prompts, budgets))])
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [len(r.out) for r in treqs] == [6, 3, 6, 0, 6, 6, 1, 6]
    assert len(srv.wave_prefill_s) == 2 and len(srv.decode_step_s) == 10


def test_serve_cli_and_refusals(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "recurrentgemma-9b", "--reduced", "--requests", "3",
          "--max-new-tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "wave loop" in out
    with pytest.raises(NotImplementedError, match="griffin cannot serve "
                                                  "speculative"):
        main(["--arch", "recurrentgemma-9b", "--reduced", "--spec-k", "3",
              "--device", "cpu"])
    jcfg, cfg, jp, port = _setup(6)
    toks = np.zeros((1, 8), np.int32)
    pad = np.zeros((1, 8), bool)
    pairs = [(lambda: jg.prefill(jp, jcfg, {"tokens": toks}, pad_mask=pad),
              lambda: tg.prefill(port, cfg, {"tokens": torch.from_numpy(
                  toks).long()}, pad_mask=torch.from_numpy(pad))),
             (lambda: jg.prefill(jp, jcfg, {"tokens": toks}, moe_blocks=2),
              lambda: tg.prefill(port, cfg, {"tokens": torch.from_numpy(
                  toks).long()}, moe_blocks=2)),
             (jg.verify_step_slots, tg.verify_step_slots)]
    for jfn, tfn in pairs:       # the JAX package's messages, word for word
        with pytest.raises(NotImplementedError) as want:
            jfn()
        with pytest.raises(NotImplementedError) as got:
            tfn()
        assert str(got.value) == str(want.value)


# -------------------------------------------------------------- training ---
def test_loss_and_grads_match_jax():
    jcfg, cfg, jp, port = _setup(8)
    toks = _tokens(LONG, 11)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -3:] = -1
    batch = {"tokens": toks, "labels": labels}
    (jl, _), jgr = jax.jit(jax.value_and_grad(
        lambda p: jg.loss_fn(p, jcfg, batch), has_aux=True),
        compiler_options=FAST_COMPILE)(jp)
    tp = _with_grad(port, [])
    loss, m = tg.loss_fn(tp, cfg, {k: torch.from_numpy(v).long()
                                   for k, v in batch.items()})
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(m["loss"].detach()) == loss
    got, want = _flat(_grads(tp)), _flat(_to_numpy_tree(jgr))
    assert set(got) == set(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-6), (k, err)


def test_train_cli_trains_griffin(capsys):
    from repro_torch.launch import train as ttrain
    out = ttrain.main(["--arch", "recurrentgemma-9b", "--reduced",
                       "--steps", "3", "--batch", "2", "--seq", "16",
                       "--device", "cpu"])
    assert len(out["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert "final loss" in capsys.readouterr().out.splitlines()[-1]
    assert isinstance(out["params"]["groups"][1]["rec2"]["rg_lru_wa"],
                      torch.Tensor)
