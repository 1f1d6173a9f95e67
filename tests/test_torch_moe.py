"""Port parity, the MoE family: the port's MoE layer, stacked expert
quantization, bridge, checkpoints, layer-by-layer build, the grouped
product's plain version and the engine, against the JAX package on
reduced moonshot-v1-16b-a3b (1 dense + 1 MoE layer of 8 experts top-2, 2
shared; fp32) and, at the MoE layer only, reduced kimi-k2-1t-a32b.

Tolerances: the router's top-k (the experts chosen) identical; MoE
outputs atol 1e-4 of the output's scale and the aux loss rtol 1e-5 (fp32
einsums summed in another order); expert codes, ids and scales
bit-identical given JAX's centroids; report bytes, checkpoint arrays and
manifests identical; the grouped product's plain version (q·recip +
shift) within 1e-5 of the output's scale of eq. 4's dequantize + matmul
(two roundings of the weight); engine greedy tokens identical (int8
dynamic cache, prompts spanning chunks; static scales against JAX's
chunked engine).
"""
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jck
from repro.configs import get_arch
from repro.core import QuantConfig, QuantPolicy, quantize_tree
from repro.core.kmeans import kmeans_1d as j_kmeans
from repro.core.splitquant import SplitQuantTensor as JSQT
from repro.core.splitquant import baseline_quant_tensor as j_baseline
from repro.core.splitquant import splitquant_tensor as j_splitquant
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.models import ffn as jffn
from repro.models import get_model

from repro_torch import bridge, calib
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import apply as tapply
from repro_torch.core.quantize import QuantConfig as TQuantConfig
from repro_torch.core.splitquant import (assign_and_quantize,
                                         baseline_quant_tensor)
from repro_torch.engine import Engine, EngineConfig
from repro_torch.kernels.ops import PackedWeight, grouped_linear
from repro_torch.launch import serve as tserve
from repro_torch.models import ffn as tffn
from repro_torch.models import get_model as t_get_model
from repro_torch.models import transformer as tt
from repro_torch.runtime.serve_loop import Request, Server, ServeConfig

from test_torch_quant import _to_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

MOON, KIMI = "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"
FAST_COMPILE = {"xla_backend_optimization_level": 0}
ENGINE_KW = dict(n_slots=3, max_len=64, max_new_tokens=5, kv_mode="int8",
                 prefill_chunk=16)


def _np(a):
    return np.asarray(a)


@functools.cache
def _moon():
    """Reduced moonshot's fp32 weights (the port's seeded init) in both
    packages' trees; the port's INT4 ``quantize_tree`` of them and the
    same codes as a JAX tree of ``SplitQuantTensor``s, so both packages
    serve one set of weights (the codes' parity with JAX's quantizer is
    held by the stacked-expert test); JAX's ``quantize_tree`` report of
    the weights, from its trace alone (``jax.eval_shape``: the bytes
    depend only on shapes)."""
    cfg, tcfg = get_arch(MOON).reduced(), t_arch(MOON).reduced()
    dense = tt.init(tcfg, seed=0, device="cpu")
    params = _to_jax(dense)
    rep = {}

    def run(key, p):
        tree, r = quantize_tree(key, p, QuantPolicy(cfg=QuantConfig(bits=4)))
        rep.update(r)
        return tree
    jax.eval_shape(run, jax.random.PRNGKey(1), params)
    packed, trep = tapply.quantize_tree(
        dense, tapply.QuantPolicy(cfg=TQuantConfig(bits=4)), seed=0)
    return types.SimpleNamespace(
        cfg=cfg, tcfg=tcfg, jparams=params, jq=_to_jax(packed), jrep=rep,
        dense=dense, packed=packed, trep=trep)


def _to_jax(tree):
    """The port's tree as the JAX package holds it: each layer stack one
    (L, …) leaf, packed weights as ``SplitQuantTensor``s."""
    def leaf(parts):
        if isinstance(parts[0], PackedWeight):
            sq = [p.unpack() for p in parts]
            f = {k: jnp.stack([jnp.asarray(getattr(t, k).numpy())
                               for t in sq]) for k in ("q", "cid", "scale",
                                                       "zero")}
            return JSQT(**f, bits=parts[0].bits, k=parts[0].k,
                        orig_shape=tuple(parts[0].shape[-2:]),
                        orig_dtype=np.dtype(np.float32))
        return jnp.stack([jnp.asarray(p.numpy()) for p in parts])

    def stacked(layers):
        if isinstance(layers[0], dict):
            return {k: stacked([lay[k] for lay in layers])
                    for k in layers[0]}
        return leaf(layers)

    def one(node):
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        return jax.tree_util.tree_map(lambda a: a[0], leaf([node]))
    return {k: stacked(v) if k in ("layers", "moe_layers") else one(v)
            for k, v in tree.items()}


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@functools.cache
def _moe_layer(arch):
    """(JAX cfg, port cfg, JAX MoE params of one layer, the port's): the
    bridged INT4 layer of reduced moonshot, or an fp32 reduced kimi layer
    from JAX's ``init_moe``."""
    cfg, tcfg = get_arch(arch).reduced(), t_arch(arch).reduced()
    if arch == MOON:
        s = _moon()
        return cfg, tcfg, _layer0(s.jq["moe_layers"]["moe"]), \
            s.packed["moe_layers"][0]["moe"]
    jp = jffn.init_moe(jax.random.PRNGKey(4), cfg, jnp.float32)
    return cfg, tcfg, jp, bridge.from_jax_tree(_to_numpy_tree(jp),
                                               device="cpu")


# ------------------------------------------------------------ the layer ---
@pytest.mark.parametrize("T,cf,n_blocks", [
    (20, None, 1), (64, None, 2), (600, None, 1), (600, 0.5, 2)])
@pytest.mark.parametrize("arch", [MOON, KIMI])
def test_apply_moe_matches_jax(arch, T, cf, n_blocks):
    """The same experts, outputs and aux loss as JAX's ``apply_moe``:
    T <= 512 a block (no drops), T = 600 in one block (capacity
    Tb·K·cf // E, pairs past it dropped) and in two blocks of 300 at
    cf 0.5 (capacity per block)."""
    cfg, tcfg, jp, tp = _moe_layer(arch)
    x = np.random.default_rng(T + n_blocks).standard_normal(
        (2, T // 2, cfg.d_model)).astype(np.float32)
    jout, jaux = jax.jit(functools.partial(
        jffn.apply_moe, cfg=cfg, capacity_factor=cf, n_blocks=n_blocks))(
            jp, jnp.asarray(x))
    tout, taux = tffn.apply_moe(tp, torch.from_numpy(x), tcfg,
                                capacity_factor=cf, n_blocks=n_blocks)
    xt = x.reshape(T, -1)
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    jidx = _np(jax.lax.top_k(jprobs, cfg.top_k)[1])
    probs, _, tidx = tffn.route(tp, torch.from_numpy(xt), tcfg)
    margin = float(tffn.routing_margin(probs, tcfg.top_k))
    assert np.array_equal(tidx.numpy(), jidx), f"routing margin {margin}"
    scale = max(1.0, float(np.abs(_np(jout)).max()))
    np.testing.assert_allclose(tout.numpy(), _np(jout), atol=1e-4 * scale)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)


def test_positions_in_expert_and_capacity_drop_like_jax():
    """Position-in-expert from a stable sort, per block: JAX's dispatch
    positions; at T > 512 pairs past the capacity carry no weight."""
    rng = np.random.default_rng(3)
    flat = rng.integers(0, 8, (2, 300 * 2))
    pos = tffn.positions_in_expert(torch.from_numpy(flat), 8).numpy()
    for b in range(2):
        seen = {}
        for i, e in enumerate(flat[b]):
            assert pos[b, i] == seen.get(e, 0)
            seen[e] = seen.get(e, 0) + 1


# ------------------------------------------------------- quantization ---
@pytest.mark.parametrize("per_channel", [False, True])
def test_stacked_experts_identical_given_jax_centroids(per_channel):
    """A (E, d, f) expert leaf, each matrix on its own: given JAX's
    per-expert centroids, codes, ids, scales and zeros bit-identical to
    JAX's ``splitquant_tensor(stack_dims=...)`` of the layer."""
    s = _moon()
    w = s.jparams["moe_layers"]["moe"]["w_up"][0]            # (E, d, f)
    w = w + 0.5 * jnp.sign(w) * (jnp.abs(w) > 2 * jnp.std(w))  # outliers
    cfg = dict(bits=4, per_channel=per_channel)
    key = jax.random.PRNGKey(9)
    sq = jax.jit(lambda m: j_splitquant(key, m, QuantConfig(**cfg), k=3,
                                        stack_dims=1))(w)
    keys = jax.random.split(key, w.shape[:1])
    cents = jax.jit(jax.vmap(lambda kk, m: j_kmeans(
        kk, m.reshape(-1), k=3, iters=25).centroids))(keys, w)
    got = assign_and_quantize(torch.from_numpy(_np(w)),
                              torch.from_numpy(_np(cents)),
                              TQuantConfig(**cfg), stack_dims=1)
    for f in ("q", "cid", "scale", "zero"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(sq, f)), err_msg=f)
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  _np(sq.dequantize()))
    assert got.nbytes_deployed() == sq.nbytes_deployed()


@pytest.mark.parametrize("percentile", [None, 0.99])
def test_stacked_baseline_matches_jax(percentile):
    """The k=1 baselines of a (E, d, f) expert leaf, each matrix on its
    own, against JAX's evaluated eagerly: min/max ranges bit-identical;
    the percentile clip's scales within 1e-6 (one FMA apart, as
    tests/test_torch_quant_options bounds it) and codes within 1. (Jitted,
    XLA computes the vmapped percentile's interpolation another way: one
    scale of eight 1.6e-6 apart.)"""
    s = _moon()
    w = s.jparams["moe_layers"]["moe"]["w_down"][0]          # (E, f, d)
    cfg = dict(bits=4, percentile=percentile)
    sq = j_baseline(w, QuantConfig(**cfg), stack_dims=1)
    got = baseline_quant_tensor(torch.from_numpy(np.array(w)),
                                TQuantConfig(**cfg), stack_dims=1)
    assert got.scale.shape == sq.scale.shape == (w.shape[0], 1)
    if percentile is None:
        for f in ("q", "cid", "scale", "zero"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          _np(getattr(sq, f)), err_msg=f)
    else:
        np.testing.assert_allclose(got.scale.numpy(), _np(sq.scale),
                                   rtol=1e-6)
        assert np.abs(got.q.numpy().astype(int) - _np(sq.q)).max() <= 1


@pytest.mark.parametrize("method", ["splitquant", "baseline",
                                    "percentile"])
def test_quantize_tree_report_matches_jax_and_keeps_the_router(method):
    """The port's ``quantize_tree`` of the same fp32 tree, each method:
    the JAX paths, per-path bits / k / method / bytes and the totals as
    JAX counts them; the router (and the norms, the embedding) left fp32;
    every expert leaf one stacked packed weight."""
    s = _moon()
    jrep, qtree, rep = s.jrep, s.packed, s.trep
    if method != "splitquant":
        jrep = {}

        def run(key, p):
            tree, r = quantize_tree(key, p, QuantPolicy(
                cfg=QuantConfig(bits=4), method=method))
            jrep.update(r)
            return tree
        jax.eval_shape(run, jax.random.PRNGKey(1), s.jparams)
        qtree, rep = tapply.quantize_tree(
            s.dense, tapply.QuantPolicy(cfg=TQuantConfig(bits=4),
                                        method=method), seed=0)
    assert rep["per_path"] == jrep["per_path"]
    for k in ("deployed_bytes", "orig_bytes"):
        assert rep[k] == jrep[k], k
    moe = qtree["moe_layers"][0]["moe"]
    assert isinstance(moe["router"], torch.Tensor) and \
        moe["router"].dtype == torch.float32
    E, d, f = s.cfg.n_experts, s.cfg.d_model, s.cfg.d_ff
    assert moe["w_gate"].shape == (E, d, f) and moe["w_gate"].stack_dims == 1
    assert moe["w_down"].qp.shape == (E, f * 4 // 8, d)
    assert "moe_layers/moe/router" not in rep["per_path"]
    with pytest.raises(ValueError, match="matched no"):
        tapply.quantize_tree(s.dense, tapply.QuantPolicy(),
                             overrides={"moe_layers/0/moe/w_gate": {}})


def test_layer_by_layer_build_equals_quantize_tree_of_init():
    """``build_params`` quantizes each part as ``init`` draws it: the same
    packed bytes and report as ``quantize_tree(init(...))`` (the dense
    prelude layer and the MoE layer, each leaf's k-means seed by its
    index in the whole tree)."""
    s = _moon()
    got, rep = tserve.build_params(s.tcfg, bits=4, method="splitquant",
                                   seed=0, device="cpu")
    assert rep == s.trep
    _assert_trees_equal(got, s.packed)


# ------------------------------------------------ bridge, checkpoints ---
def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    elif isinstance(want, PackedWeight):
        assert isinstance(got, PackedWeight)
        assert (got.bits, got.k, got.shape, got.orig_dtype) == \
            (want.bits, want.k, want.shape, want.orig_dtype)
        for f in ("qp", "cp", "recip", "shift", "scale", "zero"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


def _logits(cfg, params):
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
    with torch.no_grad():
        return tt.forward(params, cfg, {"tokens": torch.from_numpy(toks)})[0]


def test_bridge_unstacks_the_moe_tree():
    """JAX's (L, E, d, f) expert leaves become one stacked packed weight a
    layer (the port's own packing of the same codes), dequantizing to
    JAX's values bit for bit; the two stacks split as JAX's scan splits
    them; the port's forward matches JAX's."""
    s = _moon()
    got = bridge.from_jax_tree(_to_numpy_tree(s.jq), device="cpu")
    _assert_trees_equal(got, s.packed)
    assert len(got["layers"]) == 1 and len(got["moe_layers"]) == 1
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            got["moe_layers"][0]["moe"][name].dequantize().numpy(),
            _np(s.jq["moe_layers"]["moe"][name].dequantize())[0])
    toks = np.random.default_rng(0).integers(0, s.cfg.vocab, (2, 12))
    jl = jax.jit(lambda p, t: get_model(s.cfg).forward(
        p, s.cfg, {"tokens": t})[0])(s.jq, jnp.asarray(toks))
    tl = _logits(s.tcfg, got)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """JAX saves the INT4 MoE tree; the port restores it into its own
    seeded dense init (expert leaves back as stacked packed weights, no
    k-means): the bridge's tree, logits bit-identical."""
    s = _moon()
    jck.save(str(tmp_path), 2, s.jq)
    got, step = ckpt.restore(str(tmp_path), tt.init(s.tcfg, seed=5,
                                                    device="cpu"))
    assert step == 2
    _assert_trees_equal(got, s.packed)
    np.testing.assert_array_equal(_logits(s.tcfg, got).numpy(),
                                  _logits(s.tcfg, s.packed).numpy())


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port saves the bridged MoE tree: expert leaves stacked
    (L, E, …) under JAX's keystr paths, the manifest equal to the one JAX
    writes, and JAX's restore gives the same leaves."""
    s = _moon()
    ckpt.save(str(tmp_path / "t"), 0, s.packed)
    jck.save(str(tmp_path / "j"), 0, s.jq)
    man = {}
    for w in ("t", "j"):
        with open(os.path.join(tmp_path, w, "step_00000000",
                               "manifest.json")) as f:
            man[w] = json.load(f)
    assert man["t"] == man["j"]
    key = "['moe_layers']['moe']['w_gate']"
    E, d, f = s.cfg.n_experts, s.cfg.d_model, s.cfg.d_ff
    assert man["t"]["shapes"][f"{key}.q"] == [1, E, d, f]
    assert man["t"]["quant_meta"][key]["orig_shape"] == [d, f]
    restored, _ = jck.restore(str(tmp_path / "t"), s.jparams)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(s.jq),
                                jax.tree_util.tree_leaves_with_path(restored)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(_np(a), _np(b))


# -------------------------------------------------- the grouped product ---
def test_grouped_linear_plain_matches_per_expert_dequantize():
    """The grouped product's plain version (the CPU path of
    ``grouped_linear``): each expert's rows times eq. 4's dequantized
    matrix, empty experts and a heavy one included."""
    w = _moon().packed["moe_layers"][0]["moe"]["w_down"]
    counts = [3, 0, 0, 17, 1, 0, 9, 2]
    off = np.concatenate([[0], np.cumsum(counts)])
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (off[-1], w.shape[1])).astype(np.float32))
    got = grouped_linear(x, torch.from_numpy(off.astype(np.int32)), w)
    deq = w.dequantize()
    want = torch.cat([x[off[e]:off[e + 1]] @ deq[e]
                      for e in range(len(counts))])
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale
    with pytest.raises(ValueError, match="stack"):
        grouped_linear(x, torch.from_numpy(off.astype(np.int32)),
                       _moon().packed["lm_head"])


# ------------------------------------------------------------ the engine ---
def _prompts(cfg, n=4):
    rng = np.random.default_rng(7)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(3, 40)))
            for _ in range(n)]


@functools.cache
def _jax_engine(static: bool):
    s = _moon()
    scales = _scales() if static else None
    eng = JEngine(s.cfg, s.jq, JEngineConfig(**ENGINE_KW, flight=False,
                                             metrics=False),
                  kv_scales=scales)
    for p in _prompts(s.cfg):
        eng.submit(p)
    return [r.out for r in eng.drain()]


@functools.cache
def _scales():
    """Static KV scales from the port's calibration of the bridged tree."""
    s = _moon()
    rng = np.random.default_rng(0)
    stats = calib.collect_kv_stats(
        s.tcfg, s.packed, [rng.integers(0, s.cfg.vocab, (2, 40))])
    return calib.kv_static_scales(stats)


@pytest.mark.parametrize("static", [False, True])
def test_engine_greedy_tokens_match_jax(static):
    """Greedy tokens of the port's engine equal the JAX engine's on
    reduced moonshot over an int8 cache, prompts spanning 16-token
    chunks, dynamic scales or static ones (JAX's chunked engine)."""
    s = _moon()
    eng = Engine(s.tcfg, s.packed, EngineConfig(**ENGINE_KW), device="cpu",
                 kv_scales=_scales() if static else None)
    for p in _prompts(s.cfg):
        eng.submit(p)
    fin = eng.drain()
    assert [r.finish_reason for r in fin] == ["budget"] * 4
    assert eng.cache.static == static
    assert [r.out for r in fin] == _jax_engine(static)


def test_moe_paths_not_ported_raise():
    """Speculation over MoE and the wave loop over MoE serve (they raised
    until both were ported); ``get_model`` maps the family to the
    transformer."""
    s = _moon()
    assert t_get_model(s.tcfg) is tt
    eng = Engine(s.tcfg, s.packed, EngineConfig(
        n_slots=1, max_len=64, max_new_tokens=3, kv_mode="int8", spec_k=2),
        device="cpu")
    eng.submit(_prompts(s.cfg, 1)[0])
    assert [len(r.out) for r in eng.drain()] == [3] and eng.n_spec_steps
    reqs = [Request(uid=0, prompt=_prompts(s.cfg, 1)[0])]
    Server(s.tcfg, s.packed, ServeConfig(max_new_tokens=3),
           device="cpu").serve(reqs)
    assert len(reqs[0].out) == 3


# ------------------------------------------------- speculation over MoE ---
SPEC_KW = dict(n_slots=3, max_len=64, max_new_tokens=6, kv_mode="int8",
               prefill_chunk=16, spec_k=3)


@functools.cache
def _draft():
    """The port's INT8 SplitQuant of reduced moonshot's weights (it
    accepts some of its proposals and rejects others; an INT2 draft
    rejects them all here), and the same codes as a JAX tree."""
    packed, _ = tapply.quantize_tree(
        _moon().dense, tapply.QuantPolicy(cfg=TQuantConfig(bits=8)), seed=0)
    return packed, _to_jax(packed)


def test_spec_over_moe_matches_jax_and_greedy():
    """The speculative engine over reduced moonshot (spec_k 3, an INT8
    draft, an int8 cache): the JAX speculative engine's tokens and its
    proposed / accepted counts (some accepted, some not), and the greedy
    engine's tokens."""
    s = _moon()
    draft, jdraft = _draft()
    prompts = _prompts(s.cfg)
    jeng = JEngine(s.cfg, s.jq, JEngineConfig(**SPEC_KW, flight=False,
                                              metrics=False),
                   draft_params=jdraft)
    eng = Engine(s.tcfg, s.packed, EngineConfig(**SPEC_KW), device="cpu",
                 draft_params=draft)
    for e in (jeng, eng):
        for p in prompts:
            e.submit(p)
    jout = [r.out for r in jeng.drain()]
    out = [r.out for r in eng.drain()]
    greedy = Engine(s.tcfg, s.packed, EngineConfig(
        **dict(SPEC_KW, spec_k=0)), device="cpu")
    for p in prompts:
        greedy.submit(p)
    assert out == jout
    assert out == [r.out for r in greedy.drain()]
    counts = (eng.sched.spec_proposed, eng.sched.spec_accepted)
    assert counts == (jeng.sched.spec_proposed, jeng.sched.spec_accepted)
    assert 0 < counts[1] < counts[0] and eng.n_spec_steps


# ----------------------------------------------------- the wave loop ---
def _record_drops(monkeypatch):
    """Each MoE dispatch of more than 512 tokens, as the list of its
    dropped (block, pair) masks, in both packages: the port's from
    ``ffn.dispatch``, JAX's from ``_dispatch_block`` (a pair is dropped
    where its source weight is 0) through a debug callback."""
    rec = {"port": [], "jax": []}
    dispatch, block = tffn.dispatch, jffn._dispatch_block

    def port(eidx, n_blocks, E, C):
        out = dispatch(eidx, n_blocks, E, C)
        if eidx.shape[0] // n_blocks > 512:
            rec["port"].append((~out[2]).numpy())
        return out

    def jax_block(xt, gate, eidx, E, K, C, dtype):
        out = block(xt, gate, eidx, E, K, C, dtype)
        if xt.shape[0] > 512:
            jax.debug.callback(lambda w: rec["jax"].append(
                np.asarray(w)[None, :, 0] == 0), out[3])
        return out
    monkeypatch.setattr(tffn, "dispatch", port)
    monkeypatch.setattr(jffn, "_dispatch_block", jax_block)
    return rec


def test_moe_wave_drops_the_pairs_jax_drops(monkeypatch):
    """The wave ``Server`` over reduced moonshot, a first wave of four
    prompts left-padded to 200 tokens (800 routed as one block, capacity
    int(800·2·1.25) // 8 = 250 a block and expert; the pads route alike and
    overflow theirs) and a second of two: the dropped pairs equal JAX's in
    count and position, and the tokens equal the JAX ``Server``'s."""
    from repro.runtime import serve_loop as jsl
    s = _moon()
    rng = np.random.default_rng(11)
    lens = [200, 17, 60, 3, 9, 31]
    prompts = [rng.integers(0, s.cfg.vocab, size=n) for n in lens]
    scfg = dict(max_batch=4, max_new_tokens=4, max_len=208)
    rec = _record_drops(monkeypatch)
    jreqs = [jsl.Request(uid=i, prompt=p.astype(np.int32))
             for i, p in enumerate(prompts)]
    jsl.Server(s.cfg, s.jq, jsl.ServeConfig(**scfg)).serve(jreqs)
    jax.effects_barrier()
    reqs = [Request(uid=i, prompt=p) for i, p in enumerate(prompts)]
    srv = Server(s.tcfg, s.packed, ServeConfig(**scfg), device="cpu")
    srv.serve(reqs)
    assert len(rec["port"]) == len(rec["jax"]) == 1     # one MoE layer
    for got, want in zip(rec["port"], rec["jax"]):
        assert got.shape == want.shape == (1, 800 * 2)
        assert got.sum() > 0
        np.testing.assert_array_equal(got, want)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert all(len(r.out) == 4 for r in reqs)
