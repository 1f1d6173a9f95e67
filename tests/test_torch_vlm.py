"""Port parity, the VLM family (paligemma-3b): its patch prefix and tied
head through ``transformer.forward`` / ``prefill``, the engine and the
wave ``Server``, head_dim 256 through the three cache kernels' plain
versions, a float16 fp cache, the tied head over a quantized embedding
table, and the bridge and checkpoints of a tied tree.

Weights: JAX's seeded ``init`` of reduced paligemma (fp32, 2 layers,
d_model 128, MQA 4/1 at head_dim 32, 8 patch embeds, a tied head) and of
a narrow head_dim-256 variant (``n_heads=2, n_kv_heads=1,
d_model=512``), carried over by the bridge; reduced paligemma's JAX
SplitQuant INT4 k=3 tree (one jitted ``quantize_tree``) for the engine,
the wave loop and the checkpoints. Every JAX tree and run is built once
a module (``functools.cache``).

Tolerances: fp32 logits atol 1e-4 (the same sums in another order);
greedy tokens identical; the cache kernels' codes and scales bit for
bit and their fp32 outputs atol 1e-5 (summation order; 16-bit cache
values are exact in fp32); the quantized table's codes, ids and scales
bit for bit; checkpoint arrays identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jck
from repro.configs import get_arch
from repro.core import QuantConfig, QuantPolicy, quantize_tree
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine.kvcache import quantize_kv as j_quantize_kv
from repro.engine.kvcache import quantize_kv_static as j_quantize_kv_static
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.prefill_attention import prefill_attention as j_prefill
from repro.models import get_model
from repro.models import transformer as jt
from repro.runtime import serve_loop as jsl

from repro_torch import bridge
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import apply as tapply
from repro_torch.core.quantize import QuantConfig as TQuantConfig
from repro_torch.engine import Engine, EngineConfig
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.ops import PackedWeight
from repro_torch.kernels.prefill_attention import (
    prefill_attention, prefill_attention_ref, quantize_kv,
    quantize_kv_static, write_kv_rows)
from repro_torch.launch import serve as tserve
from repro_torch.models import get_model as t_get_model
from repro_torch.models import transformer as tt
from repro_torch.runtime import serve_loop as tsl

from test_torch_calib import _assert_trees_equal, _manifest, _no_kmeans
from test_torch_quant import _to_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

VLM = "paligemma-3b"
KEY = jax.random.PRNGKey(0)
FAST_COMPILE = {"xla_backend_optimization_level": 0}
LOGIT_ATOL = 1e-4
ATOL = 1e-5
D, C = 256, 4
MODES = ["dynamic", "static", "fp32", "bf16", "f16"]
J = jnp.asarray
#: the head_dim-256 variant's widths (paligemma-3b's D and MQA)
WIDE = dict(n_heads=2, n_kv_heads=1, d_model=512)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(wide: bool):
    """(JAX cfg, port cfg): reduced paligemma, or its head_dim-256
    variant."""
    cfg, tcfg = get_arch(VLM).reduced(), t_arch(VLM).reduced()
    if wide:
        cfg, tcfg = (dataclasses.replace(c, **WIDE) for c in (cfg, tcfg))
    return cfg, tcfg


@functools.cache
def _fp32(wide: bool):
    """(JAX cfg, port cfg, JAX fp32 params, the bridged port tree)."""
    cfg, tcfg = _cfgs(wide)
    params = get_model(cfg).init(KEY, cfg)
    port = bridge.from_jax_tree(_to_numpy_tree(params), device="cpu")
    return cfg, tcfg, params, port


@functools.cache
def _int4():
    """Reduced paligemma's JAX INT4 SplitQuant tree (jitted once) and the
    same tree through the bridge."""
    cfg, tcfg, params, _ = _fp32(False)
    pol = QuantPolicy(cfg=QuantConfig(bits=4))
    jq = jax.jit(lambda k, p: quantize_tree(k, p, pol)[0],
                 compiler_options=FAST_COMPILE)(jax.random.PRNGKey(1),
                                                params)
    return jq, bridge.from_jax_tree(_to_numpy_tree(jq), device="cpu")


def _batch(cfg, seed, S=12, patches=True):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)}
    if patches:
        out["patch_embeds"] = rng.standard_normal(
            (2, cfg.n_prefix_embeds, tt.VLM_PATCH_DIM)).astype(np.float32)
    return out


def _prompts(cfg, n=4, seed=7, lo=3, hi=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(lo, hi)))
            for _ in range(n)]


# ---------------------------------------------------------------- model ---
def test_config_and_init_match_jax():
    """The port's paligemma-3b config is JAX's, ``reduced()`` too (D=32,
    8 prefix embeds); ``init`` draws ``patch_proj`` and no ``lm_head``,
    the JAX tree's shapes; ``get_model`` maps vlm to the transformer."""
    for full in (get_arch(VLM), get_arch(VLM).reduced()):
        mine = t_arch(VLM) if full.n_layers == 18 else t_arch(VLM).reduced()
        assert dataclasses.asdict(mine) == dataclasses.asdict(full)
    red = t_arch(VLM).reduced()
    assert (red.head_dim, red.n_prefix_embeds, red.n_kv_heads) == (32, 8, 1)
    assert t_arch(VLM).head_dim == 256
    cfg, tcfg, params, _ = _fp32(False)
    mine = tt.init(tcfg, seed=0, device="cpu")
    assert t_get_model(tcfg) is tt
    assert "lm_head" not in mine and "lm_head" not in params
    assert tuple(mine["patch_proj"].shape) == params["patch_proj"].shape \
        == (tt.VLM_PATCH_DIM, cfg.d_model)
    assert set(mine) == set(params)


@pytest.mark.parametrize("patches", [False, True])
@pytest.mark.parametrize("wide", [False, True])
def test_forward_matches_jax(wide, patches):
    """``forward`` with and without 8 patch embeds, at reduced paligemma
    (D=32) and at head_dim 256: logits (B, P + S, V) as JAX's
    (tests/test_models.py's shape), within the fp32 tolerance."""
    cfg, tcfg, params, port = _fp32(wide)
    b = _batch(cfg, 1, patches=patches)
    want = np.asarray(jt.forward(params, cfg, {k: J(v) for k, v in
                                               b.items()})[0])
    got = tt.forward(port, tcfg, {k: _t(v) for k, v in b.items()})[0]
    P = cfg.n_prefix_embeds if patches else 0
    assert got.shape == want.shape == (2, P + 12, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_prefill_with_patches_then_decode_matches_jax():
    """``prefill`` of 8 patch embeds and 12 tokens into a 24-row cache,
    then two decode steps at positions 20 and 21: logits, the cache's K/V
    and positions as JAX's."""
    cfg, tcfg, params, port = _fp32(False)
    b = _batch(cfg, 2)
    jl, jc = jt.prefill(params, cfg, {k: J(v) for k, v in b.items()},
                        max_len=24)
    tl, tc = tt.prefill(port, tcfg, {k: _t(v) for k, v in b.items()},
                        max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tc.slot_pos.numpy(), np.asarray(
        jc.slot_pos))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for pos in (20, 21):
        jl, jc = jt.decode_step(params, cfg, jc, J(tok), jnp.int32(pos))
        tl, tc = tt.decode_step(port, tcfg, tc, _t(tok).long(), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5)


# --------------------------------------------------------------- engine ---
ENGINE_KW = dict(n_slots=3, max_len=64, max_new_tokens=5, kv_mode="int8",
                 prefill_chunk=16)


@functools.cache
def _jax_engine(wide: bool, spec_k: int = 0):
    """JAX's greedy tokens over the INT4 tree (D=32) or the fp32 head_dim
    256 variant, an int8 dynamic cache and 16-token chunks; spec_k > 0
    drafts with the fp32 tree."""
    cfg, _, params, _ = _fp32(wide)
    target = params if wide else _int4()[0]
    eng = JEngine(cfg, target, JEngineConfig(
        **ENGINE_KW, spec_k=spec_k, flight=False, metrics=False),
        draft_params=params if spec_k else None)
    for p in _prompts(cfg):
        eng.submit(p)
    fin = eng.drain()
    return [r.out for r in fin], eng.sched.spec_proposed, \
        eng.sched.spec_accepted


@pytest.mark.parametrize("wide,spec_k", [(False, 0), (True, 0), (False, 3)])
def test_engine_matches_jax(wide, spec_k):
    """The engine over the INT4 tree (and at head_dim 256 over the fp32
    variant, chunks of 64 columns), int8 dynamic cache, prompts spanning
    16-token chunks: JAX's greedy tokens; with spec_k 3 (the fp32 tree
    drafting for the INT4 target) the same tokens, proposals and
    acceptances."""
    cfg, tcfg, params, port = _fp32(wide)
    target = port if wide else _int4()[1]
    eng = Engine(tcfg, target, EngineConfig(**ENGINE_KW, spec_k=spec_k),
                 device="cpu", draft_params=port if spec_k else None)
    for p in _prompts(cfg):
        eng.submit(p)
    fin = eng.drain()
    assert [r.finish_reason for r in fin] == ["budget"] * 4
    want, proposed, accepted = _jax_engine(wide, spec_k)
    assert [r.out for r in fin] == want
    if spec_k:
        assert (eng.sched.spec_proposed, eng.sched.spec_accepted) == \
            (proposed, accepted)
        assert 0 < accepted < proposed


def test_static_kv_scales_and_recipe_match_jax(tmp_path, monkeypatch):
    """Static KV scales over the INT4 tree: ``collect_kv_stats`` within
    atol 1e-5 of JAX's (the port prefills in chunks), the engine with
    JAX's scales equal to JAX's chunked static engine; ``save_recipe``
    writes a tied tree's checkpoint and scales that ``load_recipe_params``
    restores with no k-means."""
    from repro.calib import collect_kv_stats as j_collect
    from repro.calib import kv_static_scales as j_kv_scales
    from repro_torch import calib
    cfg, tcfg, params, port = _fp32(False)
    jq, tq = _int4()
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, cfg.vocab, size=(2, 24)) for _ in range(2)]
    want = j_collect(cfg, jq, batches, qchunks=4)
    got = calib.collect_kv_stats(tcfg, tq, batches, qchunks=4, chunk=10)
    for k in ("k_min", "k_max", "v_min", "v_max"):
        assert got[k].shape == (cfg.n_layers, cfg.n_kv_heads, 4)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ATOL,
                                   rtol=0)
    scales = j_kv_scales(want)
    outs = []
    for eng in (JEngine(cfg, jq, JEngineConfig(**ENGINE_KW, flight=False,
                                               metrics=False),
                        kv_scales=scales),
                Engine(tcfg, tq, EngineConfig(**ENGINE_KW), device="cpu",
                       kv_scales=scales)):
        for p in _prompts(cfg):
            eng.submit(p)
        outs.append([r.out for r in eng.drain()])
    assert outs[1] == outs[0]
    rec = tserve.save_recipe(str(tmp_path), tcfg, port, arch=VLM, bits=4,
                             method="splitquant", reduced=True)
    assert rec.kv_scales is not None and "embed" not in rec.policies
    _no_kmeans(monkeypatch)
    served, _, kv = tserve.load_recipe_params(
        str(tmp_path), tt.init(tcfg, seed=1, device="cpu"), arch=VLM,
        reduced=True)
    assert "lm_head" not in served and isinstance(served["patch_proj"],
                                                  PackedWeight)
    for k in ("k_scale", "v_zero"):
        np.testing.assert_array_equal(np.asarray(kv[k]),
                                      np.asarray(rec.kv_scales[k]))


def test_wave_server_matches_jax(monkeypatch):
    """JAX's wave ``Server`` with its pad mask over the INT4 tree: two
    left-padded waves, budgets 0, 1 and mixed: identical tokens."""
    cfg, tcfg, _, _ = _fp32(False)
    jq, port = _int4()
    prompts = [p.astype(np.int32) for p in _prompts(cfg, 6, seed=3, hi=14)]
    budgets = [None, 0, 1, 4, None, 2]
    scfg = dict(max_batch=3, max_new_tokens=5, max_len=24)
    monkeypatch.setattr(jt, "prefill", jax.jit(
        jt.prefill, static_argnames=("cfg", "max_len"),
        compiler_options=FAST_COMPILE))
    outs = []
    for mod, c, p, kw in ((jsl, cfg, jq, {}), (tsl, tcfg, port,
                                               {"device": "cpu"})):
        reqs = [mod.Request(i, pr, b) for i, (pr, b) in
                enumerate(zip(prompts, budgets))]
        mod.Server(c, p, mod.ServeConfig(**scfg), **kw).serve(reqs)
        outs.append([r.out for r in reqs])
    assert outs[1] == outs[0]
    assert [len(o) for o in outs[1]] == [5, 0, 1, 4, 5, 2]


def test_f16_cache_engine_matches_jax():
    """A float16 fp cache (``kv_dtype="float16"``) at reduced stablelm,
    fp32 weights: the JAX engine's greedy tokens; the cache holds
    float16 rows."""
    cfg = get_arch("stablelm-1.6b").reduced()
    params = get_model(cfg).init(KEY, cfg)
    port = bridge.from_jax_tree(_to_numpy_tree(params), device="cpu")
    kw = dict(ENGINE_KW, kv_mode="fp", kv_dtype="float16")
    jeng = JEngine(cfg, params, JEngineConfig(**kw, flight=False,
                                              metrics=False))
    eng = Engine(t_arch("stablelm-1.6b").reduced(), port, EngineConfig(**kw),
                 device="cpu")
    assert eng.cache.k.dtype == torch.float16
    for e in (jeng, eng):
        for p in _prompts(cfg):
            e.submit(p)
    assert [r.out for r in eng.drain()] == [r.out for r in jeng.drain()]


# ------------------------------------------------------ cache kernels ---
def _static(x, rng):
    """Per-(head, chunk) static (S, Z) of x (..., Hkv, D) from its own
    range, S moved by U(0.5, 2) and Z by a fraction (codes inside the
    range: the rounding of S·x + Z is tested, not the clip)."""
    H = x.shape[-2]
    xc = x.reshape(-1, H, C, D // C)
    lo, hi = xc.min(axis=(0, 3)), xc.max(axis=(0, 3))
    s = (255.0 / (hi - lo) * rng.uniform(0.5, 2.0, (H, C))).astype(np.float32)
    z = (-0.5 - s * (hi + lo) / 2 + rng.uniform(-0.5, 0.5, (H, C))
         ).astype(np.float32)
    return s, z


def _cache(mode, k, v, rng):
    """(JAX cache k, v, JAX kwargs; port k, v, scales) of float K/V
    (..., Hkv, D) in ``mode``."""
    if mode == "dynamic":
        qk, ks, kz = j_quantize_kv(J(k), C)
        qv, vs, vz = j_quantize_kv(J(v), C)
        return (qk, qv, dict(mode="int8", k_scale=ks, k_zero=kz,
                             v_scale=vs, v_zero=vz),
                _t(qk), _t(qv), tuple(map(_t, (ks, kz, vs, vz))))
    if mode == "static":
        (ks, kz), (vs, vz) = _static(k, rng), _static(v, rng)
        qk, qv = j_quantize_kv_static(J(k), ks, kz), \
            j_quantize_kv_static(J(v), vs, vz)
        return (qk, qv, dict(mode="int8", k_scale=J(ks), k_zero=J(kz),
                             v_scale=J(vs), v_zero=J(vz)),
                _t(qk), _t(qv), tuple(map(_t, (ks, kz, vs, vz))))
    if mode in ("bf16", "f16"):
        jd, td = {"bf16": (jnp.bfloat16, torch.bfloat16),
                  "f16": (jnp.float16, torch.float16)}[mode]
        kb, vb = J(k).astype(jd), J(v).astype(jd)
        return (kb, vb, dict(mode="fp"),
                _t(kb.astype(jnp.float32)).to(td),
                _t(vb.astype(jnp.float32)).to(td), ())
    return J(k), J(v), dict(mode="fp"), _t(k), _t(v), ()


@pytest.mark.parametrize("mode", MODES)
def test_decode_at_head_dim_256_matches_jax(mode):
    """Decode attention's plain version at D = 256, MQA 8/1, chunks of
    64: ragged slots, an empty one, a stale row past q_pos."""
    rng = np.random.default_rng(10 + MODES.index(mode))
    N, T, Hq, Hkv = 4, 40, 8, 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(N, Hq, D), f(N, T, Hkv, D), f(N, T, Hkv, D)
    kv_pos = np.full((N, T), -1, np.int32)
    q_pos = np.zeros(N, np.int32)
    for n, depth in enumerate([33, 5, 0, 39]):
        kv_pos[n, :depth] = np.arange(depth)
        q_pos[n] = max(depth - 1, 0)
    kv_pos[1, 5] = 9
    jk, jv, kw, tk, tv, sc = _cache(mode, k, v, rng)
    if mode == "static":    # JAX's static decode takes (1, 1, Hkv, C)
        kw = {n: (a[None, None] if n != "mode" else a)
              for n, a in kw.items()}
        kw["per_entry_scales"] = False
    want = j_decode(J(q), jk, jv, J(kv_pos), J(q_pos), kv_chunk=8,
                    use_pallas=False, **kw)
    got = decode_attention_ref(_t(q), tk, tv, _t(kv_pos), _t(q_pos), *sc,
                               kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert np.all(got.numpy()[2] == 0.0)


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_at_head_dim_256_matches_jax(mode, verify):
    """Chunked prefill attention's plain version at D = 256, MQA 8/1, as
    a chunk and as a verify window (over a 16-bit cache the window
    through its type and back): the output, and the chunk's codes and
    scales bit-identical to JAX's epilogue."""
    rng = np.random.default_rng(20 + MODES.index(mode) + 7 * verify)
    Sq, T, Hq, Hkv, pos_start, length = 12, 40, 8, 1, 19, 10
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kn, vn = f(Sq, Hq, D), f(Sq, Hkv, D), f(Sq, Hkv, D)
    kv_pos = np.full(T, -1, np.int32)
    kv_pos[:pos_start + 1] = np.arange(pos_start + 1)
    kv_pos[30] = 3
    jk, jv, kw, tk, tv, sc = _cache(mode, f(T, Hkv, D), f(T, Hkv, D), rng)
    if mode == "static":
        kw["per_entry_scales"] = False
    want, jaux = j_prefill(J(q), J(kn), J(vn), jk, jv, J(kv_pos), pos_start,
                           length, kv_chunk=8, use_pallas=False,
                           verify=verify, **kw)
    args = (_t(q), _t(kn), _t(vn), tk, tv, _t(kv_pos), pos_start, length,
            *sc)
    got = prefill_attention_ref(*args, kv_chunk=8, verify=verify)
    _, taux = prefill_attention(*args, verify=verify)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert len(taux) == len(jaux)
    for a, b in zip(jaux, taux):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_kv_quantizers_and_write_at_head_dim_256(scale):
    """The K/V quantizers at D = 256, C = 4 bit-identical to JAX's (a
    degenerate chunk of zeros and one of one value), a chunk write and a
    decode write storing those codes and scales, and an fp write into
    float16 rows rounded as ``astype(float16)`` rounds (300 x N(0, 1)
    stays inside float16's range)."""
    rng = np.random.default_rng(int(scale * 10) + 1)
    x = (rng.standard_normal((6, 1, D)) * scale).astype(np.float32)
    x[0, 0, :64] = 0.0
    x[1, 0, 64:128] = -4.0
    for a, b in zip(j_quantize_kv(J(x), C), quantize_kv(_t(x), C)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    s, z = _static(x, rng)
    np.testing.assert_array_equal(
        np.asarray(j_quantize_kv_static(J(x), s, z)),
        quantize_kv_static(_t(x), _t(s), _t(z)).numpy())
    N, T = 3, 16
    dst = [torch.zeros((N, T, 1, D), dtype=torch.int8) for _ in range(2)]
    kv_pos = torch.full((N, T), -1, dtype=torch.int32)
    scales = [torch.zeros((N, T, 1, C)) for _ in range(4)]
    qk, ks, kz = j_quantize_kv(J(x), C)
    write_kv_rows(_t(x), _t(-x), *dst, kv_pos, *scales, slot=1, pos_start=4,
                  length=5)
    np.testing.assert_array_equal(dst[0][1, 4:10].numpy(), np.asarray(qk))
    np.testing.assert_array_equal(scales[1][1, 4:10].numpy(), np.asarray(kz))
    assert kv_pos[1, 4:10].tolist() == [4, 5, 6, 7, 8, -1]
    write_kv_rows(_t(x[:N]), _t(x[:N]), *dst, kv_pos, *scales,
                  positions=torch.tensor([9, 20, 0], dtype=torch.int32))
    np.testing.assert_array_equal(dst[0][0, 9].numpy(), np.asarray(qk)[0])
    f16 = [torch.zeros((N, T, 1, D), dtype=torch.float16) for _ in range(2)]
    write_kv_rows(_t(x[:N]), _t(-x[:N]), *f16, kv_pos,
                  positions=torch.tensor([3, 4, 5], dtype=torch.int32))
    want = np.asarray(J(x[:N]).astype(jnp.float16))
    np.testing.assert_array_equal(
        f16[0][torch.arange(N), torch.tensor([3, 4, 5])].numpy(), want)


# ------------------------------------------------ quantized table, I/O ---
def test_quantized_table_and_tied_head_match_jax():
    """``quantize_embeddings=True``: the embedding table is quantized
    (the min/max baseline: codes and scales bit-identical to JAX's),
    ``patch_proj`` too, and with the table quantized (JAX's codes through
    the bridge) the embedding and the tied head read it dequantized:
    logits as JAX's."""
    cfg, tcfg, params, port = _fp32(False)
    pol = dict(cfg=QuantConfig(bits=4), method="baseline",
               quantize_embeddings=True)
    jtree, _ = quantize_tree(KEY, {"embed": params["embed"]},
                             QuantPolicy(**pol))
    ttree, rep = tapply.quantize_tree(port, tapply.QuantPolicy(
        cfg=TQuantConfig(bits=4), method="baseline",
        quantize_embeddings=True))
    assert "embed" in rep["quantized"] and "patch_proj" in rep["quantized"]
    sq = ttree["embed"].unpack()
    for f in ("q", "cid", "scale", "zero"):
        np.testing.assert_array_equal(getattr(sq, f).numpy(),
                                      np.asarray(getattr(jtree["embed"], f)))
    _, plain = tapply.quantize_tree(port, tapply.QuantPolicy(
        cfg=TQuantConfig(bits=4), method="baseline"))
    assert "embed" in plain["skipped"] and "patch_proj" in plain["quantized"]
    jq = {**params, "embed": jtree["embed"]}
    tq = bridge.from_jax_tree(_to_numpy_tree(jq), device="cpu")
    assert isinstance(tq["embed"], PackedWeight)
    b = _batch(cfg, 5)
    want = jt.forward(jq, cfg, {k: J(v) for k, v in b.items()})[0]
    got = tt.forward(tq, tcfg, {k: _t(v) for k, v in b.items()})[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


def test_tied_tree_checkpoints_and_bridge_both_ways(tmp_path):
    """A tied VLM tree (``patch_proj``, no ``lm_head``): JAX's checkpoint
    of its INT4 tree restores in the port as the bridge gives it; the
    port's checkpoint has JAX's manifest and restores in JAX with the
    same leaves; the layer-by-layer build equals ``quantize_tree`` of the
    init."""
    cfg, tcfg, params, _ = _fp32(False)
    jq, port = _int4()
    assert "lm_head" not in port and isinstance(port["patch_proj"],
                                                PackedWeight)
    jck.save(str(tmp_path / "j"), 2, jq)
    got, step = ckpt.restore(str(tmp_path / "j"),
                             tt.init(tcfg, seed=3, device="cpu"))
    assert step == 2
    _assert_trees_equal(got, port)
    ckpt.save(str(tmp_path / "t"), 2, port)
    assert _manifest(tmp_path / "t", 2) == _manifest(tmp_path / "j", 2)
    back, _ = jck.restore(str(tmp_path / "t"), params)
    jflat = jax.tree_util.tree_leaves_with_path(jq)
    rflat = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in jflat] == [p for p, _ in rflat]
    for (_, a), (_, b) in zip(jflat, rflat):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    built, rep = tserve.build_params(tcfg, bits=4, method="splitquant",
                                     seed=0, device="cpu")
    want, wrep = tapply.quantize_tree(tt.init(tcfg, seed=0, device="cpu"),
                                      tapply.QuantPolicy(
                                          cfg=TQuantConfig(bits=4)), seed=0)
    assert rep == wrep and "lm_head" not in built
    _assert_trees_equal(built, want)


def test_vlm_workloads():
    """``vlm_smoke_workload`` is paligemma-3b uncut with the smoke
    workload's engine settings and request shapes; ``f16_cache_workload``
    the smoke workload over a float16 fp cache."""
    cfg, ecfg, quant, warm, prompts = tserve.vlm_smoke_workload()
    _, secfg, squant, _, sprompts = tserve.smoke_workload()
    assert (cfg.name, cfg.n_layers, cfg.head_dim) == (VLM, 18, 256)
    assert ecfg == secfg and quant == squant and len(warm) == 100
    assert [len(p) for p in prompts] == [len(p) for p in sprompts]
    _, fcfg, _, _, _ = tserve.f16_cache_workload()
    assert (fcfg.kv_mode, fcfg.kv_dtype) == ("fp", "float16")
