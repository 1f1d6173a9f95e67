"""Port parity, the engine's remaining options against the JAX package:
the fp slot cache in bf16, one-shot prefill (``prefill_chunk=0``) in the
int8 dynamic, int8 static and fp modes, speculation over one-shot
admissions, the materialize read path (``fused_attn=False``), the plain
versions of the three cache kernels over a bf16 cache, and temperature
sampling in the engine and the wave ``Server``.

Weights: stablelm-1.6b ``.reduced()`` (MHA) with the JAX package's
SplitQuant INT4 k=3 weights (one jitted ``quantize_tree``) and
chatglm3-6b ``.reduced()`` (GQA) with its fp32 ``init`` weights, both
from JAX's seeded ``init``, carried over by the bridge. Every JAX engine
runs once a module (``functools.cache``).

Tolerances: greedy tokens and every kv_pos entry identical. The rows an
engine writes where kv_pos >= 0 come from K/V that the two frameworks
compute with the projections summed in different orders, so: int8 codes
within 1 and all but 0.1% identical, dynamic scales rtol 1e-5 and zeros
within 1; fp32 rows atol 1e-4 relative; bf16 rows within 2^-7 relative
or that atol (one bf16 ulp: the rounding of such a difference). The
write functions given the same K/V: bit for bit; attention outputs atol 1e-5 (fp32, summation
order). Sampling: torch cannot reproduce ``jax.random.categorical``, so
the draws are held to softmax(logits / T) and to JAX's own draws by
chi-square bounds at the 1 - 1e-6 quantile (stated below).
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.core import QuantConfig, QuantPolicy, quantize_tree
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import kvcache as jkv
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.prefill_attention import prefill_attention as j_prefill
from repro.models import attention as jatt
from repro.models import get_model as j_model

from repro_torch import bridge
from repro_torch.engine import Engine, EngineConfig
from repro_torch.engine import kvcache as tkv
from repro_torch.kernels import prefill_attention as pa
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import attention as tatt
from repro_torch.runtime import serve_loop as tsl

from test_torch_quant import _to_numpy_tree
from test_torch_static_kv import static_scales

teng = importlib.import_module("repro_torch.engine.engine")
jeng = importlib.import_module("repro.engine.engine")

FAST_COMPILE = {"xla_backend_optimization_level": 0}
N_SLOTS, MAX_LEN, NEW = 3, 40, 5
#: the 1 - 1e-6 quantile of chi-square with 64 degrees of freedom (65
#: bins: 64 tokens and the rest)
CHI2_64 = 132.79


@functools.cache
def _arch(name):
    """(cfg, JAX params, port params, prompts): stablelm-1.6b INT4,
    chatglm3-6b fp32."""
    cfg = j_arch(name).reduced()
    params = j_model(cfg).init(jax.random.PRNGKey(0), cfg)
    if name == "stablelm-1.6b":
        params = jax.jit(lambda k, p: quantize_tree(
            k, p, QuantPolicy(cfg=QuantConfig(bits=4)))[0],
            compiler_options=FAST_COMPILE)(jax.random.PRNGKey(1), params)
    port = bridge.from_jax_tree(_to_numpy_tree(params), dtype=torch.float32,
                                device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(3, 15)))
               for _ in range(5)]
    return cfg, params, port, prompts


def _kv_scales(cfg):
    return static_scales(np.random.default_rng(4), cfg.n_layers,
                         cfg.n_kv_heads, 4)


@functools.cache
def _jax_run(name, items):
    """JAX engine over the arch's prompts: the cache after its first step
    (numpy) and every request's tokens, once per (arch, config)."""
    kw = dict(items)
    cfg, jparams, _, prompts = _arch(name)
    scales = _kv_scales(cfg) if kw.pop("static", False) else None
    eng = JEngine(cfg, jparams, JEngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, max_new_tokens=NEW, flight=False,
        metrics=False, **kw), kv_scales=scales)
    for p in prompts:
        eng.submit(p)
    n0 = jeng.FP_PREFILL_MATERIALIZATIONS
    eng.step()
    cache = {f: np.asarray(getattr(eng.cache, f).astype(jnp.float32)
                           if f in ("k", "v") else getattr(eng.cache, f))
             for f in ("k", "v", "kv_pos", "k_scale", "k_zero", "v_scale",
                       "v_zero")}
    fin = eng.drain()
    return dict(cache=cache, out=[r.out for r in fin],
                n_prefills=eng.n_prefills,
                materializations=jeng.FP_PREFILL_MATERIALIZATIONS - n0,
                proposed=eng.sched.spec_proposed,
                accepted=eng.sched.spec_accepted)


def _port_run(name, **kw):
    cfg, _, tparams, prompts = _arch(name)
    scales = _kv_scales(cfg) if kw.pop("static", False) else None
    eng = Engine(cfg, tparams, EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, max_new_tokens=NEW, **kw),
        device="cpu", kv_scales=scales)
    for p in prompts:
        eng.submit(p)
    n0 = teng.FP_PREFILL_MATERIALIZATIONS
    eng.step()
    c = eng.cache
    cache = {f: getattr(c, f).float().clone().numpy() for f in
             ("k", "v", "k_scale", "k_zero", "v_scale", "v_zero")}
    cache["kv_pos"] = c.kv_pos.clone().numpy()
    fin = eng.drain()
    return eng, dict(cache=cache, out=[r.out for r in fin],
                     n_prefills=eng.n_prefills,
                     materializations=teng.FP_PREFILL_MATERIALIZATIONS - n0,
                     proposed=eng.sched.spec_proposed,
                     accepted=eng.sched.spec_accepted)


def _compare(name, **kw):
    """Port vs JAX on one engine configuration: tokens, every kv_pos
    entry, and the rows where kv_pos >= 0 (codes and scales exactly,
    float rows within the stated tolerance). Returns both runs."""
    want = _jax_run(name, tuple(sorted(kw.items())))
    eng, got = _port_run(name, **kw)
    assert got["out"] == want["out"]
    gc, wc = got["cache"], want["cache"]
    np.testing.assert_array_equal(gc["kv_pos"], wc["kv_pos"])
    live = wc["kv_pos"] >= 0
    assert live.any()
    if kw.get("kv_mode") == "int8":
        for f in ("k", "v"):
            d = np.abs(gc[f][live] - wc[f][live])
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        if not kw.get("static"):
            for f in ("k_scale", "v_scale"):
                np.testing.assert_allclose(gc[f][live], wc[f][live],
                                           rtol=1e-5)
            for f in ("k_zero", "v_zero"):
                assert np.abs(gc[f][live] - wc[f][live]).max() <= 1
    else:
        bf16 = kw.get("kv_dtype") == "bfloat16"
        for f in ("k", "v"):
            a, b = gc[f][live], wc[f][live]
            tol = 1e-4 * max(1.0, float(np.abs(b).max()))
            if bf16:
                tol = np.maximum(tol, 2.0 ** -7 *
                                 np.maximum(np.abs(a), np.abs(b)))
            assert np.all(np.abs(a - b) <= tol)
    return eng, got, want


# ------------------------------------------------------ the bf16 cache ---
@pytest.mark.parametrize("name", ["stablelm-1.6b", "chatglm3-6b"])
def test_engine_over_bf16_fp_cache_matches_jax(name):
    eng, got, _ = _compare(name, kv_mode="fp", kv_dtype="bfloat16",
                           prefill_chunk=8)
    assert eng.cache.k.dtype == torch.bfloat16
    assert got["n_prefills"] == 0 and got["materializations"] == 0


# ------------------------------------------------------- one-shot prefill ---
@pytest.mark.parametrize("name,kw", [
    ("stablelm-1.6b", dict(kv_mode="int8")),
    ("stablelm-1.6b", dict(kv_mode="int8", static=True)),
    ("chatglm3-6b", dict(kv_mode="fp")),
], ids=["int8-dynamic", "int8-static", "fp32"])
def test_oneshot_prefill_matches_jax(name, kw):
    """Tokens of the JAX one-shot engine (the static one too: its
    chunked engine differs), the cache per the write_prefill rule after
    the admissions, and one prefill and one materialization a request."""
    eng, got, want = _compare(name, prefill_chunk=0, **kw)
    n = len(_arch(name)[3])
    assert got["n_prefills"] == want["n_prefills"] == n
    assert got["materializations"] == want["materializations"] == n
    assert eng.n_prefill_chunks == 0 and len(eng.prefill_s) == n


def test_spec_with_oneshot_prefill_matches_jax():
    _, got, want = _compare("stablelm-1.6b", kv_mode="int8", prefill_chunk=0,
                            spec_k=2)
    assert (got["proposed"], got["accepted"]) == \
        (want["proposed"], want["accepted"]) and got["proposed"] > 0
    # the target's and the draft's materialization per admission
    n = len(_arch("stablelm-1.6b")[3])
    assert got["materializations"] == want["materializations"] == 2 * n


def test_materialize_read_path_matches_jax():
    _compare("stablelm-1.6b", kv_mode="int8", prefill_chunk=8,
             fused_attn=False)


def test_chunked_path_never_materializes():
    _, got = _port_run("stablelm-1.6b", kv_mode="int8", prefill_chunk=8)
    assert got["materializations"] == 0 and got["n_prefills"] == 0


def test_write_prefill_rewrites_the_whole_row():
    """A slot that held a longer request: after write_prefill only
    [0, length) is visible in every layer, the bucket's padding and the
    old occupant's rows read -1, and other slots are untouched."""
    cfg = _arch("chatglm3-6b")[0]
    rng = np.random.default_rng(8)
    for mode, dtype in (("int8", torch.float32), ("fp", torch.bfloat16)):
        cache = tkv.init_slot_cache(cfg, 2, 24, mode=mode, dtype=dtype,
                                    device="cpu")
        cache.kv_pos[:] = torch.arange(24, dtype=torch.int32)
        L, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        k = torch.from_numpy(rng.standard_normal((L, 1, 16, H, D))
                             .astype(np.float32))
        tkv.write_prefill(cache, 1, tatt.KVCache(k, -k, None), 11)
        row = np.where(np.arange(24) < 11, np.arange(24), -1)
        assert (cache.kv_pos[:, 1].numpy() == row).all()
        assert (cache.kv_pos[:, 0].numpy() == np.arange(24)).all()


# ---------------------------------- the three kernels over a bf16 cache ---
def _bf16_cache(rng, N, T, H, D):
    return [jnp.asarray(rng.standard_normal((N, T, H, D)), jnp.bfloat16)
            for _ in range(2)]


def _t(a):
    return torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32)))


@pytest.mark.parametrize("Hq,Hkv,D", [(8, 8, 32), (8, 2, 64)])
def test_decode_plain_over_bf16_cache_matches_jax(Hq, Hkv, D):
    rng = np.random.default_rng(Hq + D)
    N, T = 3, 40
    k, v = _bf16_cache(rng, N, T, Hkv, D)
    q = rng.standard_normal((N, Hq, D)).astype(np.float32)
    kv_pos = np.full((N, T), -1, np.int32)
    for n, d in enumerate((40, 7, 0)):
        kv_pos[n, :d] = np.arange(d)
    q_pos = np.array([39, 6, 0], np.int32)
    want = j_decode(jnp.asarray(q), k, v, jnp.asarray(kv_pos),
                    jnp.asarray(q_pos), mode="fp", use_pallas=False)
    got = decode_attention(torch.from_numpy(q), _t(k).bfloat16(),
                           _t(v).bfloat16(), torch.from_numpy(kv_pos),
                           torch.from_numpy(q_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("Hq,Hkv,D", [(8, 8, 32), (8, 2, 64)])
def test_prefill_plain_over_bf16_cache_matches_jax(Hq, Hkv, D, verify):
    """fp32 queries and window over a bf16 cache; in verify mode the
    window attends itself through the bf16 round trip (JAX's
    kn.astype(ck.dtype)), which rounds the fp32 K/V."""
    rng = np.random.default_rng(Hq + D + verify)
    T, Sq, pos_start, length = 48, 8, 20, 6
    ck, cv = (c[0] for c in _bf16_cache(rng, 1, T, Hkv, D))
    q, kn, vn = (rng.standard_normal((Sq, h, D)).astype(np.float32)
                 for h in (Hq, Hkv, Hkv))
    kv_pos = np.where(np.arange(T) <= pos_start, np.arange(T), -1) \
        .astype(np.int32)
    want, _ = j_prefill(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                        ck, cv, jnp.asarray(kv_pos), pos_start, length,
                        mode="fp", use_pallas=False, verify=verify)
    got, aux = pa.prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        _t(ck).bfloat16(), _t(cv).bfloat16(), torch.from_numpy(kv_pos),
        pos_start, length, verify=verify)
    assert aux == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    if verify:      # the round trip is what moves the output
        plain, _ = pa.prefill_attention(
            torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
            _t(ck).bfloat16(), _t(cv).bfloat16(), torch.from_numpy(kv_pos),
            pos_start, length)
        assert not torch.equal(plain, got)


def test_bf16_cache_writes_match_jax_bit_for_bit():
    """The decode write, the chunk write and write_prefill into a bf16
    cache from the same fp32 K/V: every row and kv_pos as JAX's."""
    rng = np.random.default_rng(12)
    cfg = j_arch("chatglm3-6b").reduced()
    N, T, H, D, L = 3, 16, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    jc = jkv.init_slot_cache(cfg, N, T, mode="fp", dtype=jnp.bfloat16)
    tc = tkv.init_slot_cache(cfg, N, T, mode="fp", dtype=torch.bfloat16,
                             device="cpu")
    # write_prefill of slot 1 (length 5 of 8), then a decode write of
    # layer 0 and a chunk of slot 2 into layer 1
    pk, pv = f(L, 1, 8, H, D), f(L, 1, 8, H, D)
    jc = jkv.write_prefill(jc, 1, jatt.KVCache(jnp.asarray(pk),
                                               jnp.asarray(pv), None), 5)
    tkv.write_prefill(tc, 1, tatt.KVCache(torch.from_numpy(pk),
                                          torch.from_numpy(pv), None), 5)
    dk, dv = f(N, 1, H, D), f(N, 1, H, D)
    pos = np.array([[3], [5], [0]], np.int32)
    take = lambda c, l: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a[l], c)
    jl = jkv.slot_layer_write(take(jc, 0), jnp.asarray(dk), jnp.asarray(dv),
                              jnp.asarray(pos))
    tkv.slot_layer_write(tc, 0, torch.from_numpy(dk), torch.from_numpy(dv),
                         torch.from_numpy(pos))
    for fld in ("k", "v", "kv_pos"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jl, fld)).astype(np.float32),
            getattr(tc, fld)[0].float().numpy())
    for fld in ("k", "v", "kv_pos"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jc, fld)[1]).astype(np.float32),
            getattr(tc, fld)[1].float().numpy())
    ck, cv = f(4, H, D), f(4, H, D)
    kw = dict(slot=2, pos_start=14, length=3)
    rows = np.arange(14, 18)
    want_k = np.asarray(jc.k[1]).astype(np.float32)
    want_k[2, rows[:2]] = np.asarray(jnp.asarray(ck[:2], jnp.bfloat16)
                                     .astype(jnp.float32))
    pa.write_kv_rows(torch.from_numpy(ck), torch.from_numpy(cv), tc.k[1],
                     tc.v[1], tc.kv_pos[1], **kw)
    np.testing.assert_array_equal(tc.k[1].float().numpy(), want_k)
    assert tc.kv_pos[1, 2, 14:].tolist() == [14, 15]


def test_materialize_layer_matches_jax():
    rng = np.random.default_rng(13)
    cfg = _arch("chatglm3-6b")[0]
    L, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    x = rng.standard_normal((L, 2, 8, H, D)).astype(np.float32)
    jc = jkv.init_slot_cache(cfg, 2, 8, mode="int8")
    tc = tkv.init_slot_cache(cfg, 2, 8, mode="int8", device="cpu")
    qk, ks, kz = jkv.quantize_kv(jnp.asarray(x), 4)
    jc = dataclasses.replace(jc, k=qk, v=qk, k_scale=ks, k_zero=kz,
                             v_scale=ks, v_zero=kz)
    for fld in ("k", "v", "k_scale", "k_zero", "v_scale", "v_zero"):
        getattr(tc, fld).copy_(torch.from_numpy(np.asarray(getattr(jc, fld))))
    for layer in range(L):
        want = jkv.materialize_layer(jax.tree_util.tree_map(
            lambda a: a[layer], jc))
        got = tkv.materialize_layer(tc, layer)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -------------------------------------------------------------- sampling ---
def _sampling_row(V=512, seed=0):
    """A seeded logits row, N(0, 1) but for 64 hot tokens at 4 + U(0,
    1.5), which hold most of the mass at T = 0.7 (98%), each of the 65
    bins expecting well over 5 of 2e4 draws."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(V).astype(np.float32)
    hot = rng.choice(V, 64, replace=False)
    logits[hot] = 4.0 + rng.uniform(0, 1.5, 64).astype(np.float32)
    return logits, np.sort(hot)


def _bins(toks, hot, V):
    counts = np.bincount(np.asarray(toks).reshape(-1), minlength=V)
    return np.append(counts[hot], counts.sum() - counts[hot].sum())


def test_sampler_distribution_matches_softmax_and_jax():
    T, n = 0.7, 20_000
    logits, hot = _sampling_row()
    V = logits.size
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits) / T), np.float64)
    expect = n * np.append(p[hot], 1 - p[hot].sum())
    assert expect.min() >= 5
    gen = torch.Generator().manual_seed(0)
    got = teng.sample_tokens(torch.from_numpy(logits).expand(n, V), T, gen)
    assert got.shape == (n,) and got.dtype == torch.int64
    o = _bins(got.numpy(), hot, V)
    assert ((o - expect) ** 2 / expect).sum() < CHI2_64
    # against JAX's own draws: a two-sample (homogeneity) chi-square
    j = jax.random.categorical(jax.random.PRNGKey(0),
                               jnp.asarray(logits) / T, shape=(n,))
    oj = _bins(np.asarray(j), hot, V)
    e = (o + oj) / 2
    assert ((o - e) ** 2 / e + (oj - e) ** 2 / e).sum() < CHI2_64


def _first_new(out):
    """The first token of ``out`` not seen before it (after its first),
    and its index: an eos there retires the request after that many
    tokens."""
    j = next(j for j in range(1, len(out)) if out[j] not in out[:j])
    return out[j], j


def _temp_engine(seed, **kw):
    cfg, _, tparams, prompts = _arch("stablelm-1.6b")
    eng = Engine(cfg, tparams, EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, max_new_tokens=NEW, kv_mode="int8",
        **kw), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    for p in prompts:
        eng.submit(p)
    return eng.drain()


def test_engine_sampling_repeats_with_its_seed_and_honours_eos():
    a = [r.out for r in _temp_engine(5, temperature=0.7)]
    b = [r.out for r in _temp_engine(5, temperature=0.7)]
    c = [r.out for r in _temp_engine(6, temperature=0.7)]
    assert a == b and a != c
    assert all(len(o) == NEW for o in a)
    # a near-zero temperature draws the greedy tokens: an eos taken from
    # them retires the request there, and eos is never emitted
    greedy = [r.out for r in _temp_engine(0, prefill_chunk=0)]
    eos, j = _first_new(greedy[0])
    fin = _temp_engine(0, temperature=1e-3, eos_id=eos, prefill_chunk=0)
    assert fin[0].out == greedy[0][:j] and fin[0].finish_reason == "eos"
    for r in fin:
        assert eos not in r.out
        assert len(r.out) == NEW or r.finish_reason == "eos"


def test_server_sampling_serves_every_budget_and_honours_eos():
    cfg, _, tparams, prompts = _arch("chatglm3-6b")
    reqs = lambda: [tsl.Request(i, p) for i, p in enumerate(prompts)]  # noqa
    scfg = tsl.ServeConfig(max_batch=3, max_new_tokens=NEW, max_len=32)
    srv = lambda s, **kw: tsl.Server(  # noqa: E731
        cfg, tparams, dataclasses.replace(scfg, **kw), device="cpu",
        generator=torch.Generator().manual_seed(s))
    a = [r.out for r in srv(1, temperature=0.7).serve(reqs())]
    assert a == [r.out for r in srv(1, temperature=0.7).serve(reqs())]
    assert all(len(o) == NEW for o in a)
    greedy = [r.out for r in srv(0).serve(reqs())]
    eos, j = _first_new(greedy[1])
    got = srv(0, temperature=1e-3, eos_id=eos).serve(reqs())
    assert got[1].out == greedy[1][:j]
    assert all(eos not in r.out for r in got)
