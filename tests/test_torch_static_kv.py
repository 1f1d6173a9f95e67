"""Port parity, static per-layer KV scales: the port's static quantizer,
scale derivation and calibration, the static and verify modes of the two
attention kernels' plain versions, the cache's hot-swap and rollback, and
the static-scale engine, against the JAX package on seeded numpy inputs
(the CPU path runs the plain versions).

Tolerances: codes, scales and kv_pos bit-identical (``quantize_kv_static``
against JAX's evaluated op by op; against the jitted JAX version, where
XLA contracts S·x + Z into one FMA, the codes that differ are counted,
must all be FMA ties and must be fewer than the ties in the input);
attention outputs atol 1e-5 in fp32 (summation order);
``collect_kv_stats`` atol 1e-5 (the port prefills in chunks, JAX in one
shot); engine greedy tokens identical to the JAX *chunked* engine with
the same static scales.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calib import collect_kv_stats as j_collect
from repro.calib import kv_static_scales as j_kv_scales
from repro.calib.stats import static_qparams as j_static_qparams
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import kvcache as jkv
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.prefill_attention import prefill_attention as j_prefill

from repro_torch import calib
from repro_torch.engine import Engine, EngineConfig
from repro_torch.engine import kvcache as tkv
from repro_torch.kernels import prefill_attention as pa
from repro_torch.kernels.decode_attention import decode_attention

from test_torch_cuda import fma_tie_inputs
from test_torch_models import quantized_pair

ATOL = 1e-5


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def static_scales(rng, L, H, C):
    """Static (S, Z) from seeded per-(L, H, C) ranges around N(0, 1) data,
    as ``kv_static_scales`` derives them: most codes fall inside the
    range."""
    lo = -rng.uniform(1.5, 3.5, (L, H, C)).astype(np.float32)
    hi = rng.uniform(1.5, 3.5, (L, H, C)).astype(np.float32)
    return j_kv_scales({"k_min": lo, "k_max": hi, "v_min": lo * 0.8,
                        "v_max": hi * 1.1})


# ------------------------------------------------------- the quantizer ---
def _static_inputs():
    """x (R, H, D) from N(0, 2) with the FMA-tie values of one (S, Z)
    appended, and (H, C) constants that are (S, Z) on every chunk."""
    rng = np.random.default_rng(5)
    H, D, C = 2, 32, 4
    xs, S, Z = fma_tie_inputs()
    ties = np.resize(xs, -(-xs.size // (H * D)) * H * D)   # repeated
    x = np.concatenate([(rng.standard_normal(64 * H * D) * 2)
                        .astype(np.float32), ties]).reshape(-1, H, D)
    scale = np.full((H, C), S, np.float32)
    zero = np.full((H, C), Z, np.float32)
    return x, scale, zero, ties.size


def test_quantize_kv_static_bit_identical_op_by_op():
    x, scale, zero, n_ties = _static_inputs()
    assert n_ties > 0
    with jax.disable_jit():
        want = _np(jkv.quantize_kv_static(jnp.asarray(x), jnp.asarray(scale),
                                          jnp.asarray(zero)))
    for got in (pa.quantize_kv_static_ref(_t(x), _t(scale), _t(zero)),
                tkv.quantize_kv_static(_t(x), _t(scale), _t(zero))):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    inside = ((want > -128) & (want < 127)).mean()
    assert inside > 0.5, inside


def test_quantize_kv_static_against_jitted_jax_counts_fma_ties():
    """XLA on the CPU may contract the jitted S·x + Z into one FMA; a code
    that differs must be off by one at an FMA tie, and there are fewer
    such codes than ties in the input (bound: n_ties)."""
    x, scale, zero, n_ties = _static_inputs()
    jitted = _np(jax.jit(jkv.quantize_kv_static)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(zero)))
    got = pa.quantize_kv_static_ref(_t(x), _t(scale), _t(zero)).numpy()
    S, Z = np.float64(scale[0, 0]), np.float64(zero[0, 0])
    fused = np.clip(np.rint((S * x.astype(np.float64) + Z)
                            .astype(np.float32)), -128, 127)
    separate = np.clip(np.rint(scale[0, 0] * x + zero[0, 0]), -128, 127)
    tie = fused != separate
    differ = got != jitted
    assert int(differ.sum()) <= n_ties
    assert not (differ & ~tie).any()
    assert (np.abs(got.astype(np.int32) - jitted.astype(np.int32))
            [differ] == 1).all()


# ------------------------------------------------ scales and calibration ---
def test_check_static_scales_matches_jax():
    rng = np.random.default_rng(0)
    L, H, C = 3, 2, 4
    sc = static_scales(rng, L, H, C)
    got = tkv.check_static_scales(sc, L, H, C)
    want = jkv.check_static_scales(sc, L, H, C)
    for k in tkv.SCALE_KEYS:
        assert tuple(got[k].shape) == (L, 1, 1, H, C)
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]))
    bad = dict(sc, v_zero=sc["v_zero"][:, :, :2])
    with pytest.raises(ValueError) as je:
        jkv.check_static_scales(bad, L, H, C)
    with pytest.raises(ValueError) as te:
        tkv.check_static_scales(bad, L, H, C)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("margin", [1.0, 1.25])
def test_static_qparams_and_kv_scales_equal_jax(margin):
    rng = np.random.default_rng(1)
    lo = rng.normal(size=(4, 2, 4)).astype(np.float32) - 1
    hi = lo + rng.uniform(0, 3, lo.shape).astype(np.float32)
    hi[0, 0, 0] = lo[0, 0, 0]                  # constant chunk
    lo[1, 0, 0] = hi[1, 0, 0] = 0.0            # all-zero chunk
    for got, want in zip(calib.static_qparams(lo, hi),
                         j_static_qparams(lo, hi)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    stats = {"k_min": lo, "k_max": hi, "v_min": lo * 2, "v_max": hi * 2}
    got = calib.kv_static_scales(stats, margin=margin)
    want = j_kv_scales(stats, margin=margin)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_collect_kv_stats_matches_jax():
    from repro.configs import get_arch
    from repro.models import get_model
    from repro_torch import bridge
    from test_torch_quant import _to_numpy_tree
    cfg = get_arch("chatglm3-6b").reduced()
    params = get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    tparams = bridge.from_jax_tree(_to_numpy_tree(params), device="cpu")
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, cfg.vocab, size=(2, 24)) for _ in range(2)]
    want = j_collect(cfg, params, batches, qchunks=4)
    got = calib.collect_kv_stats(cfg, tparams, batches, qchunks=4, chunk=10)
    for k in ("k_min", "k_max", "v_min", "v_max"):
        assert got[k].shape == (cfg.n_layers, cfg.n_kv_heads, 4)
        np.testing.assert_allclose(got[k], _np(want[k]), atol=ATOL, rtol=0)


# ------------------------------------------- attention, static / verify ---
def _decode_inputs(seed, N=3, T=40, Hq=4, Hkv=2, D=32, C=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((N, Hq, D)).astype(np.float32)
    k = rng.integers(-128, 128, (N, T, Hkv, D)).astype(np.int8)
    v = rng.integers(-128, 128, (N, T, Hkv, D)).astype(np.int8)
    depths = [T - 3, 11, 0][:N]
    kv_pos = np.full((N, T), -1, np.int32)
    for n, d in enumerate(depths):
        kv_pos[n, :d] = np.arange(d)
    q_pos = np.array([max(d - 1, 0) for d in depths], np.int32)
    sc = static_scales(rng, 1, Hkv, C)
    scales = [sc[f][0] for f in ("k_scale", "k_zero", "v_scale", "v_zero")]
    return q, k, v, kv_pos, q_pos, scales


@pytest.mark.parametrize("use_pallas", [False, True])
def test_static_decode_matches_jax(use_pallas):
    q, k, v, kv_pos, q_pos, scales = _decode_inputs(3)
    want = _np(j_decode(
        *map(jnp.asarray, (q, k, v, kv_pos, q_pos)),
        **{f: jnp.asarray(s)[None, None] for f, s in zip(
            ("k_scale", "k_zero", "v_scale", "v_zero"), scales)},
        mode="int8", per_entry_scales=False, use_pallas=use_pallas,
        interpret=use_pallas, kv_chunk=8))
    for layout in (lambda s: _t(s), lambda s: _t(s)[None, None]):
        got = decode_attention(*map(_t, (q, k, v, kv_pos, q_pos)),
                               *map(layout, scales))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert (got[2] == 0).all()                     # empty slot


def _prefill_inputs(seed, mode, Sq=6, T=32, Hq=4, Hkv=2, D=32, C=4,
                    pos_start=13):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kn, vn = f(Sq, Hq, D), f(Sq, Hkv, D), f(Sq, Hkv, D)
    kv_pos = np.full((T,), -1, np.int32)
    kv_pos[:pos_start + 1] = np.arange(pos_start + 1)   # + a parked row
    if mode == "fp":
        return q, kn, vn, f(T, Hkv, D), f(T, Hkv, D), kv_pos, None
    ck = rng.integers(-128, 128, (T, Hkv, D)).astype(np.int8)
    cv = rng.integers(-128, 128, (T, Hkv, D)).astype(np.int8)
    if mode == "static":
        sc = static_scales(rng, 1, Hkv, C)
        scales = [sc[k][0] for k in ("k_scale", "k_zero", "v_scale",
                                     "v_zero")]
    else:
        scales = [rng.uniform(5, 60, (T, Hkv, C)).astype(np.float32),
                  rng.uniform(-20, 20, (T, Hkv, C)).astype(np.float32)] * 2
    return q, kn, vn, ck, cv, kv_pos, scales


@pytest.mark.parametrize("mode,verify,use_pallas", [
    ("static", False, False), ("static", False, True),
    ("fp", True, False), ("dynamic", True, False), ("static", True, False),
    ("static", True, True)])
def test_prefill_static_and_verify_match_jax(mode, verify, use_pallas):
    q, kn, vn, ck, cv, kv_pos, scales = _prefill_inputs(4, mode)
    pos_start, length = 13, 5
    kw = {}
    if scales is not None:
        kw = {f: jnp.asarray(s) for f, s in zip(
            ("k_scale", "k_zero", "v_scale", "v_zero"), scales)}
    jo, jaux = j_prefill(*map(jnp.asarray, (q, kn, vn, ck, cv, kv_pos)),
                         pos_start, length,
                         mode="fp" if mode == "fp" else "int8",
                         per_entry_scales=mode != "static", kv_chunk=8,
                         use_pallas=use_pallas, interpret=use_pallas,
                         verify=verify, **kw)
    o, aux = pa.prefill_attention(
        *map(_t, (q, kn, vn, ck, cv, kv_pos)), pos_start, length,
        *([] if scales is None else map(_t, scales)), verify=verify)
    np.testing.assert_allclose(o.numpy(), _np(jo), atol=ATOL, rtol=0)
    assert len(aux) == len(jaux)
    for a, b in zip(aux, jaux):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    # verify changes what the window attends, in int8 modes only
    o_plain, _ = pa.prefill_attention(
        *map(_t, (q, kn, vn, ck, cv, kv_pos)), pos_start, length,
        *([] if scales is None else map(_t, scales)))
    assert torch.equal(o, o_plain) == (not verify or mode == "fp")


def test_prefill_modes_are_named():
    cache8 = torch.zeros((4, 2, 8), dtype=torch.int8)
    assert pa.prefill_mode(cache8, torch.ones(4, 2, 2), False) == "dynamic"
    assert pa.prefill_mode(cache8, torch.ones(2, 2), True) == "verify_static"
    assert pa.prefill_mode(cache8.float(), None, True) == "verify_fp"


# ------------------------------------------------- the cache's lifecycle ---
def _written_caches(cfg, seed, static=None, n_slots=2, T=16):
    """A JAX and a port int8 cache with the same rows written (one decode
    write per position, seeded K/V), dynamic or static."""
    jc = jkv.init_slot_cache(cfg, n_slots, T, mode="int8", kv_scales=static)
    tc = tkv.init_slot_cache(cfg, n_slots, T, mode="int8", kv_scales=static,
                             device="cpu")
    rng = np.random.default_rng(seed)
    L, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    for t in range(11):
        kv = rng.standard_normal((2, L, n_slots, 1, H, D)).astype(np.float32)
        pos = np.full((n_slots, 1), t, np.int32)
        for layer in range(L):
            jl = jax.tree_util.tree_map(lambda a: a[layer], jc)
            jl = jkv.slot_layer_write(jl, jnp.asarray(kv[0, layer]),
                                      jnp.asarray(kv[1, layer]),
                                      jnp.asarray(pos))
            jc = jax.tree_util.tree_map(
                lambda full, part: full.at[layer].set(part), jc, jl)
            tkv.slot_layer_write(tc, layer, _t(kv[0, layer]),
                                 _t(kv[1, layer]), _t(pos))
    return jc, tc


@pytest.fixture(scope="module")
def small_cfg():
    from repro.configs import get_arch
    return get_arch("chatglm3-6b").reduced()


@pytest.mark.parametrize("static", [False, True])
def test_cache_writes_match_jax(small_cfg, static):
    sc = static_scales(np.random.default_rng(6), small_cfg.n_layers,
                       small_cfg.n_kv_heads, 4) if static else None
    jc, tc = _written_caches(small_cfg, 7, sc)
    assert tc.static == static
    for f in ("k", "v", "kv_pos") + tkv.SCALE_KEYS:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      _np(getattr(jc, f)))


def test_hotswap_static_scales_matches_jax(small_cfg):
    cfg = small_cfg
    jc, tc = _written_caches(cfg, 8)
    sc = static_scales(np.random.default_rng(9), cfg.n_layers,
                       cfg.n_kv_heads, 4)
    want = jkv.hotswap_static_scales(jc, sc)       # op by op, not jitted
    got = tkv.hotswap_static_scales(tc, sc)
    assert got.static and want.static
    for f in ("k", "v", "kv_pos") + tkv.SCALE_KEYS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(want, f)))
    with pytest.raises(ValueError, match="already"):
        tkv.hotswap_static_scales(got, sc)


@pytest.mark.parametrize("slot,accept_len", [(0, 4), (1, 0), (0, 11),
                                             (1, 20)])
def test_rollback_slot_matches_jax(small_cfg, slot, accept_len):
    jc, tc = _written_caches(small_cfg, 10)
    want = jkv.rollback_slot(jc, slot, accept_len)
    tkv.rollback_slot(tc, slot, accept_len)
    np.testing.assert_array_equal(tc.kv_pos.numpy(), _np(want.kv_pos))


# ---------------------------------------------------- the static engine ---
@pytest.fixture(scope="module")
def static_workload():
    cfg, jparams, tparams = quantized_pair("stablelm-1.6b")
    rng = np.random.default_rng(12)
    calib_toks = [rng.integers(0, cfg.vocab, size=(2, 32)) for _ in range(2)]
    scales = j_kv_scales(j_collect(cfg, jparams, calib_toks, qchunks=4))
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(3, 30)))
               for _ in range(5)]
    return cfg, jparams, tparams, scales, prompts


@pytest.mark.parametrize("chunk", [96, 7])
def test_static_engine_matches_jax_chunked_engine(static_workload, chunk):
    cfg, jparams, tparams, scales, prompts = static_workload
    kw = dict(n_slots=3, max_len=48, max_new_tokens=6, kv_mode="int8",
              prefill_chunk=chunk)
    jeng = JEngine(cfg, jparams, JEngineConfig(**kw, flight=False,
                                               metrics=False),
                   kv_scales=scales)
    teng = Engine(cfg, tparams, EngineConfig(**kw), device="cpu",
                  kv_scales=scales)
    for p in prompts:
        jeng.submit(p)
        teng.submit(p)
    want = [r.out for r in jeng.drain()]
    got = teng.drain()
    assert teng.cache.static
    assert [r.finish_reason for r in got] == ["budget"] * len(prompts)
    assert [r.out for r in got] == want


def test_static_scales_need_int8(small_cfg):
    sc = static_scales(np.random.default_rng(0), small_cfg.n_layers,
                       small_cfg.n_kv_heads, 4)
    with pytest.raises(ValueError, match="mode='int8'"):
        tkv.init_slot_cache(small_cfg, 1, 8, mode="fp", kv_scales=sc,
                            device="cpu")


def test_engine_load_kv_scales_mid_flight_matches_jax(static_workload):
    """A dynamic int8 engine switched to static scales after its third
    step (slots mid-prefill and mid-decode) gives the JAX engine's tokens
    under the same switch, and serves static from then on."""
    cfg, jparams, tparams, scales, prompts = static_workload
    kw = dict(n_slots=3, max_len=48, max_new_tokens=6, kv_mode="int8",
              prefill_chunk=7)
    jeng = JEngine(cfg, jparams, JEngineConfig(**kw, flight=False,
                                               metrics=False))
    teng = Engine(cfg, tparams, EngineConfig(**kw), device="cpu")
    for p in prompts:
        jeng.submit(p)
        teng.submit(p)
    for _ in range(3):
        jeng.step()
        teng.step()
    jeng.load_kv_scales(scales)
    teng.load_kv_scales(scales)
    assert teng.cache.static and teng.cache.k_scale.shape[1:3] == (1, 1)
    want = [r.out for r in jeng.drain()]
    assert [r.out for r in teng.drain()] == want
