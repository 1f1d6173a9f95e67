"""Port parity, model side: the port's ``decode_step_slots`` and
``prefill_chunk_slots`` against the JAX package's, on the three reduced
dense parity archs (MHA + half RoPE, GQA + half RoPE, full RoPE at
θ=5e5), with INT4 SplitQuant weights quantized by the JAX package and
carried over by the bridge.

Tolerances: logits atol 1e-4 with an fp cache (fp32 summation order);
0.05 with an int8 cache, the bound of tests/test_engine.py, since float
noise can flip one KV code.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import QuantConfig, QuantPolicy, quantize_tree
from repro.engine.kvcache import init_slot_cache as j_init_cache
from repro.models import get_model, transformer as jt

from repro_torch import bridge
from repro_torch.engine.kvcache import init_slot_cache
from repro_torch.models import transformer as tt

from test_torch_quant import _to_numpy_tree

ARCHS = ["stablelm-1.6b", "chatglm3-6b", "llama3-405b"]
MAX_LEN, N_SLOTS, BUCKET = 48, 2, 16


def quantized_pair(arch):
    """(cfg, JAX quantized params, the port's bridged params)."""
    cfg = get_arch(arch).reduced()
    params = get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    qtree, _ = quantize_tree(jax.random.PRNGKey(1), params,
                             QuantPolicy(cfg=QuantConfig(bits=4)))
    port = bridge.from_jax_tree(_to_numpy_tree(qtree), dtype=torch.float32,
                                device="cpu")
    return cfg, qtree, port


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return quantized_pair(request.param)


@pytest.mark.parametrize("kv_mode,atol", [("fp", 1e-4), ("int8", 0.05)])
def test_slot_entry_points_match_jax(pair, kv_mode, atol):
    cfg, jparams, tparams = pair
    rng = np.random.default_rng(0)
    jcache = j_init_cache(cfg, N_SLOTS, MAX_LEN, mode=kv_mode)
    tcache = init_slot_cache(cfg, N_SLOTS, MAX_LEN, mode=kv_mode,
                             device="cpu")
    jchunk = jax.jit(lambda p, c, t, s, ps, n: jt.prefill_chunk_slots(
        p, cfg, c, t, s, ps, n), static_argnums=(3, 4, 5))
    jdecode = jax.jit(lambda p, c, t, pos: jt.decode_step_slots(
        p, cfg, c, t, pos, fused=True))
    # slot 0: two chunks (the second attends the first's cache rows),
    # slot 1: one chunk; the last chunk of slot 0 is bucket-padded
    chunks = [(0, 0, 16), (0, 16, 9), (1, 0, 7)]
    last = {}
    for slot, pos_start, n in chunks:
        toks = np.zeros((1, BUCKET), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab, n)
        jl, jcache = jchunk(jparams, jcache, jnp.asarray(toks), slot,
                            pos_start, n)
        tl = tt.prefill_chunk_slots(tparams, cfg, tcache,
                                    torch.from_numpy(toks).long(), slot,
                                    pos_start, n)
        assert tl.shape == (1, cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                                   rtol=0)
        last[slot] = (int(np.argmax(np.asarray(jl)[0])), pos_start + n)
    toks = np.array([[last[0][0]], [last[1][0]]], np.int32)
    pos = np.array([last[0][1], last[1][1]], np.int32)
    for _ in range(3):
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(toks),
                             jnp.asarray(pos))
        tl = tt.decode_step_slots(tparams, cfg, tcache,
                                  torch.from_numpy(toks).long(),
                                  torch.from_numpy(pos))
        assert tl.shape == (N_SLOTS, 1, cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                                   rtol=0)
        toks = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1
    np.testing.assert_array_equal(tcache.kv_pos.numpy(),
                                  np.asarray(jcache.kv_pos))


@pytest.mark.parametrize("kv_mode", ["fp", "int8"])
def test_chunk_rows_past_max_len_are_dropped(kv_mode):
    """A bucket-padded last chunk sticking out past max_len: rows beyond
    the cache are dropped, valid rows marked, padding marked -1 — the
    same cache bytes as the JAX package's scatter with mode="drop"."""
    from repro.engine.kvcache import slot_chunk_prefill as j_chunk
    from repro_torch.engine.kvcache import slot_chunk_prefill as t_chunk
    cfg = get_arch("chatglm3-6b").reduced()
    T, Sq, pos_start, length, slot = 20, 8, 16, 3, 1
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(4)
    q = rng.standard_normal((Sq, Hq, D)).astype(np.float32)
    kn = rng.standard_normal((Sq, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((Sq, Hkv, D)).astype(np.float32)
    jc = j_init_cache(cfg, 2, T, mode=kv_mode)
    layer = jax.tree_util.tree_map(lambda a: a[0], jc)
    jo, jl = j_chunk(layer, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                     slot, pos_start, length)
    tc = init_slot_cache(cfg, 2, T, mode=kv_mode, device="cpu")
    to = t_chunk(tc, 0, torch.from_numpy(q), torch.from_numpy(kn),
                 torch.from_numpy(vn), slot, pos_start, length)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    for f in ("k", "v", "kv_pos", "k_scale", "k_zero", "v_scale", "v_zero"):
        np.testing.assert_array_equal(getattr(tc, f)[0].numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)


@pytest.mark.parametrize("variant,theta", [("full", 5e5), ("half", 1e4)])
def test_norms_and_rope_match_jax(variant, theta):
    from repro.models import common as jc
    from repro_torch.models import common as tc
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 900, size=(3, 7)).astype(np.int32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    bias = rng.standard_normal(32).astype(np.float32) * 0.1
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(
        tc.apply_rope(tx, torch.from_numpy(pos), theta, variant).numpy(),
        np.asarray(jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                                 variant)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tc.rms_norm(tx, torch.from_numpy(scale)).numpy(),
        np.asarray(jc.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tc.layer_norm(tx, torch.from_numpy(scale),
                      torch.from_numpy(bias)).numpy(),
        np.asarray(jc.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias))), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ffn_type", ["swiglu", "geglu", "gelu"])
def test_ffn_matches_jax(ffn_type):
    from repro.models.ffn import apply_ffn as j_ffn
    from repro.models.ffn import init_ffn as j_init
    from repro_torch.models.ffn import apply_ffn as t_ffn
    p = j_init(jax.random.PRNGKey(2), 32, 64, ffn_type, jnp.float32,
               bias=True)
    if ffn_type == "gelu":                   # non-zero biases
        p["b_up"] = p["b_up"] + 0.1
        p["b_down"] = p["b_down"] - 0.2
    x = np.random.default_rng(6).standard_normal((5, 32)).astype(np.float32)
    want = np.asarray(j_ffn(p, jnp.asarray(x), ffn_type))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    np.testing.assert_allclose(t_ffn(tp, torch.from_numpy(x),
                                     ffn_type).numpy(), want, atol=1e-5,
                               rtol=0)
