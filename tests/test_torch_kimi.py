"""Port parity, kimi-k2-1t-a32b's shapes: head_dim 112 with sub-channel
chunks of 28 through both attention kernels' plain versions and the K/V
quantizers, the reduced kimi at head_dim 112 through the engine, and the
slabbed quantization of large leaves (expert stacks by whole matrices,
large matrices by rows) that the full-width build takes.

The attention cases hold the port's plain versions to the JAX package's
jnp paths (``use_pallas=False``) at D = 112, C = 4 in every cache mode:
int8 with per-entry scales, int8 with static per-layer scales, fp32 and
bf16, the prefill also as the speculative verify pass. Tolerances: codes
and scales bit-identical; fp32 outputs atol 1e-5 (summation order); a
bf16 cache's values are exact in fp32, so the same. The engine: the
port's seeded init of reduced kimi with ``head_dim_override=112`` (the
JAX package's ``reduced()`` keeps head_dim 32), quantized by the port
(INT4 SplitQuant) and handed to JAX as ``SplitQuantTensor``s, greedy
tokens identical over int8 caches with dynamic and static scales. The
slabs: packed bytes identical to the unslabbed quantization.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine.kvcache import quantize_kv as j_quantize_kv
from repro.engine.kvcache import quantize_kv_static as j_quantize_kv_static
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.prefill_attention import prefill_attention as j_prefill

from repro_torch import calib
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import apply as tapply
from repro_torch.core.quantize import QuantConfig as TQuantConfig
from repro_torch.engine import Engine, EngineConfig
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.prefill_attention import (
    prefill_attention, prefill_attention_ref, quantize_kv,
    quantize_kv_static, write_kv_rows)
from repro_torch.models import transformer as tt

from test_torch_moe import _to_jax
from torch_threads import one_torch_thread  # noqa: F401

KIMI = "kimi-k2-1t-a32b"
D, C = 112, 4
ATOL = 1e-5
MODES = ["dynamic", "static", "fp32", "bf16"]
J = jnp.asarray


def _t(x):
    return torch.from_numpy(np.array(x))


def _static(x, rng):
    """Per-(head, chunk) static (S, Z) of x (..., Hkv, D) from its own
    range, S moved by U(0.5, 2) and Z by a fraction, so that the codes
    test the rounding of S·x + Z and not the clip."""
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
        sc = (ks, kz, vs, vz)
        return (qk, qv, dict(mode="int8", k_scale=ks, k_zero=kz,
                             v_scale=vs, v_zero=vz),
                _t(qk), _t(qv), tuple(map(_t, sc)))
    if mode == "static":
        (ks, kz), (vs, vz) = _static(k, rng), _static(v, rng)
        qk, qv = j_quantize_kv_static(J(k), ks, kz), \
            j_quantize_kv_static(J(v), vs, vz)
        return (qk, qv, dict(mode="int8", k_scale=J(ks), k_zero=J(kz),
                             v_scale=J(vs), v_zero=J(vz)),
                _t(qk), _t(qv), tuple(map(_t, (ks, kz, vs, vz))))
    if mode == "bf16":
        kb, vb = J(k).astype(jnp.bfloat16), J(v).astype(jnp.bfloat16)
        tk = torch.from_numpy(np.asarray(kb.astype(jnp.float32)))
        tv = torch.from_numpy(np.asarray(vb.astype(jnp.float32)))
        return (kb, vb, dict(mode="fp"), tk.to(torch.bfloat16),
                tv.to(torch.bfloat16), ())
    return J(k), J(v), dict(mode="fp"), _t(k), _t(v), ()


# ------------------------------------------------------------ attention ---
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("Hq,Hkv", [(8, 1), (4, 4)])
def test_decode_at_head_dim_112_matches_jax(mode, Hq, Hkv):
    """Decode attention's plain version at D = 112, chunks of 28: ragged
    slots, an empty one, a stale row past q_pos."""
    rng = np.random.default_rng(Hq + 10 * MODES.index(mode))
    N, T = 4, 40
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
def test_prefill_at_head_dim_112_matches_jax(mode, verify):
    """Chunked prefill attention's plain version at D = 112, GQA 8/1,
    chunks of 28, as a chunk and as a verify window: the output, and the
    chunk's codes and scales bit-identical to JAX's epilogue."""
    rng = np.random.default_rng(3 + MODES.index(mode) + 7 * verify)
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
def test_kv_quantizers_and_write_at_chunks_of_28(scale):
    """The K/V quantizers at D = 112, C = 4 bit-identical to JAX's (a
    degenerate chunk of zeros and one of one value included), and the
    cache write of a chunk and of a decode step storing those codes and
    scales."""
    rng = np.random.default_rng(int(scale * 10))
    x = (rng.standard_normal((6, 2, D)) * scale).astype(np.float32)
    x[0, 0, :28] = 0.0
    x[1, 1, 28:56] = -4.0
    for a, b in zip(j_quantize_kv(J(x), C), quantize_kv(_t(x), C)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    s, z = _static(x, rng)
    np.testing.assert_array_equal(
        np.asarray(j_quantize_kv_static(J(x), s, z)),
        quantize_kv_static(_t(x), _t(s), _t(z)).numpy())
    N, T = 3, 16
    dst = [torch.zeros((N, T, 2, D), dtype=torch.int8) for _ in range(2)]
    kv_pos = torch.full((N, T), -1, dtype=torch.int32)
    scales = [torch.zeros((N, T, 2, C)) for _ in range(4)]
    qk, ks, kz = j_quantize_kv(J(x), C)
    qv, vs, vz = j_quantize_kv(J(-x), C)
    write_kv_rows(_t(x), _t(-x), *dst, kv_pos, *scales, slot=1, pos_start=4,
                  length=5)
    np.testing.assert_array_equal(dst[0][1, 4:10].numpy(), np.asarray(qk))
    np.testing.assert_array_equal(dst[1][1, 4:10].numpy(), np.asarray(qv))
    np.testing.assert_array_equal(scales[2][1, 4:10].numpy(),
                                  np.asarray(vs))
    assert kv_pos[1, 4:10].tolist() == [4, 5, 6, 7, 8, -1]
    write_kv_rows(_t(x[:N]), _t(x[:N]), *dst, kv_pos, *scales,
                  positions=torch.tensor([9, 20, 0], dtype=torch.int32))
    np.testing.assert_array_equal(dst[0][0, 9].numpy(), np.asarray(qk)[0])
    np.testing.assert_array_equal(scales[1][1, 4].numpy(), np.asarray(kz)[1])
    assert kv_pos[:, [9, 4, 0]].diagonal().tolist() == [9, 20, 0]


# ------------------------------------------------------------- engine ---
@functools.cache
def _kimi():
    """Reduced kimi at head_dim 112 in both packages, the port's seeded
    init quantized by the port (INT4 SplitQuant), and the same codes as a
    JAX tree."""
    cfg = dataclasses.replace(get_arch(KIMI).reduced(), head_dim_override=D)
    tcfg = dataclasses.replace(t_arch(KIMI).reduced(), head_dim_override=D)
    packed, report = tapply.quantize_tree(
        tt.init(tcfg, seed=0, device="cpu"),
        tapply.QuantPolicy(cfg=TQuantConfig(bits=4)), seed=0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(3, 40)))
               for _ in range(4)]
    return cfg, tcfg, packed, _to_jax(packed), prompts, report


ENGINE_KW = dict(n_slots=3, max_len=64, max_new_tokens=5, kv_mode="int8",
                 prefill_chunk=16)


@pytest.mark.parametrize("static", [False, True])
def test_reduced_kimi_at_head_dim_112_engine_matches_jax(static):
    """The engine over reduced kimi with head_dim 112 (GQA 4/4, one dense
    and one MoE layer of 8 experts top-2), an int8 cache of chunks of 28,
    prompts spanning 16-token chunks: the JAX engine's greedy tokens, with
    dynamic scales and with static ones from the port's calibration."""
    cfg, tcfg, packed, jq, prompts, _ = _kimi()
    assert tcfg.head_dim == D and cfg.head_dim == D
    scales = None
    if static:
        rng = np.random.default_rng(0)
        scales = calib.kv_static_scales(calib.collect_kv_stats(
            tcfg, packed, [rng.integers(0, cfg.vocab, (2, 40))]))
    jeng = JEngine(cfg, jq, JEngineConfig(**ENGINE_KW, flight=False,
                                          metrics=False), kv_scales=scales)
    eng = Engine(tcfg, packed, EngineConfig(**ENGINE_KW), device="cpu",
                 kv_scales=scales)
    for e in (jeng, eng):
        for p in prompts:
            e.submit(p)
    jout = [r.out for r in jeng.drain()]
    fin = eng.drain()
    assert [r.finish_reason for r in fin] == ["budget"] * 4
    assert eng.cache.static == static
    assert [r.out for r in fin] == jout


# --------------------------------------------------------------- slabs ---
def _packed_bytes(pw):
    return [getattr(pw, f) for f in ("qp", "cp", "recip", "shift", "scale",
                                     "zero")]


@pytest.mark.parametrize("method", ["splitquant", "baseline"])
def test_stack_slabs_give_the_same_bytes(method):
    """An expert stack of 5 matrices quantized in slabs of 1, 3 and 5
    matrices: the same packed bytes and deployed count; each matrix's
    k-means draws from its own generator."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, 64, 96)).astype(np.float32))
    pol = tapply.QuantPolicy(cfg=TQuantConfig(bits=4), method=method)
    outs = []
    for per in (1, 3, 5):
        gen = torch.Generator().manual_seed(3) if method == "splitquant" \
            else None
        outs.append(tapply.quantize_stack(gen, w, pol, per * 64 * 96))
    for pw, nbytes in outs[1:]:
        assert nbytes == outs[0][1] and pw.shape == (5, 64, 96)
        for a, b in zip(_packed_bytes(pw), _packed_bytes(outs[0][0])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("method", ["splitquant", "baseline"])
def test_row_slabs_equal_the_whole_matrix(method, per_channel):
    """A matrix quantized in slabs of 8 and of 24 rows (its ranges
    combined across slabs): the bytes and the deployed count of
    ``pack_for_kernel`` of the whole matrix's quantization, k-means on
    the same generator."""
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (72, 40)).astype(np.float32))
    w[3, :5] = 9.0                                    # outliers
    pol = tapply.QuantPolicy(cfg=TQuantConfig(bits=4,
                                              per_channel=per_channel),
                             method=method)
    gen = lambda: torch.Generator().manual_seed(4)    # noqa: E731
    sq = tapply._quantize(gen(), w, pol, 0)
    want = tapply.pack_for_kernel(sq)
    for rows in (8, 24):
        pw, nbytes = tapply.quantize_rows(gen(), w, pol, rows * 40)
        assert nbytes == sq.nbytes_deployed() and pw.k == want.k
        for a, b in zip(_packed_bytes(pw), _packed_bytes(want)):
            assert torch.equal(a, b)


def test_leaf_quantizer_takes_slabs_above_its_limit(monkeypatch):
    """The quantizer with a small slab limit (every expert stack in slabs
    of one matrix, the matrices above it in slabs of rows) gives the
    bytes and report of the default limit on reduced kimi."""
    _, tcfg, want, _, _, wrep = _kimi()
    monkeypatch.setattr(tapply, "SLAB_ELEMS", 128 * 256)
    q = tapply.LeafQuantizer(tapply.QuantPolicy(cfg=TQuantConfig(bits=4)),
                             0)
    got = tt.init(tcfg, seed=0, device="cpu")
    q.walk(got)
    assert q.report == wrep
    moe = got["moe_layers"][0]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        for a, b in zip(_packed_bytes(moe[name]),
                        _packed_bytes(want["moe_layers"][0]["moe"][name])):
            assert torch.equal(a, b)
    for a, b in zip(_packed_bytes(got["lm_head"]),
                    _packed_bytes(want["lm_head"])):
        assert torch.equal(a, b)
