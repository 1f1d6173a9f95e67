"""Port parity, kernel side: the plain PyTorch versions of the three
kernels the port writes in CUDA, against the JAX package on the same
numpy inputs, in fp32 on the CPU (where the port's wrappers take the
plain versions because the tensors lie on the CPU).

Tolerances: outputs atol 1e-5 (fp32; only the summation order differs);
the prefill epilogue's codes and scales exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.kvcache import quantize_kv as j_quantize_kv
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.packing import pack_cids, pack_codes
from repro.kernels.prefill_attention import prefill_attention as j_prefill

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.prefill_attention import (prefill_attention,
                                                   prefill_attention_ref,
                                                   quantize_kv)
from repro_torch.kernels.splitquant_matmul import splitquant_matmul

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("M", [1, 8, 13])
def test_splitquant_matmul_ref_matches_jax(bits, k, M):
    rng = np.random.default_rng(bits * 10 + k)
    K, N = 64, 40
    q = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), size=(K, N),
                     dtype=np.int8)
    cid = rng.integers(0, k, size=(K, N), dtype=np.uint8)
    # weights of a trained layer's scale (|ŵ| ≲ 0.5, as 1/S of eq. 2)
    recip = ((rng.random((k, N)) + 0.5) / 2 ** bits).astype(np.float32)
    shift = (rng.standard_normal((k, N)) * 0.05).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qp = np.asarray(pack_codes(jnp.asarray(q), bits))
    cp = np.asarray(pack_cids(jnp.asarray(cid)))
    want = np.asarray(jref.splitquant_matmul_ref(
        jnp.asarray(x), jnp.asarray(qp), jnp.asarray(cp), jnp.asarray(recip),
        jnp.asarray(shift), bits))
    got = splitquant_matmul(_t(x), _t(qp), _t(cp), _t(recip), _t(shift),
                            bits=bits, k=k)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _decode_case(seed, N=4, T=48, Hq=4, Hkv=2, D=32, C=4):
    """Ragged slots, one empty slot, and a stale row past q_pos."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(N, Hq, D), f(N, T, Hkv, D), f(N, T, Hkv, D)
    kv_pos = np.full((N, T), -1, np.int32)
    q_pos = np.zeros(N, np.int32)
    for n, depth in enumerate([37, 5, 0, 47][:N]):
        kv_pos[n, :depth] = np.arange(depth)
        q_pos[n] = max(depth - 1, 0)
    kv_pos[1, 5] = 9                  # written but past q_pos: masked
    return q, k, v, kv_pos, q_pos


@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("kv_chunk", [None, 16])
def test_decode_ref_matches_jax(mode, Hq, Hkv, kv_chunk):
    q, k, v, kv_pos, q_pos = _decode_case(Hq * 10 + Hkv, Hq=Hq, Hkv=Hkv)
    kw = dict(kv_chunk=kv_chunk, use_pallas=False)
    if mode == "int8":
        qk, ks, kz = j_quantize_kv(jnp.asarray(k), 4)
        qv, vs, vz = j_quantize_kv(jnp.asarray(v), 4)
        want = j_decode(jnp.asarray(q), qk, qv, jnp.asarray(kv_pos),
                        jnp.asarray(q_pos), k_scale=ks, k_zero=kz,
                        v_scale=vs, v_zero=vz, mode="int8", **kw)
        got = decode_attention_ref(_t(q), _t(qk), _t(qv), _t(kv_pos),
                                   _t(q_pos), _t(ks), _t(kz), _t(vs), _t(vz),
                                   kv_chunk=kv_chunk)
    else:
        want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(kv_pos), jnp.asarray(q_pos), mode="fp",
                        **kw)
        got = decode_attention_ref(_t(q), _t(k), _t(v), _t(kv_pos),
                                   _t(q_pos), kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert np.all(got.numpy()[2] == 0.0)          # empty slot: exact 0


def test_decode_ref_matches_pallas_interpret():
    q, k, v, kv_pos, q_pos = _decode_case(5)
    qk, ks, kz = j_quantize_kv(jnp.asarray(k), 4)
    qv, vs, vz = j_quantize_kv(jnp.asarray(v), 4)
    want = j_decode(jnp.asarray(q), qk, qv, jnp.asarray(kv_pos),
                    jnp.asarray(q_pos), k_scale=ks, k_zero=kz, v_scale=vs,
                    v_zero=vz, mode="int8", kv_chunk=16, use_pallas=True,
                    interpret=True)
    got = decode_attention(_t(q), _t(qk), _t(qv), _t(kv_pos), _t(q_pos),
                           _t(ks), _t(kz), _t(vs), _t(vz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _prefill_case(seed, T=40, Hq=4, Hkv=2, D=32, prior=19, Sq=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k_new, v_new = f(Sq, Hq, D), f(Sq, Hkv, D), f(Sq, Hkv, D)
    ck, cv = f(T, Hkv, D), f(T, Hkv, D)
    kv_pos = np.full(T, -1, np.int32)
    kv_pos[:prior] = np.arange(prior)
    kv_pos[prior] = prior             # decode-parking garbage row: masked
    kv_pos[30] = 3                    # stale row of an earlier occupant
    return q, k_new, v_new, ck, cv, kv_pos


@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("pos_start,length", [(19, 11), (19, 16), (0, 7)])
def test_prefill_ref_matches_jax(mode, Hq, Hkv, pos_start, length):
    q, k_new, v_new, ck, cv, kv_pos = _prefill_case(Hq + Hkv + length,
                                                     Hq=Hq, Hkv=Hkv)
    if pos_start == 0:
        kv_pos[:] = -1
        kv_pos[0] = 0                 # an idle slot's ride-along mark
    J = jnp.asarray
    kw = dict(kv_chunk=8, use_pallas=False)
    if mode == "int8":
        qk, ks, kz = j_quantize_kv(J(ck), 4)
        qv, vs, vz = j_quantize_kv(J(cv), 4)
        want, jaux = j_prefill(J(q), J(k_new), J(v_new), qk, qv, J(kv_pos),
                               pos_start, length, k_scale=ks, k_zero=kz,
                               v_scale=vs, v_zero=vz, mode="int8", **kw)
        got = prefill_attention_ref(
            _t(q), _t(k_new), _t(v_new), _t(qk), _t(qv), _t(kv_pos),
            pos_start, length, _t(ks), _t(kz), _t(vs), _t(vz), kv_chunk=8)
        _, taux = prefill_attention(
            _t(q), _t(k_new), _t(v_new), _t(qk), _t(qv), _t(kv_pos),
            pos_start, length, _t(ks), _t(kz), _t(vs), _t(vz))
        assert len(taux) == len(jaux) == 6
        for a, b in zip(jaux, taux):          # codes and scales: exact
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    else:
        want, _ = j_prefill(J(q), J(k_new), J(v_new), J(ck), J(cv),
                            J(kv_pos), pos_start, length, mode="fp", **kw)
        got = prefill_attention_ref(_t(q), _t(k_new), _t(v_new), _t(ck),
                                    _t(cv), _t(kv_pos), pos_start, length,
                                    kv_chunk=8)
        _, taux = prefill_attention(_t(q), _t(k_new), _t(v_new), _t(ck),
                                    _t(cv), _t(kv_pos), pos_start, length)
        assert taux == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_prefill_ref_matches_pallas_interpret():
    q, k_new, v_new, ck, cv, kv_pos = _prefill_case(11)
    J = jnp.asarray
    qk, ks, kz = j_quantize_kv(J(ck), 4)
    qv, vs, vz = j_quantize_kv(J(cv), 4)
    want, _ = j_prefill(J(q), J(k_new), J(v_new), qk, qv, J(kv_pos), 19, 13,
                        k_scale=ks, k_zero=kz, v_scale=vs, v_zero=vz,
                        mode="int8", kv_chunk=8, use_pallas=True,
                        interpret=True)
    got, _ = prefill_attention(_t(q), _t(k_new), _t(v_new), _t(qk), _t(qv),
                               _t(kv_pos), 19, 13, _t(ks), _t(kz), _t(vs),
                               _t(vz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_quantize_kv_bit_identical(scale):
    rng = np.random.default_rng(int(scale * 10))
    x = (rng.standard_normal((7, 3, 64)) * scale).astype(np.float32)
    x[0, 0, :16] = 0.0                # degenerate chunk: all zero
    x[1, 2, 16:32] = -4.0             # degenerate chunk: one value
    want = j_quantize_kv(jnp.asarray(x), 4)
    got = quantize_kv(_t(x), 4)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
