"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips (in its fixture, not
at import) when no card is present. Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 outputs atol 1e-4 relative to the output's scale
(summation order differs); bf16 outputs 2 ulp-ish (2e-2 relative); the
quantize epilogue's codes and scales exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.prefill_attention import (prefill_attention,
                                                   prefill_attention_ref,
                                                   quantize_kv,
                                                   quantize_kv_ref)
from repro_torch.kernels.ref import splitquant_matmul_ref
from repro_torch.kernels.splitquant_matmul import splitquant_matmul

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, rel):
    scale = max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale, (err, rel * scale)


def _packed(gen, K, N, bits, k, dev):
    qp = torch.randint(0, 256, (K * bits // 8, N), generator=gen,
                       dtype=torch.uint8, device=dev)
    cids = torch.randint(0, k, (K, N), generator=gen, device=dev)
    from repro_torch.kernels.packing import pack_cids
    cp = pack_cids(cids.to(torch.uint8))
    recip = (torch.rand((k, N), generator=gen, device=dev) + 0.5) / 2 ** bits
    shift = torch.randn((k, N), generator=gen, device=dev) * 0.05
    return qp, cp, recip, shift


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(8, 256, 384), (13, 200, 130),
                                   (96, 512, 1024), (1, 64, 4)])
def test_matmul_kernel_vs_plain(dev, bits, dtype, M, K, N):
    gen = torch.Generator(device=dev).manual_seed(M + K + N + bits)
    qp, cp, recip, shift = _packed(gen, K, N, bits, 3, dev)
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    before = splitquant_matmul.launches
    got = splitquant_matmul(x, qp, cp, recip, shift, bits=bits, k=3)
    torch.cuda.synchronize()
    assert splitquant_matmul.launches == before + 1
    want = splitquant_matmul_ref(x, qp, cp, recip, shift, bits)
    assert got.dtype == dtype and got.shape == (M, N)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)


def test_matmul_kernel_rejects_untested_bits(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    qp, cp, recip, shift = _packed(gen, 64, 32, 4, 3, dev)
    x = torch.randn((8, 64), generator=gen, device=dev)
    with pytest.raises(RuntimeError):      # the launcher returns an error
        splitquant_matmul(x, qp, cp, recip, shift, bits=3, k=3)


def test_attention_kernels_reject_bf16_cache(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v, kv_pos, q_pos, sc = _decode_inputs(gen, dev, 4, 64, 4, 4, 32,
                                                False, torch.bfloat16)
    with pytest.raises(TypeError):
        decode_attention(q, k.bfloat16(), v.bfloat16(), kv_pos, q_pos, *sc)
    with pytest.raises(TypeError):
        prefill_attention(q, q, q, k[0].bfloat16(), v[0].bfloat16(),
                          kv_pos[0], 10, 4)


def _decode_inputs(gen, dev, N, T, Hq, Hkv, D, int8, dtype):
    q = torch.randn((N, Hq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((N, T, Hkv, D), generator=gen, device=dev)
    v = torch.randn((N, T, Hkv, D), generator=gen, device=dev)
    kv_pos = torch.full((N, T), -1, dtype=torch.int32, device=dev)
    depths = [T - 3, 1, 0] + [int(d) for d in torch.randint(
        1, T, (N - 3,), generator=gen, device=dev)]
    for n, depth in enumerate(depths[:N]):
        kv_pos[n, :depth] = torch.arange(depth, device=dev)
    q_pos = torch.tensor([max(d - 1, 0) for d in depths[:N]],
                         dtype=torch.int32, device=dev)
    if int8:
        qk, ks, kz = quantize_kv_ref(k, 4)
        qv, vs, vz = quantize_kv_ref(v, 4)
        return q, qk, qv, kv_pos, q_pos, (ks, kz, vs, vz)
    return q, k, v, kv_pos, q_pos, (None,) * 4        # fp32 cache


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("Hq,Hkv,D", [(8, 8, 64), (32, 2, 128), (4, 4, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_vs_plain(dev, int8, Hq, Hkv, D, dtype):
    gen = torch.Generator(device=dev).manual_seed(Hq + Hkv + D)
    q, k, v, kv_pos, q_pos, sc = _decode_inputs(gen, dev, 5, 100, Hq, Hkv,
                                                D, int8, dtype)
    got = decode_attention(q, k, v, kv_pos, q_pos, *sc)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, kv_pos, q_pos, *sc)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)
    assert torch.all(got[2] == 0)                     # empty slot


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("Hq,Hkv,D", [(8, 8, 64), (32, 2, 128)])
@pytest.mark.parametrize("pos_start,length,Sq", [(37, 96, 96), (0, 20, 32),
                                                 (250, 7, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_vs_plain(dev, int8, Hq, Hkv, D, pos_start, length,
                                 Sq, dtype):
    gen = torch.Generator(device=dev).manual_seed(pos_start + Sq + D)
    T = 256
    f = lambda *s: torch.randn(s, generator=gen, device=dev)
    q, kn, vn = f(Sq, Hq, D).to(dtype), f(Sq, Hkv, D).to(dtype), \
        f(Sq, Hkv, D).to(dtype)
    ck, cv = f(T, Hkv, D), f(T, Hkv, D)
    kv_pos = torch.full((T,), -1, dtype=torch.int32, device=dev)
    kv_pos[:min(pos_start, T)] = torch.arange(min(pos_start, T), device=dev)
    kv_pos[min(pos_start, T - 1)] = pos_start            # parked garbage row
    if int8:
        ck, ks, kz = quantize_kv_ref(ck, 4)
        cv, vs, vz = quantize_kv_ref(cv, 4)
        sc = (ks, kz, vs, vz)
    else:
        sc = (None,) * 4                                 # fp32 cache
    got, gaux = prefill_attention(q, kn, vn, ck, cv, kv_pos, pos_start,
                                  length, *sc)
    torch.cuda.synchronize()
    want = prefill_attention_ref(q, kn, vn, ck, cv, kv_pos, pos_start,
                                 length, *sc)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)
    if int8:
        wk = quantize_kv_ref(kn, 4)
        wv = quantize_kv_ref(vn, 4)
        for a, b in zip(gaux, (wk[0], wv[0], wk[1], wk[2], wv[1], wv[2])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_quantize_kv_kernel_bit_identical(dev, dtype, scale):
    gen = torch.Generator(device=dev).manual_seed(int(scale * 7))
    x = (torch.randn((33, 8, 64), generator=gen, device=dev) * scale)
    x[0, 0, :16] = 0.0
    x[1, 2, 16:32] = -4.0
    x = x.to(dtype)
    got = quantize_kv(x, 4)
    want = quantize_kv_ref(x, 4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_engine_card_matches_cpu(dev):
    """Reduced stablelm in fp32, INT4 SplitQuant weights and an int8 cache:
    the engine on the card gives the CPU engine's greedy tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.core.apply import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg = get_arch("stablelm-1.6b").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", device="cpu")
    prompts = seeded_prompts(cfg.vocab, 6, 3, 60, seed=1)
    outs = {}
    for d, p in (("cpu", params), ("cuda", tree_to(params, dev))):
        eng = Engine(cfg, p, EngineConfig(n_slots=3, max_len=96,
                                          max_new_tokens=8, kv_mode="int8",
                                          prefill_chunk=32), device=d)
        for pr in prompts:
            eng.submit(pr)
        outs[d] = [r.out for r in eng.drain()]
    assert outs["cuda"] == outs["cpu"]
