"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips (in its fixture, not
at import) when no card is present. Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The attention kernels are run at the serving head layouts of
stablelm-1.6b and chatglm3-6b, kimi-k2-1t-a32b's GQA 64/8 at head_dim
112 with sub-channel chunks of 28 and paligemma-3b's MQA 8/1 at head_dim
256, over int8, fp32, bf16 and float16 caches, at depths and chunk
positions that probe their split plans, for both kernel variants of the
prefill.

Tolerances: fp32 outputs atol 1e-4 relative to the output's scale
(summation order differs); bf16 outputs 2 ulp-ish (2e-2 relative); the
WKV state (fp32 in both types) 1e-4 relative; the quantize epilogue's and
the act-quant kernels' codes, scales and zeros exactly.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.core.splitquant import activation_chunk_bounds
from repro_torch.kernels import act_quant as aq
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import prefill_attention as pa
from repro_torch.kernels import wkv_chunked as wk
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.prefill_attention import (prefill_attention,
                                                   prefill_attention_ref,
                                                   quantize_kv,
                                                   quantize_kv_ref)
from repro_torch.kernels.ref import splitquant_matmul_ref
from repro_torch.kernels import splitquant_matmul as sqm
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


#: (M, K, N) of the matmul kernel tests: both row tiles of the tensor-core
#: kernel (64 for M <= 64, else 128), ragged M, K and N, and each tile
#: with and without K splits (tests/test_torch_matmul_plan.py checks that)
MATMUL_SHAPES = [
    (8, 256, 384), (13, 200, 130), (96, 512, 1024), (1, 64, 4),
    (1, 200, 130), (64, 512, 256), (65, 200, 130), (200, 1024, 384),
    (8, 256, 51200), (2048, 512, 2560), (2048, 512, 8960), (2048, 200, 130)]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES)
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


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [8, 200])
def test_matmul_kernel_other_cluster_counts(dev, k, dtype, M):
    gen = torch.Generator(device=dev).manual_seed(k + M)
    qp, cp, recip, shift = _packed(gen, 320, 260, 4, k, dev)
    x = torch.randn((M, 320), generator=gen, device=dev).to(dtype)
    got = splitquant_matmul(x, qp, cp, recip, shift, bits=4, k=k)
    torch.cuda.synchronize()
    want = splitquant_matmul_ref(x, qp, cp, recip, shift, 4)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype,variant", [
    (torch.bfloat16, sqm.TENSOR_CORE), (torch.float32, sqm.CUDA_CORE)])
@pytest.mark.parametrize("M", [8, 96, 2048])
def test_matmul_launches_the_variant_of_its_dtype(dev, dtype, variant, M):
    gen = torch.Generator(device=dev).manual_seed(M)
    qp, cp, recip, shift = _packed(gen, 256, 384, 4, 3, dev)
    x = torch.randn((M, 256), generator=gen, device=dev).to(dtype)
    before = dict(splitquant_matmul.variant_launches)
    splitquant_matmul(x, qp, cp, recip, shift, bits=4, k=3)
    after = splitquant_matmul.variant_launches
    assert after[variant] == before[variant] + 1
    assert all(after[v] == before[v] for v in after if v != variant)


@pytest.mark.parametrize("M,K,N", [(8, 2048, 2048), (96, 2048, 2048),
                                   (13, 200, 130)])
def test_matmul_split_k_bf16_is_deterministic(dev, M, K, N):
    assert sqm.plan(M, K, N, torch.bfloat16,
                    torch.cuda.get_device_properties(dev)
                    .multi_processor_count).splits > 1
    gen = torch.Generator(device=dev).manual_seed(K)
    qp, cp, recip, shift = _packed(gen, K, N, 4, 3, dev)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    a = splitquant_matmul(x, qp, cp, recip, shift, bits=4, k=3)
    b = splitquant_matmul(x, qp, cp, recip, shift, bits=4, k=3)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close(a, splitquant_matmul_ref(x, qp, cp, recip, shift, 4), 2e-2)


def test_matmul_counts_launches_by_bits(dev):
    """One launch at each of bits 2, 4 and 8 adds one to its bit-width's
    count and to no other; ``reset_counts`` zeroes them."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((8, 256), generator=gen, device=dev).to(torch.bfloat16)
    for bits in (2, 4, 8):
        qp, cp, recip, shift = _packed(gen, 256, 384, bits, 3, dev)
        before = dict(splitquant_matmul.bits_launches)
        splitquant_matmul(x, qp, cp, recip, shift, bits=bits, k=3)
        after = splitquant_matmul.bits_launches
        assert after[bits] == before[bits] + 1
        assert all(after[b] == before[b] for b in after if b != bits)
    sqm.reset_counts()
    assert not any(splitquant_matmul.bits_launches.values())


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A mixed INT2/INT4/INT8 bf16 tree quantized on the card (the
    percentile baseline on the lm_head) saved from CUDA tensors and
    restored onto the card into a dense tree: every PackedWeight equal to
    the original, on the card, and the logits through it equal."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_arch
    from repro_torch.core.apply import QuantPolicy, quantize_tree
    from repro_torch.core.quantize import QuantConfig
    from repro_torch.kernels.ops import PackedWeight
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_arch("stablelm-1.6b").reduced(),
                              param_dtype="bfloat16")
    dense = transformer.init(cfg, seed=0, device=dev)
    tree, _ = quantize_tree(dense, QuantPolicy(cfg=QuantConfig(bits=4)),
                            overrides={"layers/attn/wq": {"bits": 2},
                                       "layers/ffn/w_up": {"bits": 8},
                                       "lm_head": {"method": "percentile"}})
    ckpt.save(str(tmp_path), 0, tree)
    got, _ = ckpt.restore(str(tmp_path), transformer.init(cfg, seed=1,
                                                          device=dev))

    def walk(a, b):
        if isinstance(b, dict):
            for key in b:
                walk(a[key], b[key])
        elif isinstance(b, list):
            for x, y in zip(a, b):
                walk(x, y)
        elif isinstance(b, PackedWeight):
            assert (a.bits, a.k, a.shape, a.orig_dtype) == \
                (b.bits, b.k, b.shape, b.orig_dtype)
            for f in ("qp", "cp", "recip", "shift", "scale", "zero"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.device.type == "cuda" and torch.equal(x, y), f
        else:
            assert a.device.type == "cuda" and torch.equal(a, b)
    walk(got, tree)
    assert got["layers"][0]["attn"]["wq"].bits == 2
    toks = torch.arange(1, 17, device=dev)[None]
    want = transformer.forward(tree, cfg, {"tokens": toks})[0]
    assert torch.equal(transformer.forward(got, cfg, {"tokens": toks})[0],
                       want)


def test_matmul_kernel_rejects_untested_bits(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    qp, cp, recip, shift = _packed(gen, 64, 32, 4, 3, dev)
    x = torch.randn((8, 64), generator=gen, device=dev)
    with pytest.raises(RuntimeError):      # the launcher returns an error
        splitquant_matmul(x, qp, cp, recip, shift, bits=3, k=3)


def test_attention_kernels_take_fp16_cache(dev):
    """A float16 cache through the three cache kernels (once refused):
    each launches, counted under float16, and agrees with its plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v, kv_pos, q_pos, sc = _decode_inputs(gen, dev, 4, 64, 4, 4, 32,
                                                False, torch.bfloat16)
    kh, vh = k.half(), v.half()
    before = (decode_attention.dtype_launches["float16"],
              prefill_attention.dtype_launches["float16"],
              pa.write_kv_rows.dtype_launches["float16"])
    _close(decode_attention(q, kh, vh, kv_pos, q_pos, *sc),
           decode_attention_ref(q, kh, vh, kv_pos, q_pos, *sc), 2e-2)
    _close(prefill_attention(q, q, q, kh[0], vh[0], kv_pos[0], 10, 4)[0],
           prefill_attention_ref(q, q, q, kh[0], vh[0], kv_pos[0], 10, 4),
           2e-2)
    want = [kh.clone(), vh.clone(), kv_pos.clone()]
    pa.write_kv_rows_ref(q[:, :4], q[:, :4], *want, positions=q_pos)
    pa.write_kv_rows(q[:, :4], q[:, :4], kh, vh, kv_pos, positions=q_pos)
    torch.cuda.synchronize()
    for got, ref in zip((kh, vh, kv_pos), want):
        assert torch.equal(got, ref)
    assert (decode_attention.dtype_launches["float16"],
            prefill_attention.dtype_launches["float16"],
            pa.write_kv_rows.dtype_launches["float16"]) == tuple(
                b + 1 for b in before)


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
@pytest.mark.parametrize("Hq,Hkv,D", [(8, 8, 64), (32, 2, 128), (4, 4, 32),
                                      (64, 8, 112), (4, 4, 112), (8, 1, 256),
                                      (2, 1, 256)])
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
@pytest.mark.parametrize("Hq,Hkv,D", [(8, 8, 64), (32, 2, 128), (64, 8, 112),
                                      (8, 1, 256)])
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


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _cache(gen, dev, N, T, Hkv, D, int8):
    """K and V (N, T, Hkv, D): int8 codes with their four scale arrays, or
    fp32 with (None,) * 4."""
    k = torch.randn((N, T, Hkv, D), generator=gen, device=dev)
    v = torch.randn((N, T, Hkv, D), generator=gen, device=dev)
    if not int8:
        return k, v, (None,) * 4
    qk, ks, kz = quantize_kv_ref(k, 4)
    qv, vs, vz = quantize_kv_ref(v, 4)
    return qk, qv, (ks, kz, vs, vz)


def _split_depths(T, rows):
    """Six slot depths for a plan of ``rows``-row splits: empty (exact 0),
    one row, a full slot, and the last valid row just before, at and after
    a split boundary (where T has one; else T - 1, T / 2 and 2)."""
    edge = [rows - 1, rows, rows + 1] if rows < T else [T - 1, T // 2, 2]
    return [0, 1, T] + edge


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 32, 64), (32, 2, 128), (4, 4, 32),
                                      (64, 8, 112), (4, 4, 112), (8, 1, 256)])
@pytest.mark.parametrize("T", [100, 1024, 4096])
def test_decode_split_kernel_vs_plain(dev, T, Hq, Hkv, D, dtype, int8):
    """The split-T kernel at the depths that probe its plan, plus a slot
    whose only valid rows lie in its last 5 rows (every earlier split of
    it empty), against the plain version."""
    N = 7
    p = da.decode_plan(N, T, Hkv, Hq // Hkv, _sms(dev), D)
    depths = _split_depths(T, p.rows)
    gen = torch.Generator(device=dev).manual_seed(T + Hkv + D)
    q = torch.randn((N, Hq, D), generator=gen, device=dev).to(dtype)
    k, v, sc = _cache(gen, dev, N, T, Hkv, D, int8)
    kv_pos = torch.full((N, T), -1, dtype=torch.int32, device=dev)
    for n, depth in enumerate(depths):
        kv_pos[n, :depth] = torch.arange(depth, device=dev)
    kv_pos[N - 1, T - 5:] = torch.arange(5, device=dev)
    q_pos = torch.tensor([max(d - 1, 0) for d in depths] + [4],
                         dtype=torch.int32, device=dev)
    before = decode_attention.launches
    got = decode_attention(q, k, v, kv_pos, q_pos, *sc)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_ref(q, k, v, kv_pos, q_pos, *sc)
    assert got.dtype == dtype and got.shape == (N, Hq, D)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)
    assert torch.all(got[depths.index(0)] == 0)          # empty slot


@pytest.mark.parametrize("T,variant", [(64, da.WHOLE), (1024, da.SPLIT)])
def test_decode_counts_its_variant(dev, T, variant):
    """T shorter than a split's least length runs whole; 8 slots of 1024
    rows are split."""
    p = da.decode_plan(8, T, 2, 4, _sms(dev))
    assert (p.splits > 1) == (variant == da.SPLIT)
    gen = torch.Generator(device=dev).manual_seed(T)
    q = torch.randn((8, 8, 64), generator=gen, device=dev).to(torch.bfloat16)
    k, v, sc = _cache(gen, dev, 8, T, 2, 64, True)
    kv_pos = torch.arange(T, dtype=torch.int32, device=dev).repeat(8, 1)
    q_pos = torch.full((8,), T - 1, dtype=torch.int32, device=dev)
    before = dict(decode_attention.variant_launches)
    decode_attention(q, k, v, kv_pos, q_pos, *sc)
    after = decode_attention.variant_launches
    assert after[variant] == before[variant] + 1
    assert all(after[x] == before[x] for x in after if x != variant)
    da.reset_counts()
    assert decode_attention.launches == 0
    assert not any(decode_attention.variant_launches.values())


@pytest.mark.parametrize("Hq,Hkv,D", [(32, 32, 64), (32, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kernel_is_deterministic(dev, Hq, Hkv, D, dtype):
    assert da.decode_plan(8, 1024, Hkv, Hq // Hkv, _sms(dev)).splits > 1
    gen = torch.Generator(device=dev).manual_seed(D)
    q = torch.randn((8, Hq, D), generator=gen, device=dev).to(dtype)
    k, v, sc = _cache(gen, dev, 8, 1024, Hkv, D, True)
    kv_pos = torch.full((8, 1024), -1, dtype=torch.int32, device=dev)
    depths = [1000, 513, 0, 17, 256, 777, 64, 1023]
    for n, depth in enumerate(depths):
        kv_pos[n, :depth] = torch.arange(depth, device=dev)
    q_pos = torch.tensor([max(d - 1, 0) for d in depths], dtype=torch.int32,
                         device=dev)
    a = decode_attention(q, k, v, kv_pos, q_pos, *sc)
    b = decode_attention(q, k, v, kv_pos, q_pos, *sc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _chunk_inputs(gen, dev, Sq, T, Hq, Hkv, D, int8, dtype, pos_start):
    """A chunk of Sq queries at pos_start of a T-row slot: the slot's rows
    before pos_start, the row at pos_start parked by a decode step
    (garbage, masked) and a stale row of an earlier occupant further on
    (its position past the chunk's start: masked)."""
    f = lambda *s: torch.randn(s, generator=gen, device=dev)
    q, kn, vn = (f(Sq, h, D).to(dtype) for h in (Hq, Hkv, Hkv))
    ck, cv, sc = _cache(gen, dev, 1, T, Hkv, D, int8)
    ck, cv = ck[0], cv[0]
    sc = tuple(None if s is None else s[0] for s in sc)
    kv_pos = torch.full((T,), -1, dtype=torch.int32, device=dev)
    kv_pos[:pos_start] = torch.arange(pos_start, device=dev)
    kv_pos[pos_start] = pos_start
    kv_pos[T - 2] = pos_start + 7
    return q, kn, vn, ck, cv, kv_pos, sc


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 32, 64), (32, 2, 128),
                                      (64, 8, 112), (8, 1, 256)])
@pytest.mark.parametrize("pos_start", [0, 37, 900])
@pytest.mark.parametrize("Sq", [1, 16, 32, 96])
def test_prefill_tensor_core_kernel_vs_plain(dev, Sq, pos_start, Hq, Hkv, D,
                                             int8):
    """bf16 chunks at stablelm-1.6b's and chatglm3-6b's head layouts in a
    1024-row slot, length < Sq (Sq = 1: the one token), against the plain
    version; the chunk's codes and scales equal ``quantize_kv_ref``."""
    T, length = 1024, max(1, Sq - Sq // 4)
    gen = torch.Generator(device=dev).manual_seed(Sq + pos_start + D)
    q, kn, vn, ck, cv, kv_pos, sc = _chunk_inputs(
        gen, dev, Sq, T, Hq, Hkv, D, int8, torch.bfloat16, pos_start)
    before = dict(prefill_attention.variant_launches)
    got, gaux = prefill_attention(q, kn, vn, ck, cv, kv_pos, pos_start,
                                  length, *sc)
    torch.cuda.synchronize()
    assert prefill_attention.variant_launches[pa.TENSOR_CORE] == \
        before[pa.TENSOR_CORE] + 1
    want = prefill_attention_ref(q, kn, vn, ck, cv, kv_pos, pos_start,
                                 length, *sc)
    assert got.dtype == torch.bfloat16 and got.shape == (Sq, Hq, D)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 2e-2)
    if int8:
        wk_, wv_ = quantize_kv_ref(kn, 4), quantize_kv_ref(vn, 4)
        for a, b in zip(gaux, (wk_[0], wv_[0], wk_[1], wk_[2], wv_[1],
                               wv_[2])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,variant", [
    (torch.bfloat16, pa.TENSOR_CORE), (torch.float32, pa.CUDA_CORE)])
def test_prefill_launches_the_variant_of_its_dtype(dev, dtype, variant):
    gen = torch.Generator(device=dev).manual_seed(13)
    q, kn, vn, ck, cv, kv_pos, sc = _chunk_inputs(
        gen, dev, 96, 256, 8, 2, 64, True, dtype, 100)
    before = dict(prefill_attention.variant_launches)
    got, _ = prefill_attention(q, kn, vn, ck, cv, kv_pos, 100, 96, *sc)
    torch.cuda.synchronize()
    after = prefill_attention.variant_launches
    assert after[variant] == before[variant] + 1
    assert all(after[x] == before[x] for x in after if x != variant)
    _close(got, prefill_attention_ref(q, kn, vn, ck, cv, kv_pos, 100, 96,
                                      *sc),
           1e-4 if dtype == torch.float32 else 2e-2)
    pa.reset_counts()
    assert prefill_attention.launches == 0
    assert not any(prefill_attention.variant_launches.values())


@pytest.mark.parametrize("Hq,Hkv,D", [(32, 32, 64), (32, 2, 128)])
def test_prefill_tensor_core_kernel_is_deterministic(dev, Hq, Hkv, D):
    assert pa.prefill_plan(96, 1024, Hkv, Hq // Hkv, 384,
                           _sms(dev)).cache_splits > 1
    gen = torch.Generator(device=dev).manual_seed(14)
    q, kn, vn, ck, cv, kv_pos, sc = _chunk_inputs(
        gen, dev, 96, 1024, Hq, Hkv, D, True, torch.bfloat16, 384)
    a, _ = prefill_attention(q, kn, vn, ck, cv, kv_pos, 384, 96, *sc)
    b, _ = prefill_attention(q, kn, vn, ck, cv, kv_pos, 384, 96, *sc)
    torch.cuda.synchronize()
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


# ------------------------------------------------------------------ WKV ---
def _wkv_inputs(gen, dev, BH, T, K, V, dtype, with_s0, decay_scale=2.0):
    f = lambda *s: torch.randn(s, generator=gen, device=dev)
    r, k, v = f(BH, T, K).to(dtype), f(BH, T, K).to(dtype), \
        f(BH, T, V).to(dtype)
    w = torch.exp(-torch.exp(f(BH, T, K) * decay_scale - 1))
    u = f(BH, K) * 0.5
    s0 = f(BH, K, V) if with_s0 else None
    return r, k, v, w, u, s0


@pytest.mark.parametrize("BH,T,K,V", [(8, 32, 32, 32), (3, 48, 16, 24),
                                      (320, 256, 64, 64), (40, 256, 64, 64),
                                      (320, 240, 64, 64), (8, 16, 32, 32),
                                      (4, 64, 128, 128), (3, 32, 20, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_kernel_vs_plain(dev, BH, T, K, V, dtype, with_s0):
    gen = torch.Generator(device=dev).manual_seed(BH + T + K + V)
    args = _wkv_inputs(gen, dev, BH, T, K, V, dtype, with_s0)
    before = wk.wkv_chunked.launches
    y, S = wk.wkv_chunked(*args[:5], s0=args[5])
    torch.cuda.synchronize()
    assert wk.wkv_chunked.launches == before + 1
    y_ref, S_ref = wk.wkv_chunked_ref(*args[:5], s0=args[5])
    assert y.dtype == dtype and y.shape == (BH, T, V)
    assert S.dtype == torch.float32 and S.shape == (BH, K, V)
    _close(y, y_ref, 1e-4 if dtype == torch.float32 else 2e-2)
    _close(S, S_ref, 1e-4)


@pytest.mark.parametrize("K", [32, 64])
def test_wkv_kernel_extreme_decay_stays_finite(dev, K):
    gen = torch.Generator(device=dev).manual_seed(7)
    r, k, v, _, u, s0 = _wkv_inputs(gen, dev, 4, 32, K, K, torch.float32,
                                    True)
    w = torch.zeros_like(r)                  # decay underflowed to 0
    y, S = wk.wkv_chunked(r, k, v, w, u, s0=s0)
    y_ref, S_ref = wk.wkv_chunked_ref(r, k, v, w, u, s0=s0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    _close(y, y_ref, 1e-4)
    _close(S, S_ref, 1e-4)


@pytest.mark.parametrize("K", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_plan_shared_memory_is_the_kernels(dev, K, dtype):
    from repro_torch.kernels import build
    p = wk.wkv_plan(320, K, K, build.sm_count(dev.index or 0),
                    torch.empty((), dtype=dtype).element_size())
    assert p.smem == build.library().wkv_chunked_smem(
        K, int(dtype == torch.bfloat16))


# --------------------------------------------------------- WKV backward ---
WKV_SHAPES = [(8, 32, 32, 32), (3, 48, 16, 24), (320, 256, 64, 64),
              (40, 256, 64, 64), (320, 240, 64, 64), (8, 16, 32, 32),
              (4, 64, 128, 128), (3, 32, 20, 20), (320, 128, 64, 64)]


def _rel_close(got, want, rel):
    """Within ``rel`` x the largest magnitude of ``want``."""
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * float(want.float().abs().max()), (err, rel)


def _wkv_bwd_args(gen, dev, BH, T, K, V, dtype, with_s0):
    r, k, v, w, u, s0 = _wkv_inputs(gen, dev, BH, T, K, V, dtype, with_s0)
    y_bar = torch.randn((BH, T, V), generator=gen, device=dev).to(dtype)
    S_bar = torch.randn((BH, K, V), generator=gen, device=dev)
    return r, k, v, w, u, s0, y_bar, S_bar


def _check_wkv_grads(got, want, w, dtype):
    """dr, dk, dv in the input type (rounded there on both sides: 2e-2 of
    their scale in bf16, 1e-4 in fp32); dw ⊙ w, du and ds0 fp32, 1e-4."""
    xrel = 1e-4 if dtype == torch.float32 else 2e-2
    for i, name in enumerate(("dr", "dk", "dv")):
        assert got[i].dtype == dtype and got[i].shape == want[i].shape, name
        _rel_close(got[i], want[i], xrel)
    assert got[3].dtype == got[4].dtype == torch.float32
    _rel_close(got[3] * w, want[3] * w, 1e-4)
    _rel_close(got[4], want[4], 1e-4)
    assert (got[5] is None) == (want[5] is None)
    if want[5] is not None:
        _rel_close(got[5], want[5], 1e-4)
    assert all(bool(torch.isfinite(g).all()) for g in got if g is not None)


@pytest.mark.parametrize("BH,T,K,V", WKV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_bwd_kernel_vs_plain(dev, BH, T, K, V, dtype, with_s0):
    gen = torch.Generator(device=dev).manual_seed(BH + T + K + V + 1)
    args = _wkv_bwd_args(gen, dev, BH, T, K, V, dtype, with_s0)
    before = wk.wkv_chunked_bwd.launches
    got = wk.wkv_chunked_bwd(*args)
    torch.cuda.synchronize()
    assert wk.wkv_chunked_bwd.launches == before + 1
    _check_wkv_grads(got, wk.wkv_chunked_bwd_ref(*args), args[3], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_bwd_kernel_is_deterministic(dev, dtype):
    """Two launches on the same inputs give the same bytes (no atomics:
    the slabs' partials are added in slab order)."""
    gen = torch.Generator(device=dev).manual_seed(21)
    args = _wkv_bwd_args(gen, dev, 320, 128, 64, 64, dtype, True)
    a = wk.wkv_chunked_bwd(*args)
    b = wk.wkv_chunked_bwd(*args)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("K", [32, 64])
@pytest.mark.parametrize("w_kind", ["zero", "denormal", "mixed"])
def test_wkv_bwd_kernel_extreme_decay_stays_finite(dev, K, w_kind):
    """Decays that underflowed: finite gradients, dw = 0 where the
    forward's log clamps (w <= 1e-30), and the plain version's numbers."""
    gen = torch.Generator(device=dev).manual_seed(22)
    r, k, v, w, u, s0, y_bar, S_bar = _wkv_bwd_args(
        gen, dev, 4, 32, K, K, torch.float32, True)
    if w_kind == "zero":
        w = torch.zeros_like(w)
    elif w_kind == "denormal":
        w = torch.full_like(w, 1e-45)
    else:
        w = torch.where(torch.rand(w.shape, generator=gen, device=dev) < 0.4,
                        0.0, w)
    args = (r, k, v, w, u, s0, y_bar, S_bar)
    got = wk.wkv_chunked_bwd(*args)
    torch.cuda.synchronize()
    assert bool((got[3][w <= 1e-30] == 0).all())
    _check_wkv_grads(got, wk.wkv_chunked_bwd_ref(*args), w, torch.float32)


def test_wkv_function_on_the_card_launches_both_kernels(dev, monkeypatch):
    """A CUDA tensor with requires_grad through ``wkv_chunked``
    (``WkvChunked``): one forward and one backward launch, the plain
    versions never called, the gradients the plain backward's."""
    gen = torch.Generator(device=dev).manual_seed(23)
    r, k, v, w, u, s0, y_bar, S_bar = _wkv_bwd_args(
        gen, dev, 80, 64, 64, 64, torch.bfloat16, True)
    want = wk.wkv_chunked_bwd_ref(r, k, v, w, u, s0, y_bar, S_bar)

    def boom(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")
    for name in ("wkv_chunked_ref", "wkv_chunked_bwd_ref", "wkv_step_ref"):
        monkeypatch.setattr(wk, name, boom)
    xs = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    before = (wk.wkv_chunked.launches, wk.wkv_chunked_bwd.launches)
    y, S = wk.wkv_chunked(*xs[:5], s0=xs[5])
    ((y.float() * y_bar.float()).sum() + (S * S_bar).sum()).backward()
    torch.cuda.synchronize()
    assert (wk.wkv_chunked.launches, wk.wkv_chunked_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    _check_wkv_grads([x.grad for x in xs], want, w, torch.bfloat16)
    with torch.no_grad():
        y, _ = wk.wkv_chunked(*xs[:5], s0=xs[5])
    assert y.grad_fn is None and wk.wkv_chunked_bwd.launches == before[1] + 1


def test_wkv_bwd_wrapper_rejects_bad_operands(dev):
    gen = torch.Generator(device=dev).manual_seed(24)
    r, k, v, w, u, s0, y_bar, S_bar = _wkv_bwd_args(
        gen, dev, 4, 32, 32, 32, torch.float32, True)
    wk.wkv_chunked_bwd(r, k, v, w, u, None, y_bar, None)
    torch.cuda.synchronize()
    bad = [
        (TypeError, lambda: wk.wkv_chunked_bwd(r, k, v, w.bfloat16(), u, s0,
                                               y_bar, S_bar)),
        (TypeError, lambda: wk.wkv_chunked_bwd(r, k.bfloat16(), v, w, u, s0,
                                               y_bar, S_bar)),
        (ValueError, lambda: wk.wkv_chunked_bwd(r, k, v, w, u, s0,
                                                y_bar.bfloat16(), S_bar)),
        (ValueError, lambda: wk.wkv_chunked_bwd(r, k, v, w, u, s0,
                                                y_bar[:, :16], S_bar)),
        (ValueError, lambda: wk.wkv_chunked_bwd(r, k, v, w, u, s0, y_bar,
                                                S_bar[:, :16])),
        (ValueError, lambda: wk.wkv_chunked_bwd(r, k, v, w, u, s0, y_bar,
                                                S_bar.double())),
        (ValueError, lambda: wk.wkv_chunked_bwd(
            r[:, :24], k[:, :24], v[:, :24], w[:, :24], u, s0,
            y_bar[:, :24], S_bar)),
        (ValueError, lambda: wk.wkv_chunked_bwd(r, k, v, w, u, s0[:, :16],
                                                y_bar, S_bar)),
        (ValueError, lambda: wk.wkv_chunked_bwd(r, k, v, w, u, s0,
                                                y_bar.cpu(), S_bar)),
    ]
    for exc, call in bad:
        with pytest.raises(exc):
            call()


def test_rwkv6_loss_grads_on_the_card_match_the_cpu(dev):
    """Reduced rwkv6 in fp32 from the same seeded weights: ``loss_fn`` at
    S = 32 (the chunked branch) with remat, the loss within 1e-5 relative
    of the CPU's and every gradient within 1e-4 x the largest; each layer
    launches the forward kernel twice (remat recomputes it) and the
    backward once."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.models import rwkv6
    from repro_torch.tree import tree_leaves, tree_map, tree_to
    cfg = get_arch("rwkv6-3b").reduced()
    base = rwkv6.init(cfg, seed=0, device="cpu")
    batch = synthetic_lm_batch(DataConfig(cfg.vocab, 32, 4), 0, device="cpu")
    out = {}
    for d in ("cpu", "cuda"):
        p = tree_map(lambda t: t.detach().requires_grad_(True),
                     tree_to(base, d))
        before = (wk.wkv_chunked.launches, wk.wkv_chunked_bwd.launches)
        loss, _ = rwkv6.loss_fn(p, cfg, {k: t.to(d) for k, t in
                                         batch.items()}, remat=True)
        loss.backward()
        if d == "cuda":
            torch.cuda.synchronize()
            assert (wk.wkv_chunked.launches - before[0],
                    wk.wkv_chunked_bwd.launches - before[1]) == \
                (2 * cfg.n_layers, cfg.n_layers)
        out[d] = (float(loss.detach()),
                  [t.grad.cpu() for t in tree_leaves(p)])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    top = max(float(g.abs().max()) for g in out["cpu"][1])
    for g, c in zip(out["cuda"][1], out["cpu"][1]):
        assert float((g - c).abs().max()) <= 1e-4 * top


def _no_plain(monkeypatch):
    """Make every plain version raise, so a wrapper that took one on a
    CUDA tensor fails the test."""
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    for mod, name in ((wk, "wkv_chunked_ref"), (aq, "act_split_quantize_ref"),
                      (aq, "act_split_quantize_static_ref")):
        monkeypatch.setattr(mod, name, boom)


def test_new_wrappers_reject_bad_operands_and_never_take_plain(
        dev, monkeypatch):
    _no_plain(monkeypatch)
    gen = torch.Generator(device=dev).manual_seed(8)
    r, k, v, w, u, s0 = _wkv_inputs(gen, dev, 4, 32, 32, 32, torch.float32,
                                    True)
    wk.wkv_chunked(r, k, v, w, u, s0=s0)
    aq.act_split_quantize(r[0], bits=4, n_chunks=4)
    aq.act_split_quantize_static(r[0], u[0, :3], u[1, :3], bits=4)
    torch.cuda.synchronize()
    bad = [
        (TypeError, lambda: wk.wkv_chunked(r, k, v, w.bfloat16(), u, s0=s0)),
        (TypeError, lambda: wk.wkv_chunked(r, k.bfloat16(), v, w, u)),
        (ValueError, lambda: wk.wkv_chunked(r[:, :24], k[:, :24], v[:, :24],
                                            w[:, :24], u)),
        (TypeError, lambda: wk.wkv_chunked(r, k, v, w, u, chunk=16)),
        (ValueError, lambda: wk.wkv_chunked(r, k, v, w, u, s0=s0[:, :16])),
        (ValueError, lambda: wk.wkv_chunked(r, k, v, w, u.cpu())),
        (TypeError, lambda: aq.act_split_quantize(r[0].half(), n_chunks=4)),
        (ValueError, lambda: aq.act_split_quantize(r[0], n_chunks=5)),
        (ValueError, lambda: aq.act_split_quantize(r[0], bits=9,
                                                   n_chunks=4)),
        (TypeError, lambda: aq.act_split_quantize_static(
            r[0], u[0, :3].double(), u[1, :3])),
        (ValueError, lambda: aq.act_split_quantize_static(
            r[0], u[0, :3], u[1, :2])),
    ]
    for exc, call in bad:
        with pytest.raises(exc):
            call()


# ------------------------------------------------------------ act-quant ---
def fma_tie_inputs(seed: int = 1, n: int = 1 << 22):
    """Values x with one (S, Z) for which rint(S·x + Z) differs between a
    separately rounded multiply and add and a fused multiply-add: the
    static act-quant code must take the former. Returns (x, S, Z) as
    numpy float32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    S = np.float32(rng.uniform(0.5, 40))
    Z = np.float32(rng.uniform(-3, 3))
    sep = np.rint(S * x + Z)
    fused = np.rint((np.float64(S) * x.astype(np.float64) +
                     np.float64(Z)).astype(np.float32))
    return x[sep != fused], S, Z


def static_qparams(x, n_chunks, bits, gen):
    """Per-chunk (S, Z) for x (R, N) over ``array_split`` chunks, drawn so
    that S·x + Z covers the code range and most codes fall inside
    [qmin, qmax]: S = (2^b − 1) / (chunk max − min) · U(0.5, 2), and Z
    centres the chunk's range on the codes with a fractional offset
    U(−0.5, 0.5). The exact comparisons then check the rounding of
    S·x + Z, not the clip."""
    xf = x.float()
    b = activation_chunk_bounds(x.shape[1], n_chunks)
    lo = torch.stack([xf[:, s:e].min() for s, e in zip(b[:-1], b[1:])])
    hi = torch.stack([xf[:, s:e].max() for s, e in zip(b[:-1], b[1:])])
    u = torch.rand((2, n_chunks), generator=gen, device=x.device)
    scale = (2 ** bits - 1) / (hi - lo) * (0.5 + 1.5 * u[0])
    zero = -0.5 - scale * (hi + lo) / 2 + (u[1] - 0.5)
    return scale, zero


def inside_share(q, bits) -> float:
    """The share of codes strictly inside (qmin, qmax)."""
    return float(((q > -2 ** (bits - 1)) & (q < 2 ** (bits - 1) - 1))
                 .float().mean())


def _act_input(gen, dev, R, N, dtype):
    x = torch.randn((R, N), generator=gen, device=dev) * 2
    x[0, 0] = 50.0                               # outlier in chunk 0
    x[1] = 1.5                                   # constant row
    x[2] = 0.0                                   # all-zero row
    return x.to(dtype)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("R,N,n_chunks", [(5, 128, 4), (256, 96, 3),
                                          (2048, 2560, 4), (2048, 8960, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quant_dynamic_kernel_exact(dev, bits, R, N, n_chunks, dtype):
    gen = torch.Generator(device=dev).manual_seed(R + N + bits)
    x = _act_input(gen, dev, R, N, dtype)
    before = aq.act_split_quantize.launches
    got = aq.act_split_quantize(x, bits=bits, n_chunks=n_chunks)
    torch.cuda.synchronize()
    assert aq.act_split_quantize.launches == before + 1
    want = aq.act_split_quantize_ref(x, bits=bits, n_chunks=n_chunks)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("bits", range(2, 9))
@pytest.mark.parametrize("R,N,n_chunks,offset", [
    (7, 2562, 3, 0), (7, 2562, 3, 1), (33, 8960, 4, 3), (5, 96, 3, 1),
    (3, 40000, 2, 1), (9, 16392, 1, 0), (1, 5, 5, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quant_dynamic_kernel_odd_shapes_exact(dev, bits, R, N, n_chunks,
                                                  offset, dtype):
    """Rows that fill no whole block, chunks whose width is no multiple
    of a 16-byte vector (2562 in 3 chunks: each chunk starts elsewhere
    against a 16-byte boundary), views ``offset`` elements into their
    storage, chunks wider than eight warps hold (rounds: 40000 in 2, and
    16392 in fp32) and chunks narrower than a vector; with a constant
    chunk and an all-zero chunk in the last row."""
    gen = torch.Generator(device=dev).manual_seed(R * N + bits + offset)
    x = torch.randn((R, N), generator=gen, device=dev) * 2
    x[0, 0] = 50.0
    cw = N // n_chunks
    x[-1, :cw] = -2.25                            # a constant chunk
    if n_chunks > 1:
        x[-1, -cw:] = 0.0                         # an all-zero chunk
    big = torch.zeros(R * N + offset, dtype=dtype, device=dev)
    big[offset:] = x.reshape(-1).to(dtype)
    x = big[offset:].view(R, N)
    assert x.is_contiguous() and (offset == 0) == (x.data_ptr() % 16 == 0)
    before = aq.act_split_quantize.launches
    got = aq.act_split_quantize(x, bits=bits, n_chunks=n_chunks)
    torch.cuda.synchronize()
    assert aq.act_split_quantize.launches == before + 1
    want = aq.act_split_quantize_ref(x, bits=bits, n_chunks=n_chunks)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float(got[2][-1, 0]) == 0.0            # the constant chunk's zero


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("R,N,n_chunks,offset", [
    (5, 97, 3, 0), (256, 128, 4, 0), (2048, 2560, 3, 0), (2048, 8960, 3, 0),
    (5, 97, 3, 1), (64, 8, 8, 0), (64, 8, 8, 3), (64, 2560, 3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quant_static_kernel_exact(dev, bits, R, N, n_chunks, offset,
                                       dtype):
    """``offset``: x is a view that starts that many elements into its
    storage (1: ``big[1:]``-like, misaligned rows at odd N; at N % 8 == 0
    every row starts short of a 16-byte boundary, so the kernel takes a
    scalar head, vectors, and a scalar tail)."""
    gen = torch.Generator(device=dev).manual_seed(R + N + bits + 1)
    x = _act_input(gen, dev, R, N, dtype)
    if offset:
        big = torch.zeros(R * N + offset, dtype=dtype, device=dev)
        big[offset:] = x.reshape(-1)
        x = big[offset:].view(R, N)
        assert x.data_ptr() % 16
        assert x.is_contiguous()
    scale, zero = static_qparams(x, n_chunks, bits, gen)
    before = aq.act_split_quantize_static.launches
    got = aq.act_split_quantize_static(x, scale, zero, bits=bits)
    torch.cuda.synchronize()
    assert aq.act_split_quantize_static.launches == before + 1
    assert inside_share(got, bits) > 0.5
    assert torch.equal(got, aq.act_split_quantize_static_ref(x, scale, zero,
                                                             bits=bits))


def test_act_quant_static_kernel_does_not_fuse_multiply_add(dev):
    xs, S, Z = fma_tie_inputs()
    assert xs.size > 0
    x = torch.from_numpy(np.tile(xs, (4, 1))).to(dev)
    got = aq.act_split_quantize_static(
        x, torch.tensor([S], device=dev), torch.tensor([Z], device=dev))
    want = np.clip(np.rint(S * xs + Z), -128, 127).astype(np.int8)
    assert np.array_equal(got.cpu().numpy(), np.tile(want, (4, 1)))


def test_wave_server_card_matches_cpu(dev):
    """Reduced rwkv6 in fp32 with INT4 SplitQuant weights: the wave server
    on the card gives the CPU server's greedy tokens, over a wave whose
    padded length is a multiple of 16 (the WKV kernel) and one whose
    length is not (the step recurrence)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.apply import tree_to
    from repro_torch.launch.serve import build_params
    from repro_torch.runtime.serve_loop import Request, Server, ServeConfig
    cfg = get_arch("rwkv6-3b").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", device="cpu")
    rng = np.random.default_rng(2)
    lens = [32, 20, 7, 16, 37, 5, 12, 30]
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in lens]
    outs = {}
    for d, p in (("cpu", params), ("cuda", tree_to(params, dev))):
        srv = Server(cfg, p, ServeConfig(max_batch=4, max_new_tokens=8),
                     device=d)
        before = wk.wkv_chunked.launches
        fin = srv.serve([Request(i, pr) for i, pr in enumerate(prompts)])
        outs[d] = [r.out for r in fin]
        if d == "cuda":
            assert wk.wkv_chunked.launches - before == cfg.n_layers
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "chatglm3-6b"])
def test_dense_wave_server_card_matches_cpu(dev, arch):
    """Reduced dense models in fp32 with INT4 SplitQuant weights: the
    wave server on the card gives the CPU server's greedy tokens over
    two left-padded waves of mixed lengths (one request with a budget of
    1), through the matmul kernel and no attention kernel or K/V
    write."""
    from repro_torch.configs import get_arch
    from repro_torch.core.apply import tree_to
    from repro_torch.launch.serve import build_params
    from repro_torch.runtime.serve_loop import Request, Server, ServeConfig
    cfg = get_arch(arch).reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", device="cpu")
    rng = np.random.default_rng(4)
    lens = [30, 3, 17, 9, 1, 24, 12, 5]
    budgets = [None, 1, None, None, None, None, 1, None]
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in lens]
    outs = {}
    for d, p in (("cpu", params), ("cuda", tree_to(params, dev))):
        srv = Server(cfg, p, ServeConfig(max_batch=4, max_new_tokens=8,
                                         max_len=48), device=d)
        before = (sqm.splitquant_matmul.launches,
                  da.decode_attention.launches, pa.prefill_attention.launches,
                  sum(pa.write_kv_rows.mode_launches.values()))
        fin = srv.serve([Request(i, pr, b) for i, (pr, b) in
                         enumerate(zip(prompts, budgets))])
        outs[d] = [r.out for r in fin]
        if d == "cuda":
            after = (sqm.splitquant_matmul.launches,
                     da.decode_attention.launches,
                     pa.prefill_attention.launches,
                     sum(pa.write_kv_rows.mode_launches.values()))
            assert after[0] > before[0] and after[1:] == before[1:]
    assert outs["cuda"] == outs["cpu"]
    assert [len(o) for o in outs["cpu"]] == [8, 1, 8, 8, 8, 8, 1, 8]


# ------------------------------------- static and verify attention modes ---
def _static_scales(x, C=4):
    """Per-(head, chunk) static (S, Z) of x (..., Hkv, D) from its own
    range, as ``calib.kv_static_scales`` derives them."""
    H, D = x.shape[-2:]
    xc = x.float().reshape(-1, H, C, D // C)
    lo, hi = xc.amin(dim=(0, 3)), xc.amax(dim=(0, 3))
    scale = 255.0 / (hi - lo)
    return scale, -128.0 - scale * lo


def _static_cache(k, v):
    """Static codes of k and v and their four (Hkv, C) constants."""
    ks, kz = _static_scales(k)
    vs, vz = _static_scales(v)
    return (pa.quantize_kv_static_ref(k, ks, kz),
            pa.quantize_kv_static_ref(v, vs, vz), (ks, kz, vs, vz))


@pytest.mark.parametrize("layout", ["(Hkv, C)", "(1, 1, Hkv, C)"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 32, 64), (32, 2, 128), (4, 4, 32),
                                      (64, 8, 112), (8, 1, 256)])
@pytest.mark.parametrize("T", [100, 1024, 4096])
def test_decode_static_kernel_vs_plain(dev, T, Hq, Hkv, D, dtype, layout):
    """Static per-layer scales through both the row path (one head a
    block) and the head-group path, at split and unsplit plans."""
    gen = torch.Generator(device=dev).manual_seed(T + Hq + D + 3)
    q, k, v, kv_pos, q_pos, _ = _decode_inputs(gen, dev, 6, T, Hq, Hkv, D,
                                               False, dtype)
    qk, qv, sc = _static_cache(k, v)
    if layout != "(Hkv, C)":
        sc = tuple(s[None, None] for s in sc)
    before = dict(decode_attention.mode_launches)
    got = decode_attention(q, qk, qv, kv_pos, q_pos, *sc)
    torch.cuda.synchronize()
    assert decode_attention.mode_launches["static"] == before["static"] + 1
    assert decode_attention.mode_launches["dynamic"] == before["dynamic"]
    want = decode_attention_ref(q, qk, qv, kv_pos, q_pos, *sc)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)
    assert torch.all(got[2] == 0)                     # empty slot


@pytest.mark.parametrize("mode", ["static", "verify_dynamic",
                                  "verify_static", "verify_fp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 32, 64), (32, 2, 128),
                                      (64, 8, 112), (8, 1, 256)])
@pytest.mark.parametrize("pos_start,Sq,length", [(37, 96, 90), (0, 4, 4),
                                                 (384, 4, 3), (900, 16, 16)])
def test_prefill_static_and_verify_kernel_vs_plain(dev, mode, dtype, Hq, Hkv,
                                                   D, pos_start, Sq, length):
    """Both prefill kernels in the static and verify modes; the chunk's
    codes (and per-entry scales) equal the plain quantizers'."""
    T = 1024
    gen = torch.Generator(device=dev).manual_seed(pos_start + Sq + D + 5)
    q, kn, vn, ck, cv, kv_pos, sc = _chunk_inputs(
        gen, dev, Sq, T, Hq, Hkv, D, mode == "verify_dynamic", dtype,
        pos_start)
    if mode in ("static", "verify_static"):
        ck, cv, sc = _static_cache(ck, cv)
    verify = mode.startswith("verify")
    before = dict(prefill_attention.mode_launches)
    got, gaux = prefill_attention(q, kn, vn, ck, cv, kv_pos, pos_start,
                                  length, *sc, verify=verify)
    torch.cuda.synchronize()
    assert prefill_attention.mode_launches[mode] == before[mode] + 1
    want = prefill_attention_ref(q, kn, vn, ck, cv, kv_pos, pos_start,
                                 length, *sc, verify=verify)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)
    if mode in ("static", "verify_static"):
        waux = (pa.quantize_kv_static_ref(kn, sc[0], sc[1]),
                pa.quantize_kv_static_ref(vn, sc[2], sc[3]))
    elif mode == "verify_dynamic":
        wk_, wv_ = quantize_kv_ref(kn, 4), quantize_kv_ref(vn, 4)
        waux = (wk_[0], wv_[0], wk_[1], wk_[2], wv_[1], wv_[2])
    else:
        waux = ()
    assert len(gaux) == len(waux)
    for a, b in zip(gaux, waux):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(96, 32, 64), (8, 32, 64), (96, 2, 128),
                                   (8, 2, 128), (3, 5, 32)])
def test_quantize_kv_static_kernel_bit_identical(dev, dtype, shape):
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=gen, device=dev) * 2).to(dtype)
    scale, zero = _static_scales(x)
    u = torch.rand((2,) + scale.shape, generator=gen, device=dev)
    scale = scale * (0.5 + 1.5 * u[0])           # some codes clip
    zero = zero + u[1] - 0.5                     # fractional
    before = pa.quantize_kv_static.launches
    got = pa.quantize_kv_static(x, scale, zero)
    torch.cuda.synchronize()
    assert pa.quantize_kv_static.launches == before + 1
    assert inside_share(got, 8) > 0.5
    assert torch.equal(got, pa.quantize_kv_static_ref(x, scale, zero))


def test_quantize_kv_static_kernel_does_not_fuse_multiply_add(dev):
    xs, S, Z = fma_tie_inputs()
    x = torch.from_numpy(np.resize(xs, (-(-xs.size // 64), 2, 32))).to(dev)
    sc = torch.full((2, 4), float(S), device=dev)
    zc = torch.full((2, 4), float(Z), device=dev)
    got = pa.quantize_kv_static(x, sc, zc).cpu().numpy()
    xn = x.cpu().numpy()
    want = np.clip(np.rint(S * xn + Z), -128, 127).astype(np.int8)
    assert np.array_equal(got, want)


def test_new_mode_wrappers_reject_bad_operands_and_never_take_plain(
        dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    for mod, name in ((da, "decode_attention_ref"),
                      (pa, "prefill_attention_ref"),
                      (pa, "quantize_kv_static_ref"),
                      (pa, "quantize_kv_ref"), (pa, "window_kv")):
        monkeypatch.setattr(mod, name, boom)
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v, kv_pos, q_pos, _ = _decode_inputs(gen, dev, 4, 64, 4, 2, 32,
                                               False, torch.float32)
    ks, kz = _static_scales(k)
    qk = torch.zeros(k.shape, dtype=torch.int8, device=dev)
    sc = (ks, kz, ks, kz)
    decode_attention(q, qk, qk, kv_pos, q_pos, *sc)
    pa.quantize_kv_static(k[0], ks, kz)
    Sq = 4
    qq, kn = q[0, :Sq].contiguous(), k[0, :Sq].contiguous()
    qq = torch.randn((Sq, 4, 32), device=dev)
    for verify in (False, True):
        prefill_attention(qq, kn, kn, qk[0], qk[0], kv_pos[0], 10, Sq, *sc,
                          verify=verify)
    torch.cuda.synchronize()
    bad = [
        (ValueError, lambda: decode_attention(q, qk, qk, kv_pos, q_pos,
                                              ks[:, :2], kz, ks, kz)),
        (ValueError, lambda: decode_attention(q, qk, qk, kv_pos, q_pos,
                                              ks[None], kz, ks, kz)),
        (ValueError, lambda: decode_attention(q, qk, qk, kv_pos, q_pos,
                                              ks.cpu(), kz, ks, kz)),
        (ValueError, lambda: decode_attention(q, qk, qk, kv_pos, q_pos,
                                              ks.double(), kz, ks, kz)),
        (ValueError, lambda: pa.quantize_kv_static(k[0], ks[:1], kz[:1])),
        (ValueError, lambda: pa.quantize_kv_static(k[0], ks.cpu(),
                                                   kz.cpu())),
        (TypeError, lambda: pa.quantize_kv_static(k[0].half(), ks, kz)),
        (ValueError, lambda: prefill_attention(
            qq, kn, kn, qk[0], qk[0], kv_pos[0], 10, Sq, ks[:, :2], kz, ks,
            kz, verify=True)),
        (ValueError, lambda: prefill_attention(
            qq, kn, kn, qk[0], qk[0], kv_pos[0], 10, Sq, ks.cpu(), kz, ks,
            kz)),
    ]
    for exc, call in bad:
        with pytest.raises(exc):
            call()


def test_spec_engine_card_matches_cpu(dev):
    """Reduced stablelm in fp32, INT4 target, INT2 draft, spec_k 3, over
    int8 dynamic and static caches: the card's speculative tokens equal
    its greedy tokens and the CPU's speculative tokens."""
    from repro_torch.calib import collect_kv_stats, kv_static_scales
    from repro_torch.configs import get_arch
    from repro_torch.core.apply import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg = get_arch("stablelm-1.6b").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", device="cpu")
    draft, _ = build_params(cfg, bits=2, method="splitquant", device="cpu")
    rng = np.random.default_rng(4)
    scales = kv_static_scales(collect_kv_stats(
        cfg, params, [rng.integers(0, cfg.vocab, size=(2, 64))]))
    prompts = seeded_prompts(cfg.vocab, 6, 3, 60, seed=1)
    for kv_scales in (None, scales):
        outs = {}
        for d, spec_k in (("cpu", 3), ("cuda", 3), ("cuda", 0)):
            p, dr = (params, draft) if d == "cpu" else \
                (tree_to(params, dev), tree_to(draft, dev))
            eng = Engine(cfg, p, EngineConfig(
                n_slots=3, max_len=96, max_new_tokens=8, kv_mode="int8",
                prefill_chunk=32, spec_k=spec_k), device=d,
                kv_scales=kv_scales, draft_params=dr if spec_k else None)
            for pr in prompts:
                eng.submit(pr)
            outs[(d, spec_k)] = [r.out for r in eng.drain()]
        assert outs[("cuda", 3)] == outs[("cuda", 0)] == outs[("cpu", 3)]


# ----------------------------------------------------------- K/V write ---
def _write_inputs(gen, dev, mode, dtype, R, N, T, Hkv, D, C=4):
    """K/V rows (R, Hkv, D) with a constant chunk and a zero chunk, and a
    layer's destination holding stale bytes everywhere (rows, kv_pos and
    per-entry scales), so that a test sees every byte the write touches
    and every byte it must leave; static scales (Hkv, C) are drawn from
    the rows so that most codes fall inside the range. Returns (k, v,
    the destination operands, their buffers): each per-slot buffer has
    one guard slot after the N slots of its operand."""
    f = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    k, v = f(R, Hkv, D) * 3, f(R, Hkv, D)
    k[0, 0, :D // 4] = 0.0
    v[R - 1, Hkv - 1, D // 4:D // 2] = -4.0
    k, v = k.to(dtype), v.to(dtype)
    if mode == "fp":
        bufs, sc = [f(N + 1, T, Hkv, D), f(N + 1, T, Hkv, D)], []
    else:
        bufs = [torch.randint(-128, 128, (N + 1, T, Hkv, D), generator=gen,
                              device=dev, dtype=torch.int8)
                for _ in range(2)]
        if mode == "dynamic":
            bufs += [f(N + 1, T, Hkv, C) for _ in range(4)]
            sc = []
        else:
            sc = []
            for x in (k, v):
                s, z = _static_scales(x, C)
                u = torch.rand((2,) + s.shape, generator=gen, device=dev)
                sc += [s * (0.5 + 1.5 * u[0]), z + u[1] - 0.5]
    bufs.insert(2, torch.randint(-1, 3 * T, (N + 1, T), generator=gen,
                                 device=dev, dtype=torch.int32))
    return k, v, [b[:N] for b in bufs] + sc, bufs


def _write_map(where, N, T, dev):
    """(keywords of write_kv_rows, rows): a decode write (one row a slot,
    one position past T), a padded chunk inside the slot, and a padded
    window of the last slot sticking out past T (its rows end the
    allocation)."""
    if where == "decode":
        pos = torch.tensor([5, T - 1, 0, T + 7][:N], dtype=torch.int32,
                           device=dev)
        return dict(positions=pos), N
    if where == "chunk":
        return dict(slot=1, pos_start=8, length=11), 16
    return dict(slot=N - 1, pos_start=T - 5, length=3), 16


@pytest.mark.parametrize("where", ["decode", "chunk", "past_T"])
@pytest.mark.parametrize("D", [32, 64, 112, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", pa.WRITE_MODES)
def test_kv_write_kernel_bit_identical(dev, mode, dtype, D, where):
    """The write kernel against its plain version, C = 4: every byte of
    the destination (codes or fp32 rows, per-entry scales, kv_pos) equal,
    written rows and untouched ones alike; one launch, counted by
    mode."""
    N, T, Hkv = 4, 40, 3
    gen = torch.Generator(device=dev).manual_seed(
        D + 7 * len(where) + pa.WRITE_MODES.index(mode))
    kw, R = _write_map(where, N, T, dev)
    k, v, dst, bufs = _write_inputs(gen, dev, mode, dtype, R, N, T, Hkv, D)
    if mode == "static":
        assert inside_share(pa.quantize_kv_static_ref(k, *dst[3:5]), 8) > 0.5
    want = [b.clone() for b in bufs]
    pa.write_kv_rows_ref(k, v, *[b[:N] for b in want], *dst[len(bufs):],
                         **kw)
    before = dict(pa.write_kv_rows.mode_launches)
    pa.write_kv_rows(k, v, *dst, **kw)
    torch.cuda.synchronize()
    after = dict(pa.write_kv_rows.mode_launches)
    assert after == dict(before, **{mode: before[mode] + 1})
    for got, ref in zip(bufs, want):          # the guard slot included
        assert torch.equal(got, ref)


def _slot_caches(dev, cfg, mode, n_slots, T, seed):
    """A port cache on the CPU with earlier rows written (a prefix in
    each slot, through the plain route) and its copy on the card."""
    from repro_torch.engine import kvcache as tkv
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    sc = None
    if mode == "static":
        g = torch.Generator().manual_seed(seed)
        s = 127.0 / (2.0 + torch.rand((L, Hkv, 4), generator=g))
        sc = {"k_scale": s, "k_zero": torch.rand((L, Hkv, 4), generator=g)
              - 0.5, "v_scale": s * 1.5, "v_zero": -0.25 + 0 * s}
    cpu = tkv.init_slot_cache(cfg, n_slots, T, device="cpu", kv_scales=sc,
                              mode="fp" if mode == "fp" else "int8")
    g = torch.Generator().manual_seed(seed + 1)
    for layer in range(L):
        for slot, depth in enumerate((30, 7, T - 9)[:n_slots]):
            k, v = torch.randn((2, depth, Hkv, D), generator=g)
            tkv.slot_chunk_prefill(cpu, layer,
                                   torch.zeros((depth, cfg.n_heads, D)), k,
                                   v, slot, 0, depth)
    card = dataclasses.replace(cpu, **{
        f.name: getattr(cpu, f.name).to(dev)
        for f in dataclasses.fields(cpu)
        if isinstance(getattr(cpu, f.name), torch.Tensor)})
    return cpu, card


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", pa.WRITE_MODES)
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "chatglm3-6b"])
def test_slot_chunk_prefill_card_equals_plain(dev, arch, mode, dtype,
                                              verify):
    """The engine's chunk and verify steps on the card (one write launch,
    then the attention, which in verify mode reads the window back from
    the slot rows) against the same calls on a CPU copy of the cache (the
    plain route), at full head layouts: the cache state exactly, the
    outputs at the kernels' tolerance. The last slot's step sits near
    max_len with its padded rows past T."""
    from repro_torch.configs import get_arch
    from repro_torch.engine import kvcache as tkv
    cfg = dataclasses.replace(get_arch(arch), n_layers=2)   # full widths
    T = 128
    cpu, card = _slot_caches(dev, cfg, mode, 3, T, 31)
    g = torch.Generator().manual_seed(32)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # (slot, pos_start, Sq, length): mid-slot, and near max_len; a verify
    # window padded past T, and one whose length reaches past T (off the
    # engine's path: its codes are quantized apart from the cache)
    steps = [(0, 30, 16, 16), (2, T - 9, 16, 5)] if not verify else \
        [(0, 30, 4, 4), (2, T - 2, 4, 2), (1, T - 3, 4, 4)]
    before = pa.write_kv_rows.launches
    for i, (slot, pos_start, Sq, length) in enumerate(steps):
        q = torch.randn((Sq, Hq, D), generator=g).to(dtype)
        k, v = (torch.randn((Sq, Hkv, D), generator=g).to(dtype)
                for _ in range(2))
        layer = i % cfg.n_layers
        want = tkv.slot_chunk_prefill(cpu, layer, q, k, v, slot, pos_start,
                                      length, verify=verify)
        got = tkv.slot_chunk_prefill(card, layer, q.to(dev), k.to(dev),
                                     v.to(dev), slot, pos_start, length,
                                     verify=verify)
        torch.cuda.synchronize()
        _close(got.cpu(), want, 1e-4 if dtype == torch.float32 else 2e-2)
        for f in ("k", "v", "kv_pos") + tkv.SCALE_KEYS:
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert pa.write_kv_rows.launches == before + len(steps)


@pytest.mark.parametrize("mode", pa.WRITE_MODES)
def test_cache_writes_are_one_launch_a_layer(dev, mode):
    """A decode write, a chunk and a verify window of one layer: one
    write launch each in the cache's mode, no standalone quantize."""
    from repro_torch.configs import get_arch
    from repro_torch.engine import kvcache as tkv
    cfg = get_arch("chatglm3-6b").reduced()
    L, Hq, Hkv, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sc = None
    if mode == "static":
        sc = {"k_scale": torch.full((L, Hkv, 4), 40.0),
              "k_zero": torch.full((L, Hkv, 4), 0.3),
              "v_scale": torch.full((L, Hkv, 4), 30.0),
              "v_zero": torch.full((L, Hkv, 4), -0.2)}
    cache = tkv.init_slot_cache(cfg, 3, 32, mode="fp" if mode == "fp"
                                else "int8", kv_scales=sc, device=dev)
    counts = lambda: (dict(pa.write_kv_rows.mode_launches),  # noqa: E731
                      pa.quantize_kv.launches,
                      pa.quantize_kv_static.launches)
    before = counts()
    x = torch.randn((3, 1, Hkv, D), device=dev)
    pos = torch.tensor([[3], [0], [9]], dtype=torch.int32, device=dev)
    tkv.slot_layer_write(cache, 1, x, x, pos)
    q, kn = torch.randn((8, Hq, D), device=dev), torch.randn((8, Hkv, D),
                                                             device=dev)
    tkv.slot_chunk_prefill(cache, 0, q, kn, kn, 1, 4, 6)
    tkv.slot_chunk_prefill(cache, 0, q[:4], kn[:4], kn[:4], 2, 30, 2,
                           verify=True)
    torch.cuda.synchronize()
    modes, qd, qs = counts()
    assert modes == dict(before[0], **{mode: before[0][mode] + 3})
    assert (qd, qs) == before[1:]
    # a verify window whose length reaches past T (off the engine's path):
    # the write, then the window's codes quantized apart (K and V)
    tkv.slot_chunk_prefill(cache, 0, q[:4], kn[:4], kn[:4], 2, 30, 4,
                           verify=True)
    torch.cuda.synchronize()
    modes, qd, qs = counts()
    assert modes == dict(before[0], **{mode: before[0][mode] + 4})
    assert (qd - before[1], qs - before[2]) == \
        {"fp": (0, 0), "dynamic": (2, 0), "static": (0, 2)}[mode]


def test_kv_write_rejects_bad_operands_and_never_takes_plain(dev,
                                                             monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    for name in ("write_kv_rows_ref", "quantize_kv_ref",
                 "quantize_kv_static_ref", "cached_window",
                 "prefill_attention_ref", "window_kv"):
        monkeypatch.setattr(pa, name, boom)
    gen = torch.Generator(device=dev).manual_seed(41)
    N, T, Hkv, D = 4, 16, 2, 32
    k, v, dst, _ = _write_inputs(gen, dev, "dynamic", torch.float32, N, N,
                                 T, Hkv, D)
    pos = torch.arange(N, dtype=torch.int32, device=dev)
    pa.write_kv_rows(k, v, *dst, positions=pos)
    pa.write_kv_rows(k, v, *dst, slot=1, pos_start=14, length=1)
    pa.quantize_kv(k, 4)
    pa.quantize_kv_static(k, dst[3][0, 0], dst[4][0, 0])
    q = torch.randn((N, 4, D), device=dev)
    prefill_attention(q, k, v, dst[0][1], dst[1][1], dst[2][1], 2, N,
                      *(s[1] for s in dst[3:]), verify=True,
                      window_cached=True)
    torch.cuda.synchronize()
    bad = [
        (TypeError, lambda: pa.write_kv_rows(k.half(), v.half(), *dst,
                                             positions=pos)),
        (ValueError, lambda: pa.write_kv_rows(k, v.cpu(), *dst,
                                              positions=pos)),
        (ValueError, lambda: pa.write_kv_rows(k, v, *dst,
                                              positions=pos.long())),
        (ValueError, lambda: pa.write_kv_rows(k[:2], v[:2], *dst,
                                              positions=pos[:2])),
        (ValueError, lambda: pa.write_kv_rows(k, v, *dst, slot=N,
                                              pos_start=0, length=1)),
        (ValueError, lambda: pa.write_kv_rows(k, v, *dst[:3], dst[3][:, :1],
                                              *dst[4:], positions=pos)),
        (ValueError, lambda: pa.write_kv_rows(k, v, dst[0], dst[1],
                                              dst[2].long(), *dst[3:],
                                              positions=pos)),
        (ValueError, lambda: pa.write_kv_rows(
            k, v, dst[0].transpose(0, 1).contiguous().transpose(0, 1),
            dst[1], *dst[2:], positions=pos)),
        (ValueError, lambda: prefill_attention(
            q, k, v, dst[0][1], dst[1][1], dst[2][1], T - 2, N,
            *(s[1] for s in dst[3:]), verify=True, window_cached=True)),
    ]
    for exc, call in bad:
        with pytest.raises(exc):
            call()


# ------------------------------------------------------ bf16 slot cache ---
def _bf16(gen, dev, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


#: the 16-bit fp caches: bf16 and float16, by the names dtype_launches
#: counts
CACHE16 = {"bfloat16": torch.bfloat16, "float16": torch.float16}


@pytest.mark.parametrize("cache", list(CACHE16))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 32, 64), (32, 2, 128), (4, 4, 32),
                                      (64, 8, 112), (8, 1, 256)])
@pytest.mark.parametrize("T", [100, 1000, 4096])
def test_decode_bf16_cache_kernel_vs_plain(dev, T, Hq, Hkv, D, dtype, cache):
    """The split-T kernel over a bf16 or float16 cache (T = 1000: off the
    32-row tiles), at the depths that probe its plan, against the plain
    version; one launch, counted by mode fp and the cache's dtype."""
    N = 7
    p = da.decode_plan(N, T, Hkv, Hq // Hkv, _sms(dev), D)
    depths = _split_depths(T, p.rows)
    gen = torch.Generator(device=dev).manual_seed(T + Hkv + D + 1)
    q = torch.randn((N, Hq, D), generator=gen, device=dev).to(dtype)
    k, v = (_bf16(gen, dev, N, T, Hkv, D, dtype=CACHE16[cache])
            for _ in range(2))
    kv_pos = torch.full((N, T), -1, dtype=torch.int32, device=dev)
    for n, depth in enumerate(depths):
        kv_pos[n, :depth] = torch.arange(depth, device=dev)
    kv_pos[N - 1, T - 5:] = torch.arange(5, device=dev)
    q_pos = torch.tensor([max(d - 1, 0) for d in depths] + [4],
                         dtype=torch.int32, device=dev)
    before = (dict(decode_attention.mode_launches),
              dict(decode_attention.dtype_launches))
    got = decode_attention(q, k, v, kv_pos, q_pos)
    torch.cuda.synchronize()
    assert decode_attention.mode_launches["fp"] == before[0]["fp"] + 1
    assert decode_attention.dtype_launches == dict(
        before[1], **{cache: before[1][cache] + 1})
    want = decode_attention_ref(q, k, v, kv_pos, q_pos)
    assert got.dtype == dtype and got.shape == (N, Hq, D)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)
    assert torch.all(got[depths.index(0)] == 0)          # empty slot


@pytest.mark.parametrize("cache", list(CACHE16))
@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 32, 64), (32, 2, 128), (4, 4, 32),
                                      (64, 8, 112), (8, 1, 256)])
@pytest.mark.parametrize("pos_start,Sq", [(0, 16), (37, 96), (384, 96),
                                          (900, 4)])
def test_prefill_bf16_cache_kernel_vs_plain(dev, pos_start, Sq, Hq, Hkv, D,
                                            dtype, verify, cache):
    """Both prefill kernels (bf16 q: tensor cores; fp32 q: CUDA cores)
    over a bf16 or float16 cache, plain and as the verify pass (the
    window rounds to the cache's type and back there), against the plain
    version."""
    T = 1024
    length = Sq if verify else max(1, Sq - Sq // 4)
    gen = torch.Generator(device=dev).manual_seed(Sq + pos_start + D + 2)
    q, kn, vn, ck, cv, kv_pos, _ = _chunk_inputs(
        gen, dev, Sq, T, Hq, Hkv, D, False, dtype, pos_start)
    ck, cv = ck.to(CACHE16[cache]), cv.to(CACHE16[cache])
    before = (dict(prefill_attention.mode_launches),
              prefill_attention.dtype_launches[cache])
    got, aux = prefill_attention(q, kn, vn, ck, cv, kv_pos, pos_start,
                                 length, verify=verify)
    torch.cuda.synchronize()
    mode = "verify_fp" if verify else "fp"
    assert prefill_attention.mode_launches[mode] == before[0][mode] + 1
    assert prefill_attention.dtype_launches[cache] == before[1] + 1
    want = prefill_attention_ref(q, kn, vn, ck, cv, kv_pos, pos_start,
                                 length, verify=verify)
    assert aux == () and got.dtype == dtype and got.shape == (Sq, Hq, D)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("cache", list(CACHE16))
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("where", ["decode", "chunk", "past_T"])
@pytest.mark.parametrize("D", [32, 64, 112, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_write_bf16_destination_bit_identical(dev, dtype, D, where,
                                                 offset, cache):
    """The write into a bf16 or float16 cache (rounded to nearest even)
    against its plain version: every byte of the destination and kv_pos
    equal, the guard slot untouched; ``offset``: K/V and the destination
    are views that many elements into their storage (smaller
    vectors)."""
    N, T, Hkv = 4, 40, 3
    gen = torch.Generator(device=dev).manual_seed(D + len(where) + offset)
    kw, R = _write_map(where, N, T, dev)

    def view(x):
        big = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        out = big[offset:].view(x.shape)
        out.copy_(x)
        return out
    k, v = (view(torch.randn((R, Hkv, D), generator=gen, device=dev)
                 .to(dtype) * 3) for _ in range(2))
    bufs = [view(_bf16(gen, dev, N + 1, T, Hkv, D, dtype=CACHE16[cache]))
            for _ in range(2)]
    bufs.append(torch.randint(-1, 3 * T, (N + 1, T), generator=gen,
                              device=dev, dtype=torch.int32))
    want = [b.clone() for b in bufs]
    pa.write_kv_rows_ref(k, v, *[b[:N] for b in want], **kw)
    before = (dict(pa.write_kv_rows.mode_launches),
              dict(pa.write_kv_rows.dtype_launches))
    pa.write_kv_rows(k, v, *[b[:N] for b in bufs], **kw)
    torch.cuda.synchronize()
    assert pa.write_kv_rows.mode_launches == dict(
        before[0], fp=before[0]["fp"] + 1)
    assert pa.write_kv_rows.dtype_launches == dict(
        before[1], **{cache: before[1][cache] + 1})
    for got, ref in zip(bufs, want):
        assert torch.equal(got, ref)


def test_bf16_cache_smem_says_two_bytes(dev):
    lib = pa.build.library()
    for D in (32, 64, 128, 256):
        w = 1 if D == 256 else 4     # an fp32 block at D = 256 fits one warp
        b16 = lib.decode_attention_smem(D, 0, 2, 0, 1, w)
        b32 = lib.decode_attention_smem(D, 0, 4, 0, 1, w)
        assert 0 < b16 < b32
        assert lib.prefill_attention_smem(D, 0, 2, 1024) < \
            lib.prefill_attention_smem(D, 0, 4, 1024)


def test_sampler_distribution_on_the_card(dev):
    """sample_tokens on the card, a seeded logits row at T = 0.7, 2e4
    draws: the 64 hot tokens and the rest within the 1 - 1e-6 chi-square
    bound (64 degrees of freedom: 132.79) of softmax(logits / T)."""
    from repro_torch.engine.engine import sample_tokens
    V, n, T = 4096, 20_000, 0.7
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(V, generator=g)
    hot = torch.randperm(V, generator=g)[:64].sort().values
    logits[hot] = 4.0 + 1.5 * torch.rand(64, generator=g)
    p = torch.softmax(logits.double() / T, -1)
    expect = n * torch.cat([p[hot], 1 - p[hot].sum()[None]])
    assert float(expect.min()) >= 5
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = sample_tokens(logits.to(dev).expand(n, V), T, gen).cpu()
    counts = torch.bincount(toks, minlength=V).double()
    o = torch.cat([counts[hot], (n - counts[hot].sum())[None]])
    assert float(((o - expect) ** 2 / expect).sum()) < 132.79


@pytest.mark.parametrize("kw", [
    dict(kv_mode="fp", kv_dtype="bfloat16", prefill_chunk=32),
    dict(kv_mode="int8", prefill_chunk=0),
    dict(kv_mode="int8", prefill_chunk=32, fused_attn=False),
    dict(kv_mode="fp", kv_dtype="bfloat16", prefill_chunk=0, spec_k=2)],
    ids=["bf16-cache", "oneshot-int8", "materialize", "bf16-oneshot-spec"])
def test_engine_options_card_match_cpu(dev, kw):
    """Reduced stablelm in fp32 with INT4 SplitQuant weights: the card's
    greedy tokens equal the CPU's over a bf16 cache, with one-shot
    prefill, through the materialize read path, and speculating over
    one-shot admissions."""
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
                                          max_new_tokens=8, **kw), device=d)
        for pr in prompts:
            eng.submit(pr)
        outs[d] = [r.out for r in eng.drain()]
    assert outs["cuda"] == outs["cpu"]


# -------------------------------------------------------- reliability ---
@pytest.fixture(scope="module")
def wide():
    """stablelm-1.6b at its published widths, cut to 2 layers, INT4
    SplitQuant on the card, and 8 prompts of 100-600 tokens: the shapes
    at which the matmul splits K and the decode kernel splits T."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg = dataclasses.replace(get_arch("stablelm-1.6b"), n_layers=2)
    params, _ = build_params(cfg, bits=4, method="splitquant",
                             device="cuda")
    return cfg, params, seeded_prompts(cfg.vocab, 8, 100, 600, seed=4)


def _wide_engine(wide, cache, submit=True, **ecfg_kw):
    """An engine over ``wide`` on its params' device, with its 8 prompts
    submitted; cache: "int8", "static" or "bf16"; ``ecfg_kw``: further
    EngineConfig fields."""
    from repro_torch.calib import collect_kv_stats, kv_static_scales
    from repro_torch.engine import Engine, EngineConfig
    cfg, params, prompts = wide
    kw = {"int8": dict(kv_mode="int8"), "static": dict(kv_mode="int8"),
          "bf16": dict(kv_mode="fp", kv_dtype="bfloat16")}[cache]
    scales = None
    if cache == "static":
        toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 256))
        scales = kv_static_scales(collect_kv_stats(cfg, params, [toks]))
    eng = Engine(cfg, params, EngineConfig(
        n_slots=8, max_len=1024, max_new_tokens=32, prefill_chunk=96, **kw,
        **ecfg_kw), device=params["embed"].device, kv_scales=scales)
    for p in prompts if submit else ():
        eng.submit(p)
    return eng


def _cache_copy(cache):
    from repro_torch.engine.kvcache import CACHE_DATA_FIELDS
    return {f: getattr(cache, f).clone() for f in CACHE_DATA_FIELDS}


def _assert_same_cache(a, b):
    for f in a:
        assert torch.equal(a[f], b[f]), f


@pytest.mark.parametrize("cache", ["int8", "static", "bf16"])
def test_decode_step_reexecutes_bit_identically(dev, wide, cache):
    """The retry contract on the card: one decode step over 8 slots at
    their own positions, the slots rolled back to the step's start, the
    step run again — identical logits and identical cache bytes (codes,
    scales and kv_pos of the rewritten rows, and everything else)."""
    from repro_torch.engine.kvcache import rollback_slot
    from repro_torch.models import transformer
    eng = _wide_engine(wide, cache)
    while len(eng.sched.active_slots()) < 8:
        eng.step()
    eng.step()
    cfg, params, _ = wide
    pos0 = eng._pos.copy()
    toks = torch.from_numpy(eng._last_tok[:, None]).to(dev)
    pos = torch.from_numpy(pos0).to(dev)
    out = []
    for _ in range(2):
        logits = transformer.decode_step_slots(params, cfg, eng.cache, toks,
                                               pos)
        out.append((logits.clone(), _cache_copy(eng.cache)))
        for s in range(8):
            rollback_slot(eng.cache, s, int(pos0[s]))
    assert torch.equal(out[0][0], out[1][0])
    assert bool(torch.isfinite(out[0][0]).all())
    _assert_same_cache(out[0][1], out[1][1])


@pytest.mark.parametrize("cache", ["int8", "static", "bf16"])
def test_prefill_chunk_reexecutes_bit_identically(dev, wide, cache):
    """A 96-token chunk at position 96 of a slot, rolled back and run
    again: identical logits and cache bytes."""
    from repro_torch.engine.kvcache import rollback_slot
    from repro_torch.models import transformer
    cfg, params, prompts = wide
    eng = _wide_engine(wide, cache)
    toks = torch.as_tensor(prompts[0][:192], device=dev)[None]
    transformer.prefill_chunk_slots(params, cfg, eng.cache, toks[:, :96], 3,
                                    0, 96)
    out = []
    for _ in range(2):
        logits = transformer.prefill_chunk_slots(
            params, cfg, eng.cache, toks[:, 96:], 3, 96, 96)
        out.append((logits.clone(), _cache_copy(eng.cache)))
        rollback_slot(eng.cache, 3, 96)
    assert torch.equal(out[0][0], out[1][0])
    _assert_same_cache(out[0][1], out[1][1])


@pytest.mark.parametrize("cache", ["int8", "static", "bf16"])
def test_snapshot_round_trip_on_the_card(dev, wide, cache, tmp_path):
    """A snapshot written from the card and restored onto the card in a
    new engine: every cache tensor torch.equal, the host state equal, and
    both engines drain to the same tokens."""
    eng = _wide_engine(wide, cache)
    for _ in range(6):
        eng.step()
    before = {r.uid for r in eng.sched.finished}
    eng.snapshot(str(tmp_path / "snap"))
    other = _wide_engine(wide, cache, submit=False)
    other.restore(str(tmp_path / "snap"))
    _assert_same_cache(_cache_copy(eng.cache), _cache_copy(other.cache))
    for f in ("_last_tok", "_pos", "_prefill_prog"):
        np.testing.assert_array_equal(getattr(eng, f), getattr(other, f))
    a = {r.uid: r.out for r in eng.drain() if r.uid not in before}
    b = {r.uid: r.out for r in other.drain()}
    assert a == b and len(a) == 8 - len(before)


def _reduced_pair(dev):
    from repro_torch.configs import get_arch
    from repro_torch.core.apply import tree_to
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg = get_arch("stablelm-1.6b").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", device="cpu")
    prompts = seeded_prompts(cfg.vocab, 7, 3, 13, seed=3)
    return cfg, {"cpu": params, "cuda": tree_to(params, dev)}, prompts


@pytest.mark.parametrize("kv_mode", ["fp", "int8"])
def test_chaos_card_matches_cpu(dev, kv_mode):
    """Reduced stablelm, INT4 weights, the JAX package's chaos spec: the
    card's finished list (uid, reason, tokens), retries and quarantines
    equal the CPU's."""
    from repro_torch.engine import Engine, EngineConfig, FaultSpec
    cfg, params, prompts = _reduced_pair(dev)
    spec = FaultSpec(seed=5, step_exception_rate=0.15, nan_logits_rate=0.10,
                     slow_step_rate=0.05, slow_step_s=0.0005,
                     poison_rate=0.25, max_faults=60)
    got = {}
    for d in ("cpu", "cuda"):
        eng = Engine(cfg, params[d], EngineConfig(
            n_slots=3, max_len=48, prefill_bucket=8, prefill_chunk=8,
            kv_mode=kv_mode, fault_spec=spec), device=d)
        for p, b in zip(prompts, [6, 1, 6, 4, 3, 6, 5]):
            eng.submit(p, max_new_tokens=b)
        fin = [(r.uid, r.finish_reason, r.out) for r in eng.drain()]
        m = eng.metrics()
        got[d] = fin, m["step_retries"], m["quarantined"]
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][1] > 0


@pytest.mark.parametrize("kv_mode", ["fp", "int8"])
def test_crash_recovery_card_matches_cpu(dev, kv_mode, tmp_path):
    """A seeded crash after a snapshot, recovered in a new engine from
    snapshot + journal: the card's finished tokens equal the CPU's, and
    every uid retires once."""
    from repro_torch.engine import (Engine, EngineConfig, FaultSpec,
                                    InjectedCrash)
    cfg, params, prompts = _reduced_pair(dev)
    done = {}
    for d in ("cpu", "cuda"):
        jpath, spath = str(tmp_path / f"{d}.jsonl"), str(tmp_path / d)
        base = dict(n_slots=3, max_len=48, prefill_bucket=8,
                    prefill_chunk=8, kv_mode=kv_mode, journal_path=jpath,
                    snapshot_path=spath)
        eng = Engine(cfg, params[d], EngineConfig(
            **base, snapshot_every=3, fault_spec=FaultSpec(
                seed=2, crash_rate=0.25, max_faults=1)), device=d)
        for p, b in zip(prompts, [6, 1, 6, 4, 3, 6, 5]):
            eng.submit(p, max_new_tokens=b)
        with pytest.raises(InjectedCrash):
            eng.drain()
        del eng
        eng = Engine(cfg, params[d], EngineConfig(**base,
                                                  journal_resume=True),
                     device=d)
        info = eng.recover()
        assert info["n_restored"] > 0
        out = {u: rec["out"] for u, rec in info["retired"].items()}
        for r in eng.drain():
            assert r.uid not in out
            out[r.uid] = r.out
        done[d] = out
    assert done["cuda"] == done["cpu"] and sorted(done["cpu"]) == \
        list(range(7))


def test_kmeans_is_deterministic_on_the_card(dev):
    """The same seed gives the same centroids in every run on the card
    (a recovering process rebuilds its weights): the segment sums are a
    reduction, not float atomics."""
    from repro_torch.core.kmeans import kmeans_1d
    x = torch.randn(1 << 18, generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev) * 0.02
    outs = {tuple(kmeans_1d(torch.Generator(device=dev).manual_seed(0),
                            x).centroids.tolist()) for _ in range(5)}
    assert len(outs) == 1


# ------------------------------------------------------ observability ---
@pytest.mark.parametrize("cache", ["int8", "static", "bf16"])
def test_traced_tokens_equal_untraced_on_the_card(dev, wide, cache):
    """Tracing (its device syncs, spans and KV samples) changes no token
    on the card: the traced engine's tokens equal the untraced one's, the
    trace validates, nothing is dropped, and the phase attribution covers
    the step wall."""
    from repro_torch.obs import validate_events
    plain = {r.uid: r.out for r in _wide_engine(wide, cache).drain()}
    eng = _wide_engine(wide, cache, trace=True, trace_kv_every=2,
                       metrics_kv_every=2)
    traced = {r.uid: r.out for r in eng.drain()}
    assert traced == plain and len(plain) == 8
    assert validate_events(list(eng.tracer.records())) == []
    assert eng.tracer.dropped == 0
    pa = eng.metrics()["phase_attribution"]
    assert pa["coverage"] > 0.5 and pa["device_wait_s"] > 0
    kv = [r for r in eng.tracer.events if r["kind"] == "counter"]
    assert len(kv) == ((len(eng.step_s) + 1) // 2
                       if cache != "bf16" else 0)


@pytest.mark.parametrize("cache", ["int8", "static"])
def test_kv_quality_counters_card_equal_cpu(dev, wide, cache):
    """kv_quality_counters of the live card cache (rows gathered on the
    card, only they copied) equal the same function on a CPU copy of the
    whole cache, with and without thinning to max_rows."""
    from repro_torch.engine.kvcache import (CACHE_DATA_FIELDS, SlotKVCache,
                                            kv_quality_counters)
    eng = _wide_engine(wide, cache)
    for _ in range(8):
        eng.step()
    c = eng.cache
    host = SlotKVCache(**{f: getattr(c, f).cpu() for f in CACHE_DATA_FIELDS},
                       mode=c.mode, qchunks=c.qchunks, static=c.static)
    for max_rows in (4096, 97):
        got = kv_quality_counters(c, max_rows=max_rows)
        want = kv_quality_counters(host, max_rows=max_rows)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=1e-6), k
            else:
                assert got[k] == v, k
        assert got["valid_rows"] > 0


@pytest.mark.parametrize("kv_mode", ["fp", "int8"])
def test_storm_firings_and_bundles_card_match_cpu(dev, kv_mode, tmp_path):
    """Reduced stablelm, INT4 weights, the JAX package's chaos spec with
    an incident dir: the event detectors' firings (detector, step, uid)
    and the bundles written (names and triggers) on the card equal the
    CPU's. The wall-clock detector (step_latency_spike) is switched off
    on both devices: it reads time, not the schedule."""
    from repro_torch.engine import Engine, EngineConfig, FaultSpec
    from repro_torch.obs import load_incident_bundle
    from repro_torch.obs.detect import EVENT_DETECTORS
    cfg, params, prompts = _reduced_pair(dev)
    spec = FaultSpec(seed=5, step_exception_rate=0.15, nan_logits_rate=0.10,
                     slow_step_rate=0.05, slow_step_s=0.0005,
                     poison_rate=0.25, max_faults=60)
    got = {}
    for d in ("cpu", "cuda"):
        inc = tmp_path / d
        eng = Engine(cfg, params[d], EngineConfig(
            n_slots=3, max_len=48, prefill_bucket=8, prefill_chunk=8,
            kv_mode=kv_mode, fault_spec=spec, incident_dir=str(inc),
            incident_cooldown=5), device=d)
        eng._detect.latency_factor = float("inf")
        fired = []
        sweep = eng._detect.sweep

        def spy(rec, sweep=sweep, fired=fired):
            out = sweep(rec)
            fired.extend((f.detector, f.step, f.uid) for f in out
                         if f.detector in EVENT_DETECTORS)
            return out

        eng._detect.sweep = spy
        for p, b in zip(prompts, [6, 1, 6, 4, 3, 6, 5]):
            eng.submit(p, max_new_tokens=b)
        eng.drain()
        bundles = sorted(os.listdir(inc))
        trig = [load_incident_bundle(str(inc / b))["trigger.json"]["trigger"]
                for b in bundles]
        got[d] = fired, bundles, [(t["detector"], t["step"], t["uid"],
                                   t["reason"]) for t in trig]
    assert got["cuda"] == got["cpu"]
    assert got["cpu"][0] and got["cpu"][1]


# ------------------------------------------------------------------ MoE ---
def _stack(gen, E, K, N, bits, k, dev):
    parts = [_packed(gen, K, N, bits, k, dev) for _ in range(E)]
    return tuple(torch.stack(t) for t in zip(*parts))


def _offsets(counts, dev):
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=dev)


#: rows per expert of the grouped kernel tests: empty experts, an expert
#: with more rows than one M tile (64 bf16 rows, 8 fp32) and more than two
#: (> 128), one row each, all rows on the last expert
GROUPED_COUNTS = [[0, 300, 0, 5, 0, 0, 1, 129], [1] * 8, [0] * 7 + [64],
                  [7, 0, 0, 0, 0, 0, 0, 0]]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts", GROUPED_COUNTS)
@pytest.mark.parametrize("K,N", [(256, 384), (200, 130)])
def test_grouped_matmul_vs_plain(dev, bits, dtype, counts, K, N):
    """The grouped kernel (each expert's rows times its packed matrix,
    one launch) against its plain version, bf16 and fp32, ragged K and N,
    empty experts and an expert of more than 128 rows; counted once under
    its variant and its bit-width."""
    gen = torch.Generator(device=dev).manual_seed(sum(counts) + K + bits)
    qp, cp, recip, shift = _stack(gen, len(counts), K, N, bits, 3, dev)
    offsets = _offsets(counts, dev)
    x = torch.randn((sum(counts), K), generator=gen, device=dev).to(dtype)
    before = dict(splitquant_matmul.variant_launches)
    by_bits = dict(splitquant_matmul.bits_launches)
    got = sqm.grouped_splitquant_matmul(x, offsets, qp, cp, recip, shift,
                                        bits=bits, k=3)
    torch.cuda.synchronize()
    want = sqm.grouped_splitquant_matmul_ref(x, offsets, qp, cp, recip,
                                             shift, bits)
    assert got.dtype == dtype and got.shape == (sum(counts), N)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)
    after = splitquant_matmul.variant_launches
    assert after[sqm.GROUPED] == before[sqm.GROUPED] + 1
    assert all(after[v] == before[v] for v in after if v != sqm.GROUPED)
    assert splitquant_matmul.bits_launches[bits] == by_bits[bits] + 1


def test_grouped_matmul_refuses_what_it_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    qp, cp, recip, shift = _stack(gen, 4, 64, 32, 4, 3, dev)
    x = torch.randn((6, 64), generator=gen, device=dev)
    off = _offsets([1, 2, 3, 0], dev)
    for bad in (dict(offsets=off.long()), dict(offsets=off[:4]),
                dict(x=x.half()), dict(recip=recip[:, :2])):
        kw = {**dict(x=x, offsets=off, q_packed=qp, cid_packed=cp,
                     recip=recip, shift=shift), **bad}
        with pytest.raises((ValueError, TypeError)):
            sqm.grouped_splitquant_matmul(**kw, bits=4, k=3)


def test_moe_layer_card_matches_cpu(dev):
    """apply_moe of reduced moonshot-v1-16b-a3b (fp32, INT4 experts): the
    card's grouped form (three grouped launches, no expert stack
    dequantized) equals the CPU's literal form, with and without drops."""
    from repro_torch.configs import get_arch
    from repro_torch.core.apply import tree_to
    from repro_torch.launch.serve import build_params
    from repro_torch.models import ffn
    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", device="cpu")
    mp = params["moe_layers"][0]["moe"]
    mp_dev = tree_to(mp, dev)
    rng = np.random.default_rng(0)
    for T, cf in ((24, None), (600, 0.5)):
        x = torch.from_numpy(rng.standard_normal(
            (1, T, cfg.d_model)).astype(np.float32))
        want, aux = ffn.apply_moe(mp, x, cfg, capacity_factor=cf)
        g0 = splitquant_matmul.variant_launches[sqm.GROUPED]
        d0 = ffn.EXPERT_DEQUANTIZATIONS
        got, aux_dev = ffn.apply_moe(mp_dev, x.to(dev), cfg,
                                     capacity_factor=cf)
        torch.cuda.synchronize()
        assert splitquant_matmul.variant_launches[sqm.GROUPED] == g0 + 3
        assert ffn.EXPERT_DEQUANTIZATIONS == d0
        _close(got.cpu(), want, 1e-4)
        assert float(aux_dev) == pytest.approx(float(aux), rel=1e-5)


def test_moe_engine_card_matches_cpu(dev):
    """Reduced moonshot-v1-16b-a3b in fp32 (INT4 weights) through the
    engine over int8 dynamic and bf16 caches: card tokens equal the
    CPU's."""
    from repro_torch.configs import get_arch
    from repro_torch.core.apply import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", device="cpu")
    prompts = seeded_prompts(cfg.vocab, 6, 3, 60, seed=2)
    for kw in (dict(kv_mode="int8"), dict(kv_mode="fp", kv_dtype="bfloat16"),
               dict(kv_mode="int8", prefill_chunk=8)):
        outs = {}
        for d, p in (("cpu", params), ("cuda", tree_to(params, dev))):
            eng = Engine(cfg, p, EngineConfig(n_slots=3, max_len=96,
                                              max_new_tokens=6, **kw),
                         device=d)
            for pr in prompts:
                eng.submit(pr)
            outs[d] = [r.out for r in eng.drain()]
        assert outs["cuda"] == outs["cpu"], kw


def test_stacked_kmeans_is_deterministic_on_the_card(dev):
    """The batched k-means over a stack of expert matrices gives the same
    centroids in every run on the card."""
    from repro_torch.core.kmeans import kmeans_1d_batched
    x = torch.randn((16, 1 << 14), generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev) * 0.02
    outs = {tuple(kmeans_1d_batched(torch.Generator(device=dev)
                                    .manual_seed(0), x).flatten().tolist())
            for _ in range(4)}
    assert len(outs) == 1


# ------------------------------------------------- kimi-k2's shapes ---
@pytest.mark.parametrize("E,K,N,bits,rows", [
    (384, 7168, 2048, 4, 64), (384, 7168, 2048, 4, 768),
    (384, 2048, 7168, 4, 64), (384, 2048, 7168, 4, 768),
    (64, 2048, 1408, 2, 48), (64, 1408, 2048, 2, 576)])
def test_grouped_matmul_at_moe_serving_shapes(dev, E, K, N, bits, rows):
    """The grouped kernel at kimi-k2-1t-a32b's expert shapes (384 experts,
    INT4, a decode step's 64 pairs and a 96-token chunk's 768) and at
    moonshot-v1-16b-a3b's INT2 draft's (a decode step's 48 pairs and a
    chunk's 576), bf16, routed by a seeded top-k: against its plain
    version; 384 x 7168 x 2048 codes need no 64-bit index within an
    expert."""
    gen = torch.Generator(device=dev).manual_seed(E + K + bits + rows)
    top = 8 if E == 384 else 6
    qp = torch.randint(0, 256, (E, K * bits // 8, N), generator=gen,
                       dtype=torch.uint8, device=dev)
    # packed ids drawn as bytes, each 2-bit id moved from 3 to 2 (k = 3):
    # no (E, K, N) id tensor of 5.6 G elements
    cp = torch.randint(0, 256, (E, K // 4, N), generator=gen,
                       dtype=torch.uint8, device=dev)
    for p in range(4):
        cp -= ((cp >> (2 * p)) & 3 == 3).to(torch.uint8) << (2 * p)
    recip = (torch.rand((E, 3, N), generator=gen, device=dev) + 0.5) / 16
    shift = torch.randn((E, 3, N), generator=gen, device=dev) * 0.05
    probs = torch.rand((rows // top, E), generator=gen, device=dev)
    flat = torch.topk(probs, top, dim=-1).indices.reshape(-1)
    offsets = torch.searchsorted(torch.sort(flat).values, torch.arange(
        E + 1, device=dev)).to(torch.int32)
    x = torch.randn((rows, K), generator=gen, device=dev).to(torch.bfloat16)
    got = sqm.grouped_splitquant_matmul(x, offsets, qp, cp, recip, shift,
                                        bits=bits, k=3)
    torch.cuda.synchronize()
    want = sqm.grouped_splitquant_matmul_ref(x, offsets, qp, cp, recip,
                                             shift, bits)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 2e-2)


def _kimi_small(dev):
    """Reduced kimi-k2-1t-a32b at head_dim 112 with GQA 8/1 in bf16 (the
    card's tensor-core attention and head-group decode), INT4 SplitQuant
    on the card, and 6 prompts."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg = dataclasses.replace(get_arch("kimi-k2-1t-a32b").reduced(),
                              head_dim_override=112, n_heads=8,
                              n_kv_heads=1, param_dtype="bfloat16")
    params, _ = build_params(cfg, bits=4, method="splitquant", device=dev)
    return cfg, params, seeded_prompts(cfg.vocab, 6, 100, 200, seed=3)


@pytest.mark.parametrize("cache", ["int8", "static", "bf16"])
def test_kimi_step_and_chunk_reexecute_after_rollback(dev, cache):
    """Reduced kimi at head_dim 112 (chunks of 28): a decode step over the
    slots and a 96-token prefill chunk, each rolled back and run again,
    give identical logits and cache bytes."""
    from repro_torch.calib import collect_kv_stats, kv_static_scales
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.engine.kvcache import rollback_slot
    from repro_torch.models import transformer
    cfg, params, prompts = _kimi_small(dev)
    kw = dict(kv_mode="fp", kv_dtype="bfloat16") if cache == "bf16" else \
        dict(kv_mode="int8")
    scales = None
    if cache == "static":
        rng = np.random.default_rng(0)
        scales = kv_static_scales(collect_kv_stats(
            cfg, params, [rng.integers(0, cfg.vocab, (2, 64))]))
    eng = Engine(cfg, params, EngineConfig(n_slots=4, max_len=256,
                                           max_new_tokens=48,
                                           prefill_chunk=96, **kw),
                 device=dev, kv_scales=scales)
    for p in prompts[:4]:
        eng.submit(p)
    for _ in range(40):               # every slot decoding
        if len(eng.sched.active_slots()) == 4:
            break
        eng.step()
    assert len(eng.sched.active_slots()) == 4
    eng.step()
    pos0 = eng._pos.copy()
    toks = torch.from_numpy(eng._last_tok[:, None]).to(dev)
    out = []
    for _ in range(2):
        logits = transformer.decode_step_slots(
            params, cfg, eng.cache, toks, torch.from_numpy(pos0).to(dev))
        out.append((logits.clone(), _cache_copy(eng.cache)))
        for s in range(4):
            rollback_slot(eng.cache, s, int(pos0[s]))
    assert torch.equal(out[0][0], out[1][0])
    assert bool(torch.isfinite(out[0][0]).all())
    _assert_same_cache(out[0][1], out[1][1])
    slot = 0
    eng.cache.kv_pos[:, slot] = -1
    chunk = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, 192), device=dev)[None]
    transformer.prefill_chunk_slots(params, cfg, eng.cache, chunk[:, :96],
                                    slot, 0, 96)
    out = []
    for _ in range(2):
        logits = transformer.prefill_chunk_slots(
            params, cfg, eng.cache, chunk[:, 96:], slot, 96, 96)
        out.append((logits.clone(), _cache_copy(eng.cache)))
        rollback_slot(eng.cache, slot, 96)
    assert torch.equal(out[0][0], out[1][0])
    _assert_same_cache(out[0][1], out[1][1])


@pytest.mark.parametrize("kv", ["int8", "static", "bf16"])
def test_kimi_engine_card_matches_cpu(dev, kv):
    """Reduced kimi at head_dim 112 in fp32 (INT4 weights; the fp32
    kernels) through the engine over int8 dynamic, int8 static and bf16
    caches: card tokens equal the CPU's."""
    from repro_torch.calib import collect_kv_stats, kv_static_scales
    from repro_torch.configs import get_arch
    from repro_torch.core.apply import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import build_params, seeded_prompts
    cfg = dataclasses.replace(get_arch("kimi-k2-1t-a32b").reduced(),
                              head_dim_override=112, n_heads=8, n_kv_heads=1)
    params, _ = build_params(cfg, bits=4, method="splitquant", device="cpu")
    prompts = seeded_prompts(cfg.vocab, 6, 3, 60, seed=2)
    kw = dict(kv_mode="fp", kv_dtype="bfloat16") if kv == "bf16" else \
        dict(kv_mode="int8")
    scales = None
    if kv == "static":
        rng = np.random.default_rng(0)
        scales = kv_static_scales(collect_kv_stats(
            cfg, params, [rng.integers(0, cfg.vocab, (2, 40))]))
    outs = {}
    for d, p in (("cpu", params), ("cuda", tree_to(params, dev))):
        eng = Engine(cfg, p, EngineConfig(n_slots=3, max_len=96,
                                          max_new_tokens=6, **kw),
                     device=d, kv_scales=scales)
        for pr in prompts:
            eng.submit(pr)
        outs[d] = [r.out for r in eng.drain()]
    assert outs["cuda"] == outs["cpu"]


def test_attention_kernels_take_head_dim_256(dev):
    """D = 256 (paligemma-3b, recurrentgemma-9b; once refused): decode and
    prefill attention at MHA 4/4 over an int8 cache (one head a block),
    each against its plain version."""
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v, kv_pos, q_pos, sc = _decode_inputs(gen, dev, 4, 64, 4, 4, 256,
                                                True, torch.bfloat16)
    _close(decode_attention(q, k, v, kv_pos, q_pos, *sc),
           decode_attention_ref(q, k, v, kv_pos, q_pos, *sc), 2e-2)
    args = (q, q[:, :4], q[:, :4], k[0], v[0], kv_pos[0], 10, 4,
            *(s[0] for s in sc))
    _close(prefill_attention(*args)[0], prefill_attention_ref(*args), 2e-2)


def _vlm_small(wide: bool, dtype: str = "float32"):
    """Reduced paligemma-3b (MQA 4/1 at head_dim 32), or its head_dim-256
    variant (MQA 2/1, d_model 512), INT4 SplitQuant on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_params
    cfg = dataclasses.replace(get_arch("paligemma-3b").reduced(),
                              param_dtype=dtype)
    if wide:
        cfg = dataclasses.replace(cfg, n_heads=2, n_kv_heads=1, d_model=512)
    params, _ = build_params(cfg, bits=4, method="splitquant", device="cpu")
    return cfg, params


@pytest.mark.parametrize("kv", ["int8", "static", "f16"])
@pytest.mark.parametrize("wide", [False, True])
def test_vlm_engine_card_matches_cpu(dev, wide, kv):
    """The engine over reduced paligemma (fp32; at head_dim 256 too) with
    an int8 dynamic, an int8 static or a float16 fp cache, prompts
    spanning 96-token chunks: card tokens == CPU tokens."""
    from repro_torch.calib import collect_kv_stats, kv_static_scales
    from repro_torch.core.apply import tree_to
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import seeded_prompts
    cfg, params = _vlm_small(wide)
    prompts = seeded_prompts(cfg.vocab, 5, 16, 200, seed=4)
    kw = dict(kv_mode="fp", kv_dtype="float16") if kv == "f16" else \
        dict(kv_mode="int8")
    scales = None
    if kv == "static":
        rng = np.random.default_rng(0)
        scales = kv_static_scales(collect_kv_stats(
            cfg, params, [rng.integers(0, cfg.vocab, (2, 40))]))
    outs = {}
    for d, p in (("cpu", params), ("cuda", tree_to(params, dev))):
        eng = Engine(cfg, p, EngineConfig(n_slots=3, max_len=256,
                                          max_new_tokens=6, prefill_chunk=96,
                                          **kw), device=d, kv_scales=scales)
        for pr in prompts:
            eng.submit(pr)
        outs[d] = [r.out for r in eng.drain()]
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("wide", [False, True])
def test_vlm_prefix_prefill_card_matches_cpu(dev, wide):
    """``transformer.prefill`` of 2 prompts with their 8 patch embeds
    (``patch_proj`` through the matmul kernel, counted) in fp32: logits
    (2, 8 + 24, V) card == CPU within the fp32 tolerance."""
    from repro_torch.core.apply import tree_to
    from repro_torch.models import transformer
    cfg, params = _vlm_small(wide)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24))),
             "patch_embeds": torch.from_numpy(rng.standard_normal(
                 (2, 8, transformer.VLM_PATCH_DIM)).astype(np.float32))}
    want, _ = transformer.prefill(params, cfg, batch, max_len=64)
    before = splitquant_matmul.launches
    got, cache = transformer.prefill(
        tree_to(params, dev), cfg, {k: v.to(dev) for k, v in batch.items()},
        max_len=64)
    torch.cuda.synchronize()
    assert splitquant_matmul.launches > before
    assert got.shape == (2, 32, cfg.vocab) and cache.k.shape[2] == 64
    _close(got.cpu(), want, 1e-4)


# ------------------------------------------- bert-tiny, Table 1, training ---
#: (M, K, N) of bert-tiny's quantized products in Table 1's evaluation
#: (100 sequences of 64 tokens; the pooler's and classifiers' [CLS] rows):
#: the scalar column path at N = 6 and 2, 800 M tiles at M = 6400
BERT_MATMUL_SHAPES = [(6400, 128, 128), (6400, 128, 512), (6400, 512, 128),
                      (100, 128, 128), (100, 128, 6), (100, 128, 2)]


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M,K,N", BERT_MATMUL_SHAPES)
def test_fp32_matmul_at_bert_tiny_shapes(dev, M, K, N, bits, k):
    """The CUDA-core kernel (fp32 x) at bert-tiny's shapes against its
    plain version, within 1e-4 of the output's scale."""
    gen = torch.Generator(device=dev).manual_seed(M + N + bits)
    qp, cp, recip, shift = _packed(gen, K, N, bits, k, dev)
    x = torch.randn((M, K), generator=gen, device=dev)
    before = sqm.splitquant_matmul.variant_launches[sqm.CUDA_CORE]
    got = splitquant_matmul(x, qp, cp, recip, shift, bits=bits, k=k)
    torch.cuda.synchronize()
    assert sqm.splitquant_matmul.variant_launches[sqm.CUDA_CORE] == \
        before + 1
    _close(got, splitquant_matmul_ref(x, qp, cp, recip, shift, bits), 1e-4)


def _bert_small(n_classes=6, seq=32):
    from repro_torch.configs import get_arch
    from repro_torch.models import bert_tiny
    cfg = get_arch("bert-tiny")
    return cfg, bert_tiny.init(cfg, n_classes, max_len=seq, seed=3,
                               device="cpu")


def _nudge_biases(params, seed=0):
    """Non-zero biases (a trained model's), so their quantization is not
    degenerate."""
    gen = torch.Generator().manual_seed(seed)

    def go(tree, name=""):
        if isinstance(tree, dict):
            return {k: go(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [go(v, name) for v in tree]
        if tree.dim() == 1 and name.startswith("b"):
            return tree + 0.1 * torch.randn(tree.shape, generator=gen)
        return tree
    return go(params)


def _bert_batch(cfg, B=8, seq=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(100, cfg.vocab, (B, seq))
    toks[:, 0] = 101
    mask = np.ones((B, seq), np.int64)
    for b in range(1, B):
        mask[b, seq - 3 * b:] = 0
    toks = np.where(mask > 0, toks, 0)
    return {"tokens": torch.from_numpy(toks), "mask": torch.from_numpy(mask),
            "labels": torch.from_numpy(rng.integers(0, 6, B))}


@pytest.mark.parametrize("method", ["splitquant", "baseline"])
def test_quantized_bert_with_biases_card_matches_cpu(dev, method):
    """bert-tiny quantized at INT2 with its biases (``dense`` adds their
    dequantization; its matrices through the fp32 kernel): logits card ==
    CPU within 1e-4 of their scale; ``dense`` with a quantized bias
    alone too."""
    from repro_torch.core.apply import QuantPolicy, quantize_tree, tree_to
    from repro_torch.core.quantize import QuantConfig
    from repro_torch.core.splitquant import SplitQuantTensor
    from repro_torch.models import bert_tiny
    from repro_torch.models.common import dense
    cfg, params = _bert_small()
    q, rep = quantize_tree(_nudge_biases(params), QuantPolicy(
        cfg=QuantConfig(bits=2), method=method))
    assert isinstance(q["layers"][0]["attn"]["bq"], SplitQuantTensor)
    qd = tree_to(q, dev)
    b = _bert_batch(cfg)
    before = sqm.splitquant_matmul.variant_launches[sqm.CUDA_CORE]
    with torch.no_grad():
        got = bert_tiny.forward(qd, cfg, {k: v.to(dev) for k, v in
                                          b.items()})
        want = bert_tiny.forward(q, cfg, b)
    torch.cuda.synchronize()
    assert sqm.splitquant_matmul.variant_launches[sqm.CUDA_CORE] == \
        before + 14                    # 2 layers x 6, the pooler, the head
    _close(got.cpu(), want, 1e-4)
    x = torch.randn((64, 128), generator=torch.Generator().manual_seed(1))
    lp, lpd = q["layers"][1]["ffn"], qd["layers"][1]["ffn"]
    _close(dense(x.to(dev), lpd["w_up"], lpd["b_up"]).cpu(),
           dense(x, lp["w_up"], lp["b_up"]), 1e-4)


@pytest.mark.parametrize("case", [{}, {"state_dtype": "bfloat16"},
                                  {"grad_compress": "int8",
                                   "clip_norm": None}])
def test_adamw_on_the_card_matches_the_cpu(dev, case):
    """AdamW's update on the card from the CPU's params, state and
    gradients (three bert-tiny steps, the gradients the CPU's): params
    within 1e-6 of each leaf's scale (bf16 states: 3 x lr x 2^-8, a bf16
    rounding of a moment), step counters equal."""
    from repro_torch.core.apply import tree_to
    from repro_torch.models import bert_tiny
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map
    cfg, params = _bert_small()
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3, **case)
    pc, oc_state = params, adamw.init(oc, params)
    pd, od_state = tree_to(params, dev), adamw.init(oc, tree_to(params, dev))
    for s in range(3):
        p = tree_map(lambda t: t.detach().requires_grad_(True), pc)
        loss, _ = bert_tiny.loss_fn(p, cfg, _bert_batch(cfg, seed=s))
        leaves = tree_leaves(p)
        by = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        g = tree_map(lambda t: by[id(t)], p)
        pc, oc_state, _ = adamw.update(oc, oc_state, pc, g)
        pd, od_state, m = adamw.update(oc, od_state, pd, tree_to(g, dev))
    assert int(od_state.step) == 3 and od_state.step.is_cuda
    atol = 3 * oc.lr * 2 ** -8 if case.get("state_dtype") else 0.0
    for a, b in zip(tree_leaves(pd), tree_leaves(pc)):
        err = float((a.cpu() - b).abs().max())
        assert err <= max(1e-6 * max(1.0, float(b.abs().max())), atol)


def test_static_act_quant_kernel_with_bert_tiny_scales(dev):
    """Scales calibrated by the port's ``collect_act_stats`` on bert-tiny
    (on the card; chunks of 128 / 3, uneven) feed the static act-quant
    kernel: codes equal its plain version's, and values inside each
    chunk's calibrated range come back within a step (the counterpart of
    the JAX package's tests/test_calib.py static-kernel test)."""
    from repro_torch.calib import act_static_scales, collect_act_stats
    from repro_torch.core.apply import tree_to
    cfg, params = _bert_small()
    b = _bert_batch(cfg)
    stats = collect_act_stats(cfg, tree_to(params, dev),
                              [{k: b[k] for k in ("tokens", "mask")}],
                              n_chunks=3)
    for site in ("attn_in", "ffn_in", "ffn_hidden"):
        scales = act_static_scales(stats)[site]
        s = torch.from_numpy(scales["scale"][0]).to(dev)
        z = torch.from_numpy(scales["zero"][0]).to(dev)
        width = 512 if site == "ffn_hidden" else 128
        x = torch.randn((256, width), generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        q = aq.act_split_quantize_static(x, s, z, bits=8)
        torch.cuda.synchronize()
        assert torch.equal(q.cpu(), aq.act_split_quantize_static(
            x.cpu(), s.cpu(), z.cpu(), bits=8))
        xd = aq.dequantize_act(q, s, z)
        bounds = activation_chunk_bounds(width, 3)
        cmin = stats.sites[site]["chunk_min"][0]
        cmax = stats.sites[site]["chunk_max"][0]
        for c, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            xc = x[:, lo:hi]
            inside = (xc >= float(cmin[c])) & (xc <= float(cmax[c]))
            assert bool(inside.any())
            err = (xd[:, lo:hi] - xc).abs()[inside]
            assert float(err.max()) <= 1.0 / float(s[c]) + 1e-5


def test_tiny_table1_card_matches_cpu(dev):
    """Table 1 at a tiny size: bert-tiny trained on the CPU, each
    (bits, method) quantized on the CPU and evaluated on the card and on
    the CPU: accuracies equal within one example of the 100 (the 8-bit
    activations' rounding ties)."""
    from repro_torch.core.apply import tree_to
    from repro_torch.launch import table1
    (name, tr, te), = table1.datasets(500, 0)[:1]
    cfg, params = table1.train_bert(tr, epochs=1, device="cpu")
    for bits in (2, 4, 8):
        for method in ("baseline", "splitquant"):
            q = table1.quantize(params, bits, method)
            for acts in (False, True):
                act_cfg, chunks = table1.act_quant(bits, method, acts)
                cpu = table1.evaluate(cfg, q, te, act_cfg=act_cfg,
                                      act_chunks=chunks)
                card = table1.evaluate(cfg, tree_to(q, dev), te,
                                       act_cfg=act_cfg, act_chunks=chunks)
                assert round(abs(card - cpu) * len(te.labels)) <= 1, \
                    (name, bits, method, acts, card, cpu)


# ------------------------------------------------------ griffin, whisper ---
def _griffin_small():
    """Reduced recurrentgemma-9b at 8 layers (2 groups of (rec, rec, attn)
    and 2 trailing recurrent layers, window 16), fp32, SplitQuant INT4
    k=3 built on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_params
    cfg = dataclasses.replace(get_arch("recurrentgemma-9b").reduced(),
                              n_layers=8)
    return cfg, build_params(cfg, bits=4, method="splitquant", seed=0,
                             device="cpu")[0]


@pytest.mark.parametrize("S", [12, 24])
def test_griffin_prefill_and_decode_card_match_cpu(dev, S):
    """griffin's prefill (within and past the 16-row window) and 3 decode
    steps writing the ring: logits and every part of the cache card ==
    CPU within 1e-4 of their scale (the conv taps dequantized on the
    card; the gates' fp32 products without TF32); ring positions exact."""
    from repro_torch.core.apply import tree_to
    from repro_torch.models import griffin
    cfg, params = _griffin_small()
    pd = tree_to(params, dev)
    toks = torch.from_numpy(np.random.default_rng(S).integers(
        0, cfg.vocab, (2, S + 3)))
    before = splitquant_matmul.launches
    with torch.no_grad():
        outs = []
        for p, d in ((params, "cpu"), (pd, dev)):
            lg, c = griffin.prefill(p, cfg, {"tokens": toks[:, :S].to(d)})
            steps = [lg]
            for i in range(3):
                lg, c = griffin.decode_step(p, cfg, c,
                                            toks[:, S + i:S + i + 1].to(d),
                                            S + i)
                steps.append(lg)
            outs.append((steps, c))
    torch.cuda.synchronize()
    assert splitquant_matmul.launches > before
    (want, wc), (got, gc) = outs
    for g, w in zip(got, want):
        _close(g.cpu(), w, 1e-4)
    for name, g, w in zip(griffin.GriffinCache._fields, gc, wc):
        if name == "attn_pos":
            assert torch.equal(g.cpu(), w)
        else:
            _close(g.cpu(), w, 1e-4)


def test_griffin_server_card_matches_cpu(dev):
    """The wave ``Server`` over reduced griffin: two left-padded waves of
    4, padded to 30 and 21 (past the window), 10 new tokens each: card
    tokens == CPU tokens."""
    from repro_torch.core.apply import tree_to
    from repro_torch.runtime.serve_loop import Request, Server, ServeConfig
    cfg, params = _griffin_small()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=n)
               for n in (30, 7, 18, 3, 21, 12, 17, 5)]
    outs = []
    for d, p in (("cpu", params), (dev, tree_to(params, dev))):
        srv = Server(cfg, p, ServeConfig(max_batch=4, max_new_tokens=10),
                     device=d)
        outs.append([r.out for r in srv.serve(
            [Request(i, pr) for i, pr in enumerate(prompts)])])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_griffin_rg_lru_and_conv_card_match_cpu(dev, dtype):
    """The RG-LRU's associative scan over T = 2100 (past the full window,
    odd at several levels) and the depthwise conv with a carry: card ==
    CPU (fp32: 1e-5 of the scale; bf16 inputs: 2e-2)."""
    from repro_torch.models import griffin
    g = torch.Generator().manual_seed(0)
    r = 64
    p = {"rg_lru_wa": torch.randn((r, r), generator=g) * 0.05,
         "rg_lru_ba": torch.zeros(r), "rg_lru_bx": torch.zeros(r),
         "rg_lru_wx": torch.randn((r, r), generator=g) * 0.05,
         "rg_lru_lambda": torch.full((r,), 2.0)}
    x = torch.randn((2, 2100, r), generator=g).to(dtype)
    h0 = torch.randn((2, r), generator=g)
    w, b = torch.randn((4, r), generator=g), torch.randn(r, generator=g)
    st = torch.randn((2, 3, r), generator=g).to(dtype)
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    want = (*griffin._rg_lru(p, x, h0), *griffin._causal_conv(x, w, b, st))
    got = (*griffin._rg_lru({k: v.to(dev) for k, v in p.items()}, x.to(dev),
                            h0.to(dev)),
           *griffin._causal_conv(x.to(dev), w.to(dev), b.to(dev),
                                 st.to(dev)))
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype
        _close(gt.cpu(), wt, rel)


def test_whisper_card_matches_cpu(dev):
    """Reduced whisper-tiny in fp32, INT4 weights and biases: ``encode``,
    the prefill's logits and 6 greedy decode steps: states and logits
    card == CPU within 1e-4 of their scale, tokens identical."""
    from repro_torch.configs import get_arch
    from repro_torch.core.apply import tree_to
    from repro_torch.core.splitquant import SplitQuantTensor
    from repro_torch.launch.serve import build_params
    from repro_torch.models import whisper
    cfg = get_arch("whisper-tiny").reduced()
    params, _ = build_params(cfg, bits=4, method="splitquant", seed=0,
                             device="cpu")
    assert isinstance(params["dec_layers"][0]["cross"]["bq"],
                      SplitQuantTensor)
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.standard_normal(
        (3, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 7)))
    outs = []
    with torch.no_grad():
        for d, p in (("cpu", params), (dev, tree_to(params, dev))):
            enc = whisper.encode(p, cfg, frames.to(d))
            lg, c = whisper.prefill(p, cfg, {"tokens": toks.to(d),
                                             "frames": frames.to(d)},
                                    max_len=14)
            logits, tok, out = [lg], lg[:, -1].argmax(-1), []
            for i in range(6):
                out.append(tok.tolist())
                lg, c = whisper.decode_step(p, cfg, c, tok[:, None], 7 + i)
                logits.append(lg)
                tok = lg[:, -1].argmax(-1)
            outs.append((enc, logits, out))
    (we, wl, wo), (ge, gl, go) = outs
    _close(ge.cpu(), we, 1e-4)
    for g, w in zip(gl, wl):
        _close(g.cpu(), w, 1e-4)
    assert go == wo


@pytest.mark.parametrize("M", [8, 1500])
def test_linear_with_a_quantized_bias_at_whisper_shapes(dev, M):
    """whisper-tiny's 384 -> 384 and 384 -> 1536 projections in bf16
    through ``dense`` with their quantized biases: card == the plain
    version plus the dequantized bias (2e-2 of the scale)."""
    from repro_torch.core.quantize import QuantConfig
    from repro_torch.core.splitquant import splitquant_tensor
    from repro_torch.kernels.ops import pack_for_kernel
    from repro_torch.models.common import dense
    g = torch.Generator().manual_seed(M)
    for K, N in ((384, 384), (384, 1536)):
        w = torch.randn((K, N), generator=g) * 0.05
        b = torch.randn(N, generator=g) * 0.1
        pw = pack_for_kernel(splitquant_tensor(g, w, QuantConfig(bits=4)))
        qb = splitquant_tensor(g, b, QuantConfig(bits=4))
        x = torch.randn((M, K), generator=g).to(torch.bfloat16)
        want = splitquant_matmul_ref(x, pw.qp, pw.cp, pw.recip, pw.shift,
                                     4) + qb.dequantize().to(torch.bfloat16)
        got = dense(x.to(dev), pw.to(dev), qb.to(dev))
        _close(got.cpu(), want, 2e-2)


def test_matmul_past_int32_outputs_runs_in_row_slabs(dev):
    """8400 x 256000 outputs (more than 2^31 - 1, as griffin_ring's
    prefill times the vocab head): two launches of whole-row slabs, the
    product equal to the plain version's (bf16: 2^-7 of the scale)."""
    g = torch.Generator(device=dev).manual_seed(0)
    M, K, N = 8400, 64, 256000
    qp, cp, recip, shift = _packed(g, K, N, 4, 3, dev)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    before = splitquant_matmul.launches
    got = splitquant_matmul(x, qp, cp, recip, shift, bits=4, k=3)
    torch.cuda.synchronize()
    assert splitquant_matmul.launches == before + 2
    for r0 in (0, 4200, 8000):          # row blocks of the plain version
        want = splitquant_matmul_ref(x[r0:r0 + 400], qp, cp, recip, shift,
                                     4)
        _close(got[r0:r0 + 400], want, 2 ** -7)
    assert bool(torch.isfinite(got).all())
