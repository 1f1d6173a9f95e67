"""The launch plan and the arithmetic of the port's redesigned chunked WKV
kernel and static act-quant kernel, on the CPU (no card, no CUDA):

- ``wkv_plan`` at the heads of one sequence (40), a wave of 8 (320) and
  more: the slabs cover every value column once, a block's shared memory
  fits the H100's 227 KB, and at BH >= 132 heads the busiest of the 132
  SMs holds within 1.1x of the mean number of blocks;
- a torch emulation of the WKV kernel's summation order (the two key
  halves of a cluster, att's key quads summed in lanes and reduced across
  them by the shuffle butterfly, the products over groups of eight keys
  and rows, y as block 0's share plus block 1's, the S update after the
  decay), held against the JAX package's ``wkv_chunked_jnp`` on seeded
  inputs: y within 1e-4 (fp32) / 2e-2 (bf16) of its scale, S within 1e-4,
  as the card's tests hold the kernel. The emulation sums in fp32 where
  the card's tensor cores sum split TF32 parts, so it checks the order
  and the blocking, not the rounding of the products;
- the static act-quant kernel's assignment of columns to threads (a head
  to the first 16-byte boundary, vectors of 8, a tail) and to chunks (from
  N // n_chunks and N % n_chunks, a vector straddling a boundary taking
  each column's own chunk) equals the JAX package's ``chunk_id_map`` for
  every width 1..300, every chunk count up to 8 and every start offset
  0..7 elements, in bf16 and fp32;
- the dynamic act-quant kernel's assignment of each (row, chunk)'s
  columns to the lanes of its warps (a scalar head to the chunk's first
  16-byte boundary, 16-byte vectors in rounds of ``dynamic_plan``'s
  lanes x vectors, a scalar tail) takes every column of every chunk
  exactly once, with aligned vector loads and one round unless the chunk
  outgrows eight warps, for every width 1..300 and chunk count up to 8,
  the serving widths and wider, at start offsets 0..7 elements.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.act_quant import chunk_id_map as j_chunk_id_map
from repro.kernels.wkv_chunked import wkv_chunked_jnp

from repro_torch.kernels.act_quant import DYN_MAX_WARPS, dynamic_plan
from repro_torch.kernels.wkv_chunked import (BLOCKS_PER_SLAB, CHUNK,
                                             MAX_SLAB, THREADS, wkv_plan)

SMS = 132                                   # H100 SXM
SMEM_LIMIT = 232448                         # 227 KB a block on an H100


# ---------------------------------------------------------------- plan ---
@pytest.mark.parametrize("K,V", [(16, 24), (32, 32), (64, 64), (128, 128)])
@pytest.mark.parametrize("BH", [8, 40, 320, 1280])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_wkv_plan_covers_columns_and_fits(BH, K, V, itemsize):
    p = wkv_plan(BH, K, V, SMS, itemsize)
    assert p.threads == THREADS
    assert 0 < p.vs <= min(V, MAX_SLAB)
    slabs = -(-V // p.vs)
    cover = np.zeros(V, dtype=int)
    for i in range(slabs):
        cover[i * p.vs:min((i + 1) * p.vs, V)] += 1
    assert (cover == 1).all()
    assert p.smem <= SMEM_LIMIT
    blocks = BLOCKS_PER_SLAB * BH * slabs
    if BH >= SMS:
        assert math.ceil(blocks / SMS) / (blocks / SMS) <= 1.1


def test_wkv_plan_prefers_fewest_blocks_on_the_busiest_sm():
    """One sequence of rwkv6-3b (40 heads) keeps the whole 64-column slab
    (80 blocks, one an SM) rather than cutting it; a wave (320) too."""
    assert wkv_plan(40, 64, 64, SMS).vs == 64
    assert wkv_plan(320, 64, 64, SMS).vs == 64
    assert wkv_plan(320, 128, 128, SMS).vs == 64


# ------------------------------------------------- WKV summation order ---
def _butterfly(x, bits):
    """Sum over the last axis (lanes) in the order of a shuffle
    reduce-scatter over lane bits ``bits`` (highest first): partners that
    differ in a bit add, so every lane ends with the same tree sum."""
    for b in bits:
        idx = torch.arange(x.shape[-1]) ^ (1 << b)
        x = x + x[..., idx]
    return x[..., 0]


def _emulate(r, k, v, w, u, s0, sms=SMS):
    """The kernel's order of summation, in fp32 on the CPU: the value
    slabs of ``wkv_plan`` one by one, each with the two key halves of its
    cluster."""
    BH, T, K = r.shape
    V = v.shape[-1]
    itemsize = 2 if r.dtype == torch.bfloat16 else 4
    vs = wkv_plan(BH, K, V, sms, itemsize).vs
    kh = 32 if K <= 64 else 64
    pad = lambda a, val=0.0: torch.nn.functional.pad(
        a.float(), (0, 2 * kh - K), value=val)
    rf, kf, wf, uf = pad(r), pad(k), pad(w, 1.0), pad(u)
    S0 = torch.zeros(BH, 2 * kh, V)
    if s0 is not None:
        S0[:, :K] = s0.float()
    y = torch.empty(BH, T, V)
    S = torch.empty(BH, 2 * kh, V)
    for j0 in range(0, V, vs):
        cols = slice(j0, min(j0 + vs, V))
        y[..., cols], S[..., cols] = _emulate_slab(
            rf, kf, wf, uf, v[..., cols].float(), S0[..., cols].clone(), kh)
    return y.to(r.dtype), S[:, :K]


def _emulate_slab(rf, kf, wf, uf, vf, S, kh):
    BH, T, _ = rf.shape
    lt = kh // 4                                    # lanes of an att tile
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    y = torch.empty(BH, T, vf.shape[-1])
    tril = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool), -1)
    eye = torch.eye(CHUNK, dtype=torch.bool)[None, :, :, None]
    for n in range(T // CHUNK):
        sl = slice(n * CHUNK, (n + 1) * CHUNK)
        lw = torch.log(torch.clamp(wf[:, sl], min=1e-30))
        c = torch.zeros_like(lw)
        acc = torch.zeros_like(lw[:, 0])
        for t in range(CHUNK):                      # the cumsum in order
            acc = acc + lw[:, t]
            c[:, t] = acc
        cp2 = (c - lw) * log2e
        c2 = c * log2e
        rn, kn, vn = rf[:, sl], kf[:, sl], vf[:, sl]
        rexp = rn * torch.exp2(cp2)
        kdec = kn * torch.exp2(c2[:, -1:] - c2)
        dec = torch.exp2(c2[:, -1])
        shares = []
        for blk in range(2):                        # the cluster's key halves
            ks = slice(blk * kh, (blk + 1) * kh)
            # att: each lane sums its four keys in order, then the lanes
            # of the tile reduce by the butterfly
            rq = rn[:, :, ks].reshape(BH, CHUNK, lt, 4)
            kq = kn[:, :, ks].reshape(BH, CHUNK, lt, 4)
            pq = cp2[:, :, ks].reshape(BH, CHUNK, lt, 4)
            cq = c2[:, :, ks].reshape(BH, CHUNK, lt, 4)
            uq = uf[:, ks].reshape(BH, 1, lt, 4)
            e = torch.exp2(pq[:, :, None] - cq[:, None])        # (BH,t,s,lt,4)
            terms = rq[:, :, None] * kq[:, None] * e
            diag = (rq * uq) * kq                               # (BH,t,lt,4)
            lane = torch.zeros(BH, CHUNK, CHUNK, lt)
            dl = torch.zeros(BH, CHUNK, lt)
            for j in range(4):
                lane = lane + torch.where(tril[None, :, :, None],
                                          terms[..., j], 0.0)
                dl = dl + diag[..., j]
            lane = torch.where(eye, dl[:, :, None, :], lane)
            att = _butterfly(lane, range(int(math.log2(lt)) - 1, -1, -1))
            # this block's share of y: S over key groups of eight, then
            # att·v over the two groups of eight rows s
            share = torch.zeros(BH, CHUNK, vf.shape[-1])
            for g8 in range(kh // 8):
                kk = slice(blk * kh + 8 * g8, blk * kh + 8 * g8 + 8)
                share = share + rexp[:, :, kk] @ S[:, kk]
            for s8 in range(2):
                ss = slice(8 * s8, 8 * s8 + 8)
                share = share + att[:, :, ss] @ vn[:, ss]
            shares.append(share)
            # S ← exp(c_last)·S + kdecᵀ·v over the two groups of rows t
            Sb = dec[:, ks, None] * S[:, ks]
            for t8 in range(2):
                tt = slice(8 * t8, 8 * t8 + 8)
                Sb = Sb + kdec[:, tt, ks].transpose(1, 2) @ vn[:, tt]
            S[:, ks] = Sb
        y[:, sl] = shares[0] + shares[1]            # block 0's share first
    return y, S


def _wkv_inputs(seed, BH, T, K, V, with_s0, zero_decay=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = f(BH, T, K), f(BH, T, K), f(BH, T, V)
    w = np.exp(-np.exp(f(BH, T, K) * 2 - 1)).astype(np.float32)
    if zero_decay:
        w = np.zeros_like(w)
    u = f(BH, K) * 0.5
    s0 = f(BH, K, V) if with_s0 else None
    return r, k, v, w, u, s0


WKV_CASES = [  # (BH, T, K, V, with_s0, zero_decay, dtype)
    (3, 48, 16, 24, False, False, torch.float32),
    (3, 48, 16, 24, True, False, torch.bfloat16),
    (2, 32, 32, 32, True, False, torch.float32),
    (2, 32, 64, 64, False, False, torch.float32),
    (2, 32, 64, 64, True, False, torch.bfloat16),
    (2, 32, 64, 64, True, True, torch.float32),
    (1, 16, 128, 128, True, False, torch.float32),
]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's chunked WKV on every case's inputs, through one
    jitted function (one trace a shape): bf16 inputs go in as their exact
    fp32 values and y is rounded to bf16 after, as the reference casts;
    a case without s0 passes zeros."""
    ref = jax.jit(wkv_chunked_jnp, static_argnums=5)
    out = {}
    for i, (BH, T, K, V, with_s0, zero, dtype) in enumerate(WKV_CASES):
        r, k, v, w, u, s0 = _wkv_inputs(i, BH, T, K, V, with_s0, zero)
        if dtype == torch.bfloat16:
            r, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                       for a in (r, k, v))
        if s0 is None:
            s0 = np.zeros((BH, K, V), np.float32)
        y, S = ref(*(jnp.asarray(a) for a in (r, k, v, w, u)), 16,
                   jnp.asarray(s0))
        y = torch.from_numpy(np.array(y)).to(dtype).float().numpy()
        out[i] = (y, np.asarray(S))
    return out


@pytest.mark.parametrize("case", range(len(WKV_CASES)))
def test_wkv_kernel_summation_order_matches_jax(jax_refs, case):
    BH, T, K, V, with_s0, zero, dtype = WKV_CASES[case]
    r, k, v, w, u, s0 = _wkv_inputs(case, BH, T, K, V, with_s0, zero)
    t = lambda a: torch.from_numpy(a)
    y, S = _emulate(t(r).to(dtype), t(k).to(dtype), t(v).to(dtype), t(w),
                    t(u), None if s0 is None else t(s0))
    y_ref, S_ref = jax_refs[case]
    assert bool(torch.isfinite(y.float()).all()) and \
        bool(torch.isfinite(S).all())
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    y_scale = max(1.0, float(np.abs(y_ref).max()))
    assert float(np.abs(y.float().numpy() - y_ref).max()) <= rel * y_scale
    S_scale = max(1.0, float(np.abs(S_ref).max()))
    assert float(np.abs(S.numpy() - S_ref).max()) <= 1e-4 * S_scale


# --------------------------------------------- static act-quant columns ---
def _static_columns(N, n_chunks, offset, itemsize):
    """The static act-quant kernel's column assignment, as the launcher and
    the kernel compute it: (chunk id per column, full slots' columns
    16-byte aligned?, full slots that store 8 bytes aligned?)."""
    mis = (offset * itemsize) % 16
    rows_aligned = (N * itemsize) % 16 == 0
    hd = min((16 - mis) % 16 // itemsize, N) if rows_aligned else 0
    nslots = (hd > 0) + -(-(N - hd) // 8)
    base, rem = divmod(N, n_chunks)
    wide = rem * (base + 1)
    ids = np.full(N, -1)
    aligned = True
    for slot in range(nslots):
        if hd > 0:
            c0 = 0 if slot == 0 else hd + 8 * (slot - 1)
            c1 = hd if slot == 0 else min(c0 + 8, N)
        else:
            c0, c1 = 8 * slot, min(8 * slot + 8, N)
        cid = c0 // (base + 1) if c0 < wide else rem + (c0 - wide) // base
        nxt = (cid + 1) * base + min(cid + 1, rem)
        for e in range(8):
            while c0 + e >= nxt and cid + 1 < n_chunks:
                cid += 1
                nxt = (cid + 1) * base + min(cid + 1, rem)
            if c0 + e < c1:
                assert ids[c0 + e] == -1, "a column taken twice"
                ids[c0 + e] = cid
        if c1 - c0 == 8 and rows_aligned:
            aligned &= (mis + c0 * itemsize) % 16 == 0
    return ids, aligned


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("widths", [range(1, 101), range(101, 201),
                                    range(201, 301)])
def test_static_act_quant_columns_match_jax_chunk_ids(widths, itemsize):
    for N in widths:
        for n_chunks in range(1, min(8, N) + 1):
            want = j_chunk_id_map(N, n_chunks)
            seen = set()
            for offset in range(8):
                mis = (offset * itemsize) % 16
                key = mis if (N * itemsize) % 16 == 0 else 0
                if key in seen:
                    continue
                seen.add(key)
                ids, aligned = _static_columns(N, n_chunks, offset, itemsize)
                assert (ids >= 0).all(), (N, n_chunks, offset)
                assert np.array_equal(ids, want), (N, n_chunks, offset)
                assert aligned, (N, n_chunks, offset)


# -------------------------------------------- dynamic act-quant columns ---
def _dynamic_columns(R, N, n_chunks, offset, itemsize):
    """Times each column of x (R, N) is taken by the dynamic act-quant
    kernel, as the kernel assigns them, for x starting ``offset``
    elements after a 256-byte boundary (q starts on one); checks each
    vector load's 16-byte alignment and returns (counts, rounds of the
    widest chunk, whether every code vector's store is aligned, warps a
    chunk)."""
    epv = 16 // itemsize
    cw = N // n_chunks
    warps, vecs = dynamic_plan(cw, itemsize)
    G = 32 * warps
    counts = np.zeros(R * N, np.int64)
    max_rounds, qvec_all = 0, True
    for row in range(R):
        for chunk in range(n_chunks):
            off = row * N + chunk * cw
            addr = (offset + off) * itemsize
            hd = min((16 - addr % 16) % 16 // itemsize, cw)
            nv = (cw - hd) // epv
            tl = cw - hd - nv * epv
            rounds = -(-nv // (G * vecs))
            max_rounds = max(max_rounds, rounds)
            gl = np.arange(G)
            ecol = np.where(gl < hd, gl,
                            np.where((gl >= epv) & (gl < epv + tl),
                                     hd + nv * epv + gl - epv, -1))
            np.add.at(counts, off + ecol[ecol >= 0], 1)
            k = np.arange(rounds * vecs)
            v = (gl[None, :] + G * k[:, None]).ravel()
            v = v[v < nv]
            assert ((addr + (hd + v * epv) * itemsize) % 16 == 0).all()
            cols = off + hd + v[:, None] * epv + np.arange(epv)[None, :]
            np.add.at(counts, cols.ravel(), 1)
            qvec_all &= nv == 0 or (off + hd) % epv == 0
    return counts, max_rounds, qvec_all, warps


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("widths", [range(1, 151), range(151, 301)])
def test_dynamic_act_quant_columns_cover_each_chunk_once(widths, itemsize):
    for N in widths:
        for n_chunks in (c for c in range(1, 9) if N % c == 0):
            for offset in (0, 1, 3, 7):
                counts, rounds, qvec, _ = _dynamic_columns(
                    2, N, n_chunks, offset, itemsize)
                assert (counts == 1).all(), (N, n_chunks, offset)
                assert rounds <= 1
                # q's code vectors are aligned whenever x starts aligned
                assert qvec or offset % (16 // itemsize), (N, n_chunks)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("N,n_chunks,offset", [
    (2560, 4, 0), (8960, 4, 0), (2562, 3, 0), (2562, 3, 1), (8960, 4, 3),
    (16384, 1, 0), (16392, 1, 5), (40000, 2, 1)])
def test_dynamic_act_quant_columns_at_serving_widths(N, n_chunks, offset,
                                                     itemsize):
    counts, rounds, _, warps = _dynamic_columns(3, N, n_chunks, offset,
                                                itemsize)
    assert (counts == 1).all()
    # one round (one read of x) unless the chunk outgrows eight warps of
    # eight vectors a lane
    assert rounds == 1 or warps == DYN_MAX_WARPS
    assert (rounds > 1) == (N == 40000 or (N >= 16384 and itemsize == 4))
