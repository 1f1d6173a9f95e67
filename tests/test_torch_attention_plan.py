"""The launch plans of the port's two attention kernels and their
split-and-merge arithmetic, on the CPU (no card).

- decode: ``decode_plan`` cuts T into whole 32-row tiles that cover it
  exactly, with no empty split, at every engine serving shape of
  stablelm-1.6b and chatglm3-6b, and splits T when the (slot, head) grid
  alone leaves the H100's 132 SMs underfilled; ``decode_attention_split_ref``
  (partials per split and warp, log-sum-exp merges in order: the kernel's
  arithmetic) matches the JAX package's ``decode_attention``
  (``use_pallas=False``), empty splits and an empty slot included.
- prefill: ``prefill_plan`` cuts the cache and the query rows the same
  way, the dtype picks the kernel variant, and
  ``prefill_attention_split_ref`` matches the plain version
  ``prefill_attention_ref`` (which ``tests/test_torch_kernels.py`` holds
  to JAX's ``prefill_attention``).
- the kernels' division-free dequantization (a correctly rounded
  reciprocal and one FMA correction) equals the true division
  (q - Z) / S for every code and every scale the cache can hold.

Tolerance: atol 1e-5, as ``tests/test_torch_kernels.py`` (fp32; only the
summation order differs).
"""
import functools
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.kvcache import quantize_kv as j_quantize_kv
from repro.kernels.decode_attention import decode_attention as j_decode

from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import prefill_attention as pa
from repro_torch.kernels.prefill_attention import quantize_kv_ref

SMS = 132                                   # H100 SXM
ATOL = 1e-5
ARCHS = ["stablelm-1.6b", "chatglm3-6b"]


def _heads(arch):
    cfg = get_arch(arch)
    return cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads


def _t(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------- decode plan ---
@pytest.mark.parametrize("T", [256, 1024, 4096])
@pytest.mark.parametrize("N", [1, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_plan_covers_T(arch, N, T):
    Hkv, G = _heads(arch)
    p = da.decode_plan(N, T, Hkv, G, SMS)
    assert G % p.group == 0 and p.group == da.head_group(G)
    assert p.rows % da.TILE_ROWS == 0
    ranges = [(lo, min(T, lo + p.rows)) for lo in range(0, T, p.rows)]
    assert len(ranges) == p.splits <= da.MAX_SPLITS
    assert all(lo < hi for lo, hi in ranges) and ranges[-1][1] == T
    assert 1 <= p.warps <= min(da.MAX_WARPS, p.rows // da.TILE_ROWS)


@pytest.mark.parametrize("T", [1024, 4096])
@pytest.mark.parametrize("N", [1, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_plan_splits_an_underfilled_grid(arch, N, T):
    """Fewer (slot, head group) blocks than SMs: T is split, into as many
    ranges as reach the SMs or into ranges of the shortest length the
    plan allows."""
    Hkv, G = _heads(arch)
    p = da.decode_plan(N, T, Hkv, G, SMS)
    blocks = N * Hkv * (G // p.group)
    if blocks < SMS:
        assert p.splits > 1
        assert blocks * p.splits >= SMS or \
            p.rows == da.MIN_SPLIT_TILES * da.TILE_ROWS


def test_head_groups():
    assert [da.head_group(g) for g in (1, 2, 3, 4, 8, 12, 16, 32)] == \
        [1, 1, 1, 4, 4, 4, 16, 16]


# ------------------------------------------------- decode split and merge ---
DEC = dict(N=4, T=100, Hq=8, Hkv=2, D=32)


@functools.lru_cache(maxsize=None)
def _decode_case(mode):
    """Slot 0 nearly full, slot 1 with its only valid rows in the last
    32 rows (every other split of it empty), slot 2 empty, slot 3 with a
    stale row past q_pos; the JAX output beside the inputs."""
    N, T, Hq, Hkv, D = DEC.values()
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(N, Hq, D), f(N, T, Hkv, D), f(N, T, Hkv, D)
    kv_pos = np.full((N, T), -1, np.int32)
    kv_pos[0, :T - 7] = np.arange(T - 7)
    kv_pos[1, T - 3:] = np.arange(3)
    kv_pos[3, :40] = np.arange(40)
    kv_pos[3, 2] = 99                         # written but past q_pos
    q_pos = np.array([T - 8, 5, 0, 39], np.int32)
    J = jnp.asarray
    if mode == "int8":
        qk, ks, kz = j_quantize_kv(J(k), 4)
        qv, vs, vz = j_quantize_kv(J(v), 4)
        want = j_decode(J(q), qk, qv, J(kv_pos), J(q_pos), k_scale=ks,
                        k_zero=kz, v_scale=vs, v_zero=vz, mode="int8",
                        use_pallas=False)
        args = (q, qk, qv, kv_pos, q_pos, ks, kz, vs, vz)
    else:
        want = j_decode(J(q), J(k), J(v), J(kv_pos), J(q_pos), mode="fp",
                        use_pallas=False)
        args = (q, k, v, kv_pos, q_pos)
    return [_t(a) for a in args], np.asarray(want)


#: hand-made plans over T=100 (four 32-row tiles, the last one ragged):
#: one split per tile, two splits of two warps, one split of four warps
DECODE_PLANS = [da.DecodePlan(4, 4, 32, 1), da.DecodePlan(4, 2, 64, 2),
                da.DecodePlan(4, 1, 128, 4)]


@pytest.mark.parametrize("plan", DECODE_PLANS + [
    da.decode_plan(DEC["N"], DEC["T"], DEC["Hkv"], 4, SMS)],
    ids=["4x32", "2x64", "1x128", "planned"])
@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_decode_split_ref_matches_jax(mode, plan):
    args, want = _decode_case(mode)
    got = da.decode_attention_split_ref(*args, plan=plan)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.all(got.numpy()[2] == 0.0)          # empty slot: exact 0


def test_merge_skips_empty_partials():
    """An empty partial (sum 0, max -inf) weighs nothing, wherever it
    stands in the order."""
    m = torch.tensor([0.5]), torch.tensor([da.NEG_INF]), torch.tensor([2.0])
    l = torch.tensor([3.0]), torch.tensor([0.0]), torch.tensor([1.5])
    acc = torch.ones(1, 4), torch.zeros(1, 4), torch.full((1, 4), 2.0)
    M, L, A = da.merge_partials(m, l, acc)
    e = torch.exp(torch.tensor([0.5 - 2.0]))
    assert torch.allclose(M, torch.tensor([2.0]))
    assert torch.allclose(L, 3.0 * e + 1.5)
    assert torch.allclose(A, (e + 2.0).expand(1, 4))


# ---------------------------------------------------------- prefill plan ---
#: (T, pos_start) of a chunk in a slot: empty, one row, mid-tile, the
#: smoke run's 384, and deep into the slot
PREFILL_POSITIONS = [(T, p) for T in (256, 1024, 4096)
                     for p in (0, 1, 37, 159, 384, 900, T - 96) if p <= T - 96]


@pytest.mark.parametrize("Sq", [1, 96])
@pytest.mark.parametrize("T,pos_start", PREFILL_POSITIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plan_covers_cache_and_queries(arch, T, pos_start, Sq):
    Hkv, G = _heads(arch)
    p = pa.prefill_plan(Sq, T, Hkv, G, pos_start, SMS)
    # query blocks of bq queries x G heads = 64 rows tile [0, Sq)
    assert p.bq * G == pa.Q_ROWS
    qblocks = -(-Sq // p.bq)
    assert (qblocks - 1) * p.bq < Sq <= qblocks * p.bq
    # cache ranges tile [0, T) in order, none empty, whole 64-row tiles
    assert p.cache_rows % pa.KV_TILE == 0
    assert 2 <= p.splits <= pa.MAX_SPLITS
    ranges = [p.cache_range(s, T) for s in range(p.cache_splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges)
    # only the range that holds the slot's earlier rows is split
    assert all(lo < max(pos_start, 1) for lo, _ in ranges)


@pytest.mark.parametrize("Sq", [1, 96])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plan_splits_an_underfilled_grid(arch, Sq):
    """A chunk at pos_start 384 of a 1024-row slot: the cache walk is cut
    across blocks, toward two blocks per SM."""
    Hkv, G = _heads(arch)
    p = pa.prefill_plan(Sq, 1024, Hkv, G, 384, SMS)
    blocks = -(-Sq // p.bq) * Hkv
    assert p.cache_splits > 1
    assert blocks * p.splits >= min(SMS, blocks * (384 // pa.KV_TILE + 1))


def test_prefill_plan_rejects_wide_groups():
    with pytest.raises(ValueError):
        pa.prefill_plan(96, 1024, 1, 128, 384, SMS)


@pytest.mark.parametrize("dtype,variant", [
    (torch.bfloat16, pa.TENSOR_CORE), (torch.float32, pa.CUDA_CORE)])
def test_dtype_picks_the_prefill_variant(dtype, variant):
    assert pa.prefill_variant(dtype) == variant


def test_prefill_variant_rejects_other_dtypes():
    with pytest.raises(TypeError):
        pa.prefill_variant(torch.float16)


# ------------------------------------------------ prefill split and merge ---
PRE = dict(T=300, Sq=37, Hq=8, Hkv=2, D=32, length=21)


def _prefill_case(mode, pos_start):
    """A 300-row cache whose live rows end mid-tile, the parked garbage
    row at pos_start (masked), a stale row at T-2 holding position 3
    (valid); Sq = 37 (no multiple of 16 or 64) with length 21 < Sq."""
    T, Sq, Hq, Hkv, D, length = PRE.values()
    rng = np.random.default_rng(7 + pos_start)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    q, k_new, v_new = f(Sq, Hq, D), f(Sq, Hkv, D), f(Sq, Hkv, D)
    ck, cv = f(T, Hkv, D), f(T, Hkv, D)
    kv_pos = torch.full((T,), -1, dtype=torch.int32)
    kv_pos[:pos_start] = torch.arange(pos_start)
    kv_pos[pos_start] = pos_start
    if pos_start:
        kv_pos[T - 2] = 3
    scales = ()
    if mode == "int8":
        ck, ks, kz = quantize_kv_ref(ck, 4)
        cv, vs, vz = quantize_kv_ref(cv, 4)
        scales = (ks, kz, vs, vz)
    return (q, k_new, v_new, ck, cv, kv_pos), scales


#: hand-made plans over T=300: three ranges (the last one running on to
#: T), two, and one
PREFILL_PLANS = [pa.PrefillPlan(16, 64, 3), pa.PrefillPlan(16, 128, 2),
                 pa.PrefillPlan(16, 320, 1)]


@pytest.mark.parametrize("plan", PREFILL_PLANS + [
    pa.prefill_plan(PRE["Sq"], PRE["T"], PRE["Hkv"], 4, 150, SMS)],
    ids=["3x64", "2x128", "1x320", "planned"])
@pytest.mark.parametrize("pos_start", [0, 150])
@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_prefill_split_ref_matches_plain(mode, pos_start, plan):
    """Against the plain version, which ``tests/test_torch_kernels.py``
    holds to the JAX package's ``prefill_attention`` on inputs of this
    kind (parked and stale rows, length < Sq)."""
    args, scales = _prefill_case(mode, pos_start)
    want = pa.prefill_attention_ref(*args, pos_start, PRE["length"],
                                    *scales)
    got = pa.prefill_attention_split_ref(*args, pos_start, PRE["length"],
                                         *scales, plan=plan)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


# --------------------------------------------- division-free dequantizing ---
def _rn32(fr: Fraction) -> np.float32:
    """A rational rounded to the nearest float32, ties to even."""
    c = np.float32(float(fr))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))):
        key = (abs(Fraction(float(cand)) - fr),
               int(cand.view(np.uint32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def _dequant_rcp(x, s):
    """rt::dequant_kv_rcp on float32 x = q - Z and s, each rounding as the
    card's: inv = RN(1/s), q0 = RN(x * inv), r = RN(x - q0 * s) (one FMA),
    RN(q0 + r * inv) (one FMA). x * inv and q0 * s are exact in float64;
    the two fused roundings are done on exact rationals."""
    inv = np.float32(1.0) / s
    q0 = np.float32(x * inv)
    r = _rn32(Fraction(float(x)) - Fraction(float(q0)) * Fraction(float(s)))
    return _rn32(Fraction(float(q0)) + Fraction(float(r)) *
                 Fraction(float(inv)))


@pytest.mark.parametrize("seed", [0, 1])
def test_reciprocal_dequant_equals_true_division(seed):
    """Scales from quantize_kv over data spanning 1e-4..1e4, degenerate
    chunks (S = 1/|amax|, S = 1) included; codes across the int8 range."""
    rng = np.random.default_rng(seed)
    mag = np.exp(rng.uniform(np.log(1e-4), np.log(1e4), (64, 1, 1)))
    x = (rng.standard_normal((64, 2, 32)) * mag).astype(np.float32)
    x[0, 0, :8] = 0.0                             # S = 1
    x[1, 1, 8:16] = np.float32(-3.7e-3)           # S = 1 / |amax|
    _, scale, zero = quantize_kv_ref(torch.from_numpy(x), 4)
    S = scale.numpy().ravel()
    Z = zero.numpy().ravel()
    codes = np.arange(-128, 128, 37, dtype=np.float32)
    for s, z in zip(S[::3], Z[::3]):
        for c in codes:
            xz = np.float32(c - z)
            assert _dequant_rcp(xz, s) == np.float32(xz / s), (c, s, z)
