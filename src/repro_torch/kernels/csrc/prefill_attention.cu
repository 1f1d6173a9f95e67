// Fused chunked-prefill attention over one slot's KV cache for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/prefill_attention.py
// (_prefill_kernel, pallas_call at :299; entry prefill_attention at
// :407) in all its modes: fp, int8 per-entry (dynamic) and int8 static,
// each plain or as the speculative verify pass. One prompt chunk
// of Sq queries attends (a) the slot's cache rows that were written
// before the chunk (valid iff 0 <= kv_pos < pos_start; INT8 codes are
// dequantized per sub-channel chunk as (q - Z) / S) and (b) the chunk's
// own full-precision K/V under the causal mask key <= query and
// key < length, with one online softmax across both.
//
// What bounds it: every live cache row (D code bytes plus 2*C fp32
// scales for each of K and V) is used by the Sq*G queries of its
// kv-head, 4*Sq*G*D flops for K and V together. At Sq = 96, G = 1,
// D = 64, C = 4 that is ~128 flops per byte, below the ~295 flop/byte
// ridge of the bf16 tensor cores, so the card's bound is the bytes
// (0.0014 ms for stablelm-1.6b at pos_start 384).
//
// bf16 q: prefill_tc_kernel, FlashAttention-2's shape on the tensor
// cores. A block of four warps owns 64 query rows of one head group
// (Bq = 64 / G queries x G heads, row r <-> query r / G, head r % G), so
// K/V are read once per group and never broadcast to Hq; each warp owns
// 16 rows. The key range is cut across blocks as well (grid: query
// blocks x kv-heads x splits; prefill_plan in prefill_attention.py): the
// cache rows before pos_start in `cache_splits` ranges, the last one also
// scanning the rest of T, and the chunk's own keys as one more split, so
// the grid fills the SMs (256 blocks for stablelm-1.6b, 192 for
// chatglm3-6b). A block walks its range in tiles of 64 keys: 16-byte
// cp.async (4-byte for the scales) into a double-buffered raw ring; a
// tile with no live row is skipped without loading its codes; each live
// tile is dequantized ONCE into bf16 K and V tiles in shared memory (row
// pitch D + 8, so ldmatrix reads them without bank conflicts).
// S = Q.K^T and O += P.V are mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), fragments by ldmatrix (V transposed by ldmatrix.trans);
// the online softmax runs in registers and P goes from the score
// registers into the A operand of P.V without touching shared memory.
// The positions of the whole range are read once up front (four loads a
// thread in flight) into a live flag per tile. Dequantization reads a code as a float by one byte
// permute and one exact subtraction (rt::code_f), takes the correctly
// rounded 1/S once per four codes and corrects (q - Z) * (1/S) by one FMA
// (rt::dequant_kv_rcp), the rounding of a true division, before the bf16
// rounding.
// Each split writes an fp32 partial (acc, max, sum); the last block of a
// (query block, kv-head) to finish (a __threadfence and an atomic counter
// that the block sets back to 0) merges the partials by log-sum-exp in
// split order: one launch, and two calls give bit-identical output.
// mma.sync rather than wgmma: a warp owns 16 rows, so Bq*G = 64 rows fill
// one block at every G, and the 96-row chunk needs no 64-row multiple; P
// stays in the registers of the warp that computed it. The kernel is
// bound by bytes and latency, not by the tensor-core rate wgmma adds.
// Rounding points against the fp32 plain version: the dequantized K and
// V (fp32 (q - Z) / S, then rounded to bf16), P rounded to bf16, the
// 1/sqrt(D) scale applied to S in fp32 (the plain version scales q), fp32
// accumulation in the tensor cores' order, and the output to bf16.
//
// fp32 q: prefill_fp32_kernel, on the CUDA cores (the tensor cores would
// make it TF32 and could change the fp32 cross-check's tokens). One block
// per (32-query block, kv-head) walks the cache in chunks of 32 rows,
// skipping chunks with no valid row after one syncthreads_or,
// dequantizes each live K chunk into shared memory, forms R x 32 scores,
// updates the running max and sum with one warp per query row (lane =
// key row), then streams the V chunk through the same buffer; the
// chunk's own K/V follow through the same loop with the causal mask.
//
// Epilogue: the chunk's K/V codes are not this file's work. The engine
// writes the chunk into the slot's rows first, with one kv_write launch
// (csrc/kv_write.cu: K and V quantized together, codes, per-entry scales
// and kv_pos stored in place), and attends after: every path counts a
// cache row only where 0 <= kv_pos < pos_start, and the chunk's rows hold
// positions at or past pos_start (or -1). The wrapper's standalone
// contract, which returns the chunk's codes, launches the same kernel
// through quantize_kv / quantize_kv_static.
//
// Static scales (`stat`, per_entry_scales=False at :109-122, :288): S and
// Z are per-layer (Hkv, C) constants. The tensor-core block reads its
// kv-head's 4 x C values once into shared memory and copies no scale row
// per cache row; the CUDA-core kernel indexes them by head and chunk.
// Codes dequantize as (q - Z) / S, as _dequant_cols does on the chunk's
// per-column expansion of the same constants.
//
// Verify mode (`verify`, :200-216, jnp twin :383-396): the window of
// spec_k + 1 draft tokens attends its own K/V through the storage round
// trip, so each row scores what a plain decode step would. Its codes
// (and per-entry scales) are those the engine's kv_write has just stored
// in the slot's rows [pos_start, pos_start + Sq): wk..wvz point there (the
// standalone contract quantizes the window into buffers of its own), and
// the chunk's split walks them through the same dequantization as the
// cache rows, under the causal and key < length masks. Keys at or past
// `length` are never loaded (a window padded past T would read beyond
// the slot). Over an fp32 cache the round trip is a cast to fp32, exact
// for fp32 and bf16 K/V: the fp kernel as it is. Over a bf16 cache it is
// kn.astype(bf16).astype(f32) (:218-219): exact for bf16 K/V (the
// tensor-core kernel's), a rounding to nearest even for the CUDA-core
// kernel's fp32 K/V, which it applies where it loads the window.
//
// bf16 cache (fp mode; the JAX engine's kv_dtype="bfloat16", read and
// cast to fp32 at :187-189): one more cache type of both kernels. The
// tensor-core kernel's raw stage holds the bf16 rows as they lie in the
// cache and copies them into its bf16 K and V tiles unchanged, with no
// dequantization and no rounding (an fp32 cache is rounded to bf16
// there); the CUDA-core kernel widens each value to fp32 exactly
// (load_cache).
//
// float16 cache (kv_dtype="float16"): one more cache type of both
// kernels. The tensor-core kernel's raw stage holds the float16 rows (D
// * 2 bytes, the bf16 pitch) and widens each value exactly before its
// bf16 rounding into the K and V tiles, as it does an fp32 cache's; the
// CUDA-core kernel widens each value exactly. A verify window attends
// its K/V through the float16 round trip (kn.astype(float16) back to
// fp32, :218-219): the tensor-core kernel rounds the window's bf16
// values to float16 and back where it copies them into its tiles, the
// CUDA-core kernel where it loads them.
//
// What holds it back (PERF.md, from clock64 stamps per phase on the H100
// at stablelm-1.6b's and chatglm3-6b's Sq = 96 chunk): a block's two live
// tiles each cost about as much to dequantize into bf16 (the 64 x D codes
// of K and V, every block of a GQA group again) as to run through the
// tensor cores and the softmax, and the last block's merge of the four
// partials takes as long as one block's whole walk. Shared memory rows
// are padded to D + 8 bf16 rather than swizzled: ldmatrix reads 8 rows of
// 16 bytes at a 16-byte offset each, the same conflict-free pattern.
//
// head_dim 112 (kimi-k2-1t-a32b, G = 8: 8 queries x 8 heads a block):
// TcGeo<112> gives KD = 7 k16 steps of Q.K and ND = 14 n8 tiles of P.V;
// the padded row pitch of 120 bf16 (240 bytes) still puts ldmatrix's 8
// rows on distinct banks; a raw row of 7, 14 or 28 pieces of 16 bytes
// (int8, bf16, fp32) is copied piece by piece in turn; a sub-channel
// chunk of 28 columns straddles k16 fragments, so the dequantization
// takes each 4-column group's own chunk scale ((d * cl_mul) >> 16).
// The fp32-q kernel takes any D already.
//
// head_dim 256 (paligemma-3b, MQA 8/1: 8 queries x 8 heads a block;
// sub-channel chunks of 64): at 64 keys a tile the two raw stages of an
// fp32 cache alone are 256 KB, and a warp's O (ND = 32 n8 tiles x 4 =
// 128 fp32 registers a thread) beside KD = 16 k16 steps of Q fragments
// held in registers (64 more) and 64 keys of scores would spill. So
// TcGeo<256> takes tiles of KT = 32 keys (the splits stay whole 64-row
// ranges of prefill_plan) and keeps the block's 64 Q rows in shared
// memory (pitch D + 8, as K and V), read by ldmatrix one k16 step at a
// time: O, 16 score registers and one Q fragment stay in registers. A
// block then takes 137 KB over an int8 cache (two stages of 32 rows of
// codes and scales), 199 KB over an fp32 one.
//
// Registers, spills and the bytes a block takes at the serving shapes are
// printed by chip_smoke.py (PERF.md): two blocks an SM at both serving
// head layouts.
#include "common.cuh"
#include "sm90.cuh"

#include <type_traits>

namespace {

// ------------------------------------------------- fp32 q, CUDA cores ---
constexpr int TC = 32;
constexpr int THREADS = 256;

template <typename KV>
__device__ __forceinline__ float load_cache(const KV* p, size_t i, const float* s,
                                            const float* z, size_t si) {
  return rt::to_f(p[i]);
}
template <>
__device__ __forceinline__ float load_cache<int8_t>(const int8_t* p, size_t i,
                                                    const float* s, const float* z,
                                                    size_t si) {
  return rt::dequant_kv(p[i], s[si], z[si]);
}

// shared-memory layout of one block
struct Smem {
  float *qs, *acc, *kvs, *S, *m_run, *l_run, *corr;
  int* valid;
  __device__ Smem(float* base, int R, int D) {
    qs = base;
    acc = qs + R * D;
    kvs = acc + R * D;
    S = kvs + TC * (D + 1);
    m_run = S + R * TC;
    l_run = m_run + R;
    corr = l_run + R;
    valid = (int*)(corr + R);
  }
};

// One online-softmax update over a TC-row K/V chunk already validated;
// `row_ok(r, t)` gives the per-(query row, key row) validity.
template <typename LoadK, typename LoadV, typename Valid>
__device__ __forceinline__ void chunk_update(Smem& sm, int R, int D, LoadK load_k,
                                             LoadV load_v, Valid row_ok) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = blockDim.x / 32, DP = D + 1;
  for (int i = tid; i < TC * D; i += blockDim.x) sm.kvs[(i / D) * DP + i % D] = load_k(i / D, i % D);
  __syncthreads();
  for (int i = tid; i < R * TC; i += blockDim.x) {
    const int r = i / TC, t = i % TC;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(sm.qs[r * D + d], sm.kvs[t * DP + d], s);
    sm.S[i] = row_ok(r, t) ? s : rt::NEG_INF;
  }
  __syncthreads();
  for (int r = warp; r < R; r += nwarps) {
    const float s = sm.S[r * TC + lane];
    const float m_new = fmaxf(sm.m_run[r], rt::warp_max(s));
    const float p = row_ok(r, lane) ? expf(s - m_new) : 0.f;
    sm.S[r * TC + lane] = p;
    const float sum = rt::warp_sum(p);
    if (lane == 0) {
      const float c = expf(sm.m_run[r] - m_new);
      sm.corr[r] = c;
      sm.l_run[r] = sm.l_run[r] * c + sum;
      sm.m_run[r] = m_new;
    }
  }
  __syncthreads();
  for (int i = tid; i < TC * D; i += blockDim.x) sm.kvs[(i / D) * DP + i % D] = load_v(i / D, i % D);
  __syncthreads();
  for (int i = tid; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    float a = 0.f;
    for (int t = 0; t < TC; ++t) a = fmaf(sm.S[r * TC + t], sm.kvs[t * DP + d], a);
    sm.acc[i] = sm.acc[i] * sm.corr[r] + a;
  }
  __syncthreads();
}

// Scale operands of the int8 modes: the cache's (per-entry (T, Hkv, C) or
// static (Hkv, C)) and, in verify mode, the window's codes and scales
// (per-entry (Sq, Hkv, C), or the same static constants).
struct Int8Ops {
  const float *ks, *kz, *vs, *vz;
  const int8_t *wk, *wv;
  const float *wks, *wkz, *wvs, *wvz;
  int stat, verify;
};

// A float rounded to bf16 (nearest even) and widened back: the verify
// window's storage round trip over a bf16 cache.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// The same over a float16 cache.
__device__ __forceinline__ float round_f16(float x) {
  return __half2float(__float2half_rn(x));
}

template <typename KV, typename X>
__global__ void __launch_bounds__(THREADS)
prefill_fp32_kernel(const X* __restrict__ q, const X* __restrict__ kn,
               const X* __restrict__ vn, const KV* __restrict__ ck,
               const KV* __restrict__ cv, const int* __restrict__ kv_pos,
               Int8Ops s8, X* __restrict__ o, int Sq, int T, int Hq, int Hkv,
               int D, int C, int Bq, int pos_start, int length, float qscale) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv, R = Bq * G;
  const int qb = blockIdx.x, h = blockIdx.y;
  const int q0 = qb * Bq;
  const int tid = threadIdx.x;
  const int cl = D / max(C, 1);
  Smem sm(smem, R, D);

  // row r ↔ (query q0 + r / G, head h*G + r % G)
  for (int i = tid; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r / G;
    const float val = qi < Sq ? rt::to_f(q[((size_t)qi * Hq + h * G + r % G) * D + d]) : 0.f;
    sm.qs[i] = __fmul_rn(val, qscale);
    sm.acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    sm.m_run[r] = rt::NEG_INF;
    sm.l_run[r] = 0.f;
  }
  __syncthreads();

  // (a) the slot's cache rows written before the chunk
  for (int t0 = 0; t0 < T; t0 += TC) {
    int any = 0;
    if (tid < TC) {
      const int t = t0 + tid;
      const int p = t < T ? kv_pos[t] : -1;
      sm.valid[tid] = (p >= 0) && (p < pos_start);
      any = sm.valid[tid];
    }
    if (!__syncthreads_or(any)) continue;
    const int stat = s8.stat;
    auto load = [&](const KV* base, const float* s, const float* z) {
      return [=](int t, int d) {
        if (t0 + t >= T) return 0.f;
        const size_t row = (size_t)(t0 + t) * Hkv + h;
        return load_cache<KV>(base, row * D + d, s, z,
                              (stat ? (size_t)h : row) * C + d / cl);
      };
    };
    int* valid = sm.valid;
    chunk_update(sm, R, D, load(ck, s8.ks, s8.kz), load(cv, s8.vs, s8.vz),
                 [=](int r, int t) { return valid[t] != 0; });
  }

  // (b) the chunk's own K/V, causal and < length
  const int q_last = min(Sq, q0 + Bq) - 1;
  // (verify over an int8 cache: the window's codes, dequantized)
  const bool v8 = std::is_same<KV, int8_t>::value && s8.verify;
  // (verify over a 16-bit cache: the window's K/V rounded to its type)
  const bool v16 = std::is_same<KV, __nv_bfloat16>::value && s8.verify;
  const bool vh = std::is_same<KV, __half>::value && s8.verify;
  // keys at or past `length` are masked and never loaded: in verify mode
  // the window's codes may be the slot's own rows, which end at T
  const int kend = min(Sq, length);
  for (int t0 = 0; t0 < kend && t0 <= q_last; t0 += TC) {
    const int stat = s8.stat;
    auto load = [&](const X* base, const int8_t* codes, const float* s,
                    const float* z) {
      return [=](int t, int d) {
        if (t0 + t >= kend) return 0.f;
        const size_t row = (size_t)(t0 + t) * Hkv + h;
        if (v8)
          return rt::dequant_kv(codes[row * D + d], s[(stat ? (size_t)h : row) * C + d / cl],
                                z[(stat ? (size_t)h : row) * C + d / cl]);
        const float x = rt::to_f(base[row * D + d]);
        return v16 ? round_bf16(x) : vh ? round_f16(x) : x;
      };
    };
    chunk_update(sm, R, D, load(kn, s8.wk, s8.wks, s8.wkz),
                 load(vn, s8.wv, s8.wvs, s8.wvz), [=](int r, int t) {
      const int key = t0 + t, qi = q0 + r / G;
      return key <= qi && key < length && key < Sq;
    });
  }

  for (int i = tid; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r / G;
    if (qi >= Sq) continue;
    const float l = sm.l_run[r];
    const float out = l > 0.f ? sm.acc[i] / fmaxf(l, 1e-30f) : 0.f;
    o[((size_t)qi * Hq + h * G + r % G) * D + d] = rt::from_f<X>(out);
  }
}

// ------------------------------------------------ bf16 q, tensor cores ---
constexpr int QROWS = 64;     // query rows (queries x heads of the group) per block
constexpr int PLAN_TILE = 64; // prefill_plan cuts the cache in ranges of 64-row tiles
constexpr int TC_THREADS = 128;
constexpr int SMEM_MAX = 232448;

struct PArgs {
  const __nv_bfloat16 *q, *kn, *vn;
  const void *ck, *cv;
  const int* kv_pos;
  Int8Ops s8;
  __nv_bfloat16* o;
  float* part_o;   // (splits, Sq, Hq, D)
  float* part_ml;  // (splits, Sq, Hq, 2): running max, sum
  int* counter;    // (query blocks, Hkv), 0 between calls
  int Sq, T, Hq, Hkv, C, cl_mul, pos_start, length, bq, cache_rows,
      cache_splits;   // chunk of column d: (d * cl_mul) >> 16
  float qscale;
};

// Shared memory of one block, in bytes: the dequantized bf16 K and V
// tiles (row pitch D + 8 elements: ldmatrix rows on distinct banks; after
// the walk, the merge's weights), at D = 256 the block's Q rows (QS, the
// same pitch), the row-valid flags of two tiles, a ring of two raw stages
// (K rows, V rows in the cache's type or bf16, then the four scale arrays
// of the tile), and one live flag per tile. KT keys a tile: 64, or 32 at
// D = 256 (above).
template <int D>
struct TcGeo {
  static constexpr int KT = D > 128 ? 32 : 64;
  static constexpr bool QS = D > 128;
  static constexpr int BP = D + 8;
  static constexpr int KB = 0;
  static constexpr int VB = KT * BP * 2;
  static constexpr int QB = 2 * KT * BP * 2;
  static constexpr int RV = QB + (QS ? QROWS * BP * 2 : 0);
  static constexpr int RING = RV + 2 * KT * 4;
  __host__ __device__ static int rb(int kv_bytes) { return D * (kv_bytes > 2 ? kv_bytes : 2); }
  __host__ __device__ static int stage(int kv_bytes, int C) {
    return 2 * KT * rb(kv_bytes) + 4 * KT * C * 4;
  }
  __host__ __device__ static int tiles(int T) { return (T + KT - 1) / KT; }
  __host__ __device__ static int bytes(int kv_bytes, int C, int T) {
    return RING + 2 * stage(kv_bytes, C) + tiles(T) * 4;
  }
};
// Splits at most: the merge's weights of 64 rows fit in the K and V tiles.
constexpr int MAX_SPLITS = 16;

// STAT: static per-layer scales (int8 only), a template parameter so
// that the dynamic mode's dequantization loop indexes its per-row scales
// as before (a runtime choice there cost the dynamic kernel 3-7%).
template <int D, typename KV, bool STAT>
__global__ void __launch_bounds__(TC_THREADS)
prefill_tc_kernel(PArgs a) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr bool KV16 = std::is_same<KV, __nv_bfloat16>::value;
  constexpr bool KVH = std::is_same<KV, __half>::value;
  using G_ = TcGeo<D>;
  constexpr int BP = G_::BP, KD = D / 16, ND = D / 8, KT = G_::KT, NT = KT / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  __shared__ int last_block;
  __nv_bfloat16* Kb = (__nv_bfloat16*)(smem + G_::KB);
  __nv_bfloat16* Vb = (__nv_bfloat16*)(smem + G_::VB);
  int* rv = (int*)(smem + G_::RV);                     // [2][KT]
  const int C = a.C, G = a.Hq / a.Hkv;
  const int rbc = D * (int)sizeof(KV);                 // cache row bytes
  const int RB = G_::rb((int)sizeof(KV));              // raw row pitch
  const int STAGE = G_::stage((int)sizeof(KV), C);
  const int qb = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int q0 = qb * a.bq, nrows = a.bq * G;
  const bool chunk = s == a.cache_splits;              // the chunk's own keys
  // the chunk's keys as codes (verify over an int8 cache), else as bf16
  const bool chunk8 = chunk && INT8 && a.s8.verify;
  const bool raw16 = chunk && !chunk8;
  // (verify over a float16 cache: the window through the float16 round trip)
  const bool chunkh = chunk && KVH && a.s8.verify;
  __shared__ float stab[STAT ? D : 1];                 // static S, Z of K, V: [4][C]

  // this lane's two query rows: block row warp*16 + gid (+8)
  int qi[2], hq[2];
  bool rok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = warp * 16 + gid + 8 * j;
    qi[j] = q0 + r / G;
    hq[j] = h * G + r % G;
    rok[j] = r < nrows && qi[j] < a.Sq;
  }
  const int warp_r0 = warp * 16;
  const bool warp_live = warp_r0 < nrows && q0 + warp_r0 / G < a.Sq;
  const int warp_qmax = min(a.Sq - 1, q0 + min(nrows - 1, warp_r0 + 15) / G);

  // Q fragments (bf16 as given; the 1/sqrt(D) scale is applied to S in
  // fp32): in registers, or at D = 256 (QS) the block's rows in shared
  // memory, zeros past the chunk, read a k16 step at a time
  uint32_t aq[G_::QS ? 1 : KD][4];
  if constexpr (G_::QS) {
    __nv_bfloat16* Qs = (__nv_bfloat16*)(smem + G_::QB);
    for (int i = tid; i < QROWS * (D / 8); i += TC_THREADS) {
      const int r = i / (D / 8), d = (i % (D / 8)) * 8;
      const int qr = q0 + r / G;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows && qr < a.Sq)
        v = __ldg((const uint4*)(a.q + ((size_t)qr * a.Hq + h * G + r % G) * D + d));
      *(uint4*)(Qs + r * BP + d) = v;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = j & 1, d = kk * 16 + tig * 2 + (j >> 1) * 8;
        aq[kk][j] = rok[row] ? *(const uint32_t*)(a.q + ((size_t)qi[row] * a.Hq + hq[row]) * D + d)
                             : 0u;
      }
  }
  // the A fragment of k16 step kk
  auto qfrag = [&](int kk, uint32_t (&f)[4]) {
    if constexpr (G_::QS) {
      const int r = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), d = kk * 16 + 8 * (lane >> 4);
      sm90::ldmatrix_x4(f, sm90::smem_addr((const __nv_bfloat16*)(smem + G_::QB) + r * BP + d));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = aq[kk][j];
    }
  };
  float o[ND][4], m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;

  // the block's key range
  int lo, hi;
  if (chunk) {
    const int q_last = min(a.Sq, q0 + a.bq) - 1;
    lo = 0;
    hi = max(0, min(min(a.Sq, a.length), q_last + 1));
  } else {
    lo = s * a.cache_rows;
    hi = s == a.cache_splits - 1 ? a.T : min(a.T, lo + a.cache_rows);
  }
  const int ntiles = hi > lo ? (hi - lo + KT - 1) / KT : 0;
  auto row_ok = [&](int t) {  // key t of the range is attended at all
    if (t >= hi) return false;
    if (chunk) return true;
    const int p = a.kv_pos[t];
    return p >= 0 && p < a.pos_start;
  };
  // which tiles hold a live row: every position of the range read once,
  // all at the same time
  int* tl = (int*)(smem + G_::RING + 2 * STAGE);
  for (int i = tid; i < ntiles; i += TC_THREADS) tl[i] = chunk;
  if (STAT)  // the kv-head's per-layer constants, read once
    for (int c = tid; c < C; c += TC_THREADS) {
      stab[c] = a.s8.ks[h * C + c];
      stab[C + c] = a.s8.kz[h * C + c];
      stab[2 * C + c] = a.s8.vs[h * C + c];
      stab[3 * C + c] = a.s8.vz[h * C + c];
    }
  __syncthreads();
  if (!chunk)
    for (int t0 = lo + tid; t0 < hi; t0 += 4 * TC_THREADS) {
      int p[4];  // four positions a thread in flight at once
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * TC_THREADS;
        p[u] = t < hi ? __ldg(a.kv_pos + t) : -1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (p[u] >= 0 && p[u] < a.pos_start) tl[(t0 + u * TC_THREADS - lo) / KT] = 1;
    }
  __syncthreads();
  auto live = [&](int i) { return i < ntiles && tl[i] != 0; };  // block-uniform
  // the thread's (row, 16-byte chunk) and (row, scale) in a tile, and the
  // rows a pass covers where nck divides 128; C divides 32 (the launcher
  // checks). A row of 7, 14 or 28 chunks (D = 112) takes the tile's
  // chunks in turn instead, KT * nck of them.
  const int bytes = raw16 ? D * 2 : rbc, nck = bytes / 16;
  const bool even = TC_THREADS % nck == 0;
  const int kr0 = even ? tid / nck : 0, kc0 = even ? tid % nck : 0,
            kstep = even ? TC_THREADS / nck : 0;
  const int sr0 = C ? tid / C : 0, sc0 = C ? tid % C : 0, sstep = C ? TC_THREADS / C : KT;
  auto issue = [&](int i, int st) {
    unsigned char* raw = smem + G_::RING + st * STAGE;
    const int t0 = lo + i * KT;
    const char* kp = chunk8 ? (const char*)a.s8.wk
                     : chunk ? (const char*)a.kn : (const char*)a.ck;
    const char* vp = chunk8 ? (const char*)a.s8.wv
                     : chunk ? (const char*)a.vn : (const char*)a.cv;
    auto piece = [&](int r, int c) {
      if (t0 + r >= hi) return;
      const size_t off = ((size_t)(t0 + r) * a.Hkv + h) * bytes + c * 16;
      sm90::cp_async16(sm90::smem_addr(raw + r * RB + c * 16), kp + off);
      sm90::cp_async16(sm90::smem_addr(raw + (KT + r) * RB + c * 16), vp + off);
    };
    if (even)
      for (int r = kr0, c = kc0; r < KT; r += kstep) piece(r, c);
    else
      for (int i = tid; i < KT * nck; i += TC_THREADS) piece(i / nck, i % nck);
    if (INT8 && !raw16 && !STAT) {  // per-entry scales of the cache or the window
      float* sb = (float*)(raw + 2 * KT * RB);
      const float* ks = chunk ? a.s8.wks : a.s8.ks;
      const float* kz = chunk ? a.s8.wkz : a.s8.kz;
      const float* vs = chunk ? a.s8.wvs : a.s8.vs;
      const float* vz = chunk ? a.s8.wvz : a.s8.vz;
      for (int r = sr0; r < KT; r += sstep) {
        if (t0 + r >= hi) continue;
        const int j = r * C + sc0;
        const size_t si = ((size_t)(t0 + r) * a.Hkv + h) * C + sc0;
        sm90::cp_async4(sm90::smem_addr(sb + j), ks + si);
        sm90::cp_async4(sm90::smem_addr(sb + KT * C + j), kz + si);
        sm90::cp_async4(sm90::smem_addr(sb + 2 * KT * C + j), vs + si);
        sm90::cp_async4(sm90::smem_addr(sb + 3 * KT * C + j), vz + si);
      }
    }
  };
  // raw stage -> bf16 K and V tiles, 4 values a step; rows that are not
  // attended become 0 (their bytes may be stale)
  auto dequant = [&](int st, const int* rvt) {
    const unsigned char* raw = smem + G_::RING + st * STAGE;
    const float* sb = (const float*)(raw + 2 * KT * RB);
    for (int j = tid; j < 2 * KT * (D / 4); j += TC_THREADS) {
      const int kv = j / (KT * (D / 4)), jj = j % (KT * (D / 4));
      const int r = jj / (D / 4), d = (jj % (D / 4)) * 4;
      const bool ok = rvt[r] != 0;
      const unsigned char* src = raw + (kv * KT + r) * RB;
      uint2 out = make_uint2(0u, 0u);
      if (ok) {
        if (chunkh) {  // the window's bf16 values through float16 and back
          const uint2 w = *(const uint2*)(src + d * 2);
          float f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t h16 = ((e < 2 ? w.x : w.y) >> (16 * (e & 1))) & 0xffffu;
            f[e] = __half2float(__float2half_rn(__uint_as_float(h16 << 16)));
          }
          out = make_uint2(sm90::pack_bf16x2(f[0], f[1]), sm90::pack_bf16x2(f[2], f[3]));
        } else if (raw16 || KV16) {  // bf16 rows, the chunk's or a bf16 cache's: as they are
          out = *(const uint2*)(src + d * 2);
        } else if (KVH) {  // float16 rows, widened exactly, then rounded to bf16
          const uint2 w = *(const uint2*)(src + d * 2);
          const float2 lo = __half22float2(*(const __half2*)&w.x);
          const float2 hi = __half22float2(*(const __half2*)&w.y);
          out = make_uint2(sm90::pack_bf16x2(lo.x, lo.y), sm90::pack_bf16x2(hi.x, hi.y));
        } else if (INT8) {
          const uint32_t w = *(const uint32_t*)(src + d) ^ 0x80808080u;
          // four columns of one chunk: a chunk is a whole number of
          // 4-column groups (28 at D = 112, where a k16 fragment of K
          // holds columns of two chunks, each with its own scale)
          const int c = (d * a.cl_mul) >> 16;
          const float S = STAT ? stab[(2 * kv) * C + c] : sb[(2 * kv) * KT * C + r * C + c];
          const float Z = STAT ? stab[(2 * kv + 1) * C + c]
                               : sb[(2 * kv + 1) * KT * C + r * C + c];
          const float R = __frcp_rn(S);
          float f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f[e] = rt::dequant_kv_rcp(rt::code_f(w, e), S, R, Z);
          out = make_uint2(sm90::pack_bf16x2(f[0], f[1]), sm90::pack_bf16x2(f[2], f[3]));
        } else {
          const float4 f = *(const float4*)(src + d * 4);
          out = make_uint2(sm90::pack_bf16x2(f.x, f.y), sm90::pack_bf16x2(f.z, f.w));
        }
      }
      *(uint2*)((kv ? Vb : Kb) + r * BP + d) = out;
    }
  };
  auto compute = [&](int i, const int* rvt) {
    const int t0 = lo + i * KT;
    if (!warp_live || (chunk && t0 > warp_qmax)) return;
    float sacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[nt][j] = 0.f;
    const int mat = lane / 8, mrow = lane % 8;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qf[4];
      qfrag(kk, qf);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        const int key = (nt + mat / 2) * 8 + mrow, d = kk * 16 + (mat % 2) * 8;
        sm90::ldmatrix_x4(b, sm90::smem_addr(Kb + key * BP + d));
        sm90::mma_m16n8k16_bf16(sacc[nt], qf, b[0], b[1]);
        sm90::mma_m16n8k16_bf16(sacc[nt + 1], qf, b[2], b[3]);
      }
    }
    // mask, scale, online softmax (a row lives on the 4 lanes of its gid)
    float mx[2] = {rt::NEG_INF, rt::NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = nt * 8 + tig * 2 + (j & 1), row = j >> 1;
        const bool ok = rok[row] && rvt[kl] && (!chunk || t0 + kl <= qi[row]);
        sacc[nt][j] = ok ? __fmul_rn(sacc[nt][j], a.qscale) : rt::NEG_INF;
        mx[row] = fmaxf(mx[row], sacc[nt][j]);
      }
    float corr[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
      const float m_new = fmaxf(m[row], mx[row]);
      corr[row] = expf(m[row] - m_new);
      m[row] = m_new;
      l[row] *= corr[row];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = j >> 1;
        const float p = sacc[nt][j] > 0.5f * rt::NEG_INF ? expf(sacc[nt][j] - m[row]) : 0.f;
        sacc[nt][j] = p;
        l[row] += p;
      }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      o[dn][0] *= corr[0];
      o[dn][1] *= corr[0];
      o[dn][2] *= corr[1];
      o[dn][3] *= corr[1];
    }
    // O += P.V, P straight from the score registers as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t ap[4] = {
          sm90::pack_bf16x2(sacc[2 * kk][0], sacc[2 * kk][1]),
          sm90::pack_bf16x2(sacc[2 * kk][2], sacc[2 * kk][3]),
          sm90::pack_bf16x2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          sm90::pack_bf16x2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t b[4];
        const int key = kk * 16 + (mat % 2) * 8 + mrow, d = (dn + mat / 2) * 8;
        sm90::ldmatrix_x4_trans(b, sm90::smem_addr(Vb + key * BP + d));
        sm90::mma_m16n8k16_bf16(o[dn], ap, b[0], b[1]);
        sm90::mma_m16n8k16_bf16(o[dn + 1], ap, b[2], b[3]);
      }
    }
  };

  // double-buffered walk over the range's tiles; dead cache tiles are
  // skipped without loading their codes
  bool cur_live = live(0);
  if (cur_live) issue(0, 0);
  sm90::cp_async_commit();
  int done = 0;
  for (int i = 0; i < ntiles; ++i) {
    const bool nxt_live = live(i + 1);
    if (nxt_live) issue(i + 1, (i + 1) & 1);
    sm90::cp_async_commit();
    if (!cur_live) {
      cur_live = nxt_live;
      continue;
    }
    // row flags by the parity of the live tiles done: the compute of the
    // last live tile may still read the other half (a dead tile between
    // two live ones passes no barrier)
    int* rvt = rv + (done++ & 1) * KT;
    if (tid < KT) rvt[tid] = row_ok(lo + i * KT + tid);
    sm90::cp_async_wait<1>();
    __syncthreads();
    dequant(i & 1, rvt);
    __syncthreads();
    compute(i, rvt);
    cur_live = nxt_live;
  }
  sm90::cp_async_wait<0>();

  // this split's partial: (acc, max, sum) per query row
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 1);
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 2);
  }
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (!rok[row]) continue;
    const size_t prow = ((size_t)s * a.Sq + qi[row]) * a.Hq + hq[row];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *(float2*)(a.part_o + prow * D + dn * 8 + tig * 2) =
          make_float2(o[dn][2 * row], o[dn][2 * row + 1]);
    if (tig == 0) {
      a.part_ml[2 * prow] = m[row];
      a.part_ml[2 * prow + 1] = l[row];
    }
  }

  // the last block of this (query block, kv-head) merges the splits in order
  __threadfence();
  __syncthreads();
  const int splits = a.cache_splits + 1;
  int* counter = a.counter + (size_t)qb * a.Hkv + h;
  if (tid == 0) last_block = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // weights of each (row, split), then each output summed over the splits
  // with independent loads, in split order
  float* wt = (float*)smem;                 // [nrows][splits]
  float* lsum = wt + nrows * splits;        // [nrows][splits], then the totals
  int* rowoff = (int*)(lsum + nrows * splits + nrows);  // [nrows] query x Hq + head
  for (int r = tid; r < nrows; r += TC_THREADS)
    rowoff[r] = min(q0 + r / G, a.Sq - 1) * a.Hq + h * G + r % G;
  __syncthreads();
  for (int j = tid; j < nrows * splits; j += TC_THREADS) {
    const int r = j / splits, sp = j % splits, qr = q0 + r / G;
    float mj = rt::NEG_INF, lj = 0.f;
    if (qr < a.Sq) {
      const size_t prow = (size_t)sp * a.Sq * a.Hq + rowoff[r];
      mj = __ldcg(a.part_ml + 2 * prow);
      lj = __ldcg(a.part_ml + 2 * prow + 1);
    }
    wt[j] = lj > 0.f ? mj : rt::NEG_INF;
    lsum[j] = lj;
  }
  __syncthreads();
  for (int r = tid; r < nrows; r += TC_THREADS) {
    float M = rt::NEG_INF, L = 0.f;
    for (int sp = 0; sp < splits; ++sp) M = fmaxf(M, wt[r * splits + sp]);
    for (int sp = 0; sp < splits; ++sp) {
      const float lj = lsum[r * splits + sp];
      const float e = lj > 0.f ? expf(wt[r * splits + sp] - M) : 0.f;
      wt[r * splits + sp] = e;
      L += lj * e;
    }
    lsum[nrows * splits + r] = L;
  }
  __syncthreads();
  // four neighbouring outputs a step, the loads of four steps in flight
  constexpr int U = 4;
  const int n4 = nrows * D / 4;
  for (int i0 = tid; i0 < n4; i0 += U * TC_THREADS) {
    float4 A[U];
#pragma unroll
    for (int u = 0; u < U; ++u) A[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    // every split wrote finite values for every query row (an empty one
    // zeros) and padding rows weigh 0, so the loads need no condition and
    // are all in flight together
#pragma unroll 4
    for (int sp = 0; sp < splits; ++sp) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = min(i0 + u * TC_THREADS, n4 - 1);
        const int r = i / (D / 4), d = (i % (D / 4)) * 4;
        const float e = wt[r * splits + sp];
        const size_t row = rowoff[r];
        const float4 v =
            __ldcg((const float4*)(a.part_o + ((size_t)sp * a.Sq * a.Hq + row) * D + d));
        A[u].x = fmaf(v.x, e, A[u].x);
        A[u].y = fmaf(v.y, e, A[u].y);
        A[u].z = fmaf(v.z, e, A[u].z);
        A[u].w = fmaf(v.w, e, A[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * TC_THREADS;
      if (i >= n4) break;
      const int r = i / (D / 4), d = (i % (D / 4)) * 4;
      if (q0 + r / G >= a.Sq) continue;
      const size_t row = rowoff[r];
      const float L = lsum[nrows * splits + r];
      const float inv[4] = {A[u].x, A[u].y, A[u].z, A[u].w};
      uint32_t packed[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        packed[k] = sm90::pack_bf16x2(
            L > 0.f ? __fdiv_rn(inv[2 * k], fmaxf(L, 1e-30f)) : 0.f,
            L > 0.f ? __fdiv_rn(inv[2 * k + 1], fmaxf(L, 1e-30f)) : 0.f);
      *(uint2*)(a.o + row * D + d) = make_uint2(packed[0], packed[1]);
    }
  }
  if (tid == 0) *counter = 0;
}

template <int D, typename KV, bool STAT>
cudaError_t launch_tc(const PArgs& a, cudaStream_t st) {
  const size_t smem = TcGeo<D>::bytes((int)sizeof(KV), a.C, a.T);
  if (smem > SMEM_MAX) return cudaErrorInvalidConfiguration;
  auto kern = prefill_tc_kernel<D, KV, STAT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((a.Sq + a.bq - 1) / a.bq, a.Hkv, a.cache_splits + 1), TC_THREADS, smem,
         st>>>(a);
  return cudaGetLastError();
}

template <typename KV, bool STAT>
cudaError_t dispatch_tc(const PArgs& a, int D, cudaStream_t st) {
  switch (D) {
    case 32: return launch_tc<32, KV, STAT>(a, st);
    case 64: return launch_tc<64, KV, STAT>(a, st);
    case 112: return launch_tc<112, KV, STAT>(a, st);
    case 128: return launch_tc<128, KV, STAT>(a, st);
    case 256: return launch_tc<256, KV, STAT>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KV>
cudaError_t launch_fp32(const void* q, const void* kn, const void* vn, const void* ck,
                        const void* cv, const int* kv_pos, const Int8Ops& s8, void* o,
                        int Sq, int T, int Hq, int Hkv, int D, int C, int pos_start,
                        int length, float qscale, cudaStream_t st) {
  const int G = Hq / Hkv;
  const int Bq = G >= 32 ? 1 : 32 / G;
  const int R = Bq * G;
  const size_t smem = sizeof(float) * (2 * R * D + TC * (D + 1) + R * TC + 3 * R) +
                      sizeof(int) * TC;
  auto kern = prefill_fp32_kernel<KV, float>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Sq + Bq - 1) / Bq, Hkv), THREADS, smem, st>>>(
      (const float*)q, (const float*)kn, (const float*)vn, (const KV*)ck,
      (const KV*)cv, kv_pos, s8, (float*)o, Sq, T, Hq, Hkv, D, C, Bq, pos_start,
      length, qscale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a tensor-core block takes; kv_bytes: the
// cache's element size, 1 (int8), 2 (bf16, float16) or 4 (fp32).
int prefill_attention_smem(int D, int C, int kv_bytes, int T) {
  const int kv = kv_bytes, c = kv_bytes == 1 ? C : 0;
  switch (D) {
    case 32: return TcGeo<32>::bytes(kv, c, T);
    case 64: return TcGeo<64>::bytes(kv, c, T);
    case 112: return TcGeo<112>::bytes(kv, c, T);
    case 128: return TcGeo<128>::bytes(kv, c, T);
    case 256: return TcGeo<256>::bytes(kv, c, T);
    default: return 0;
  }
}

// int8 modes: ks..vz are the cache's scales, per-entry (T, Hkv, C) or,
// with `stat`, per-layer (Hkv, C); with `verify`, wk/wv are the window's
// codes (Sq, Hkv, D) and wks..wvz its per-entry scales (Sq, Hkv, C; unused
// with `stat`, where the window takes the same constants). kv_bytes: the
// cache's element size, 1 (int8 codes), 2 (bf16, or float16 with kv_f16)
// or 4 (fp32); `verify` over a float cache rounds the window to the
// cache's type.
int prefill_attention(const void* q, const void* kn, const void* vn,
                      const void* ck, const void* cv, const void* kv_pos,
                      const void* ks, const void* kz, const void* vs,
                      const void* vz, const void* wk, const void* wv,
                      const void* wks, const void* wkz, const void* wvs,
                      const void* wvz, void* o, void* part_o, void* part_ml,
                      void* counter, int Sq, int T, int Hq, int Hkv, int D,
                      int C, int pos_start, int length, int kv_bytes, int kv_f16,
                      int stat, int verify, int x_is_bf16, int cache_rows,
                      int cache_splits, float qscale, void* stream) {
  const bool int8 = kv_bytes == 1;
  if (Sq <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      (kv_bytes != 1 && kv_bytes != 2 && kv_bytes != 4) || (kv_f16 && kv_bytes != 2) ||
      (int8 && (C <= 0 || D % C != 0)) || (int8 && verify && (!wk || !wv)) ||
      (int8 && verify && !stat && (!wks || !wkz || !wvs || !wvz)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* kp = (const int*)kv_pos;
  const bool s_ = int8 && stat, v_ = verify != 0;
  Int8Ops s8{(const float*)ks, (const float*)kz, (const float*)vs, (const float*)vz,
             (const int8_t*)wk, (const int8_t*)wv,
             (const float*)(s_ ? ks : wks), (const float*)(s_ ? kz : wkz),
             (const float*)(s_ ? vs : wvs), (const float*)(s_ ? vz : wvz),
             s_ ? 1 : 0, v_ ? 1 : 0};
  if (!x_is_bf16)
    return (int)(int8 ? launch_fp32<int8_t>(q, kn, vn, ck, cv, kp, s8, o, Sq, T, Hq,
                                            Hkv, D, C, pos_start, length, qscale, st)
                 : kv_f16
                     ? launch_fp32<__half>(q, kn, vn, ck, cv, kp, s8, o, Sq, T, Hq, Hkv, D,
                                           C, pos_start, length, qscale, st)
                 : kv_bytes == 2
                     ? launch_fp32<__nv_bfloat16>(q, kn, vn, ck, cv, kp, s8, o, Sq, T, Hq,
                                                  Hkv, D, C, pos_start, length, qscale, st)
                     : launch_fp32<float>(q, kn, vn, ck, cv, kp, s8, o, Sq, T, Hq,
                                          Hkv, D, C, pos_start, length, qscale, st));
  const int G = Hq / Hkv;
  // sub-channel chunks of a whole number of 4-column groups, C dividing 32
  int cl_mul = 0;
  if (int8) {
    const int cl = D / C;
    if (cl < 4 || cl % 4 || 32 % C) return (int)cudaErrorInvalidValue;
    cl_mul = (65536 + cl - 1) / cl;   // (d * cl_mul) >> 16 == d / cl for d < 256
  }
  if (G > QROWS || cache_rows <= 0 || cache_rows % PLAN_TILE != 0 || cache_splits <= 0 ||
      cache_splits + 1 > MAX_SPLITS ||
      (long long)(cache_splits - 1) * cache_rows >= T || !part_o || !part_ml ||
      !counter)
    return (int)cudaErrorInvalidValue;
  PArgs p{(const __nv_bfloat16*)q, (const __nv_bfloat16*)kn,
          (const __nv_bfloat16*)vn, ck, cv, kp, s8, (__nv_bfloat16*)o,
          (float*)part_o, (float*)part_ml, (int*)counter,
          Sq, T, Hq, Hkv, int8 ? C : 0, cl_mul, pos_start, length,
          QROWS / G, cache_rows, cache_splits, qscale};
  if (kv_f16) return (int)dispatch_tc<__half, false>(p, D, st);
  if (kv_bytes == 2) return (int)dispatch_tc<__nv_bfloat16, false>(p, D, st);
  if (!int8) return (int)dispatch_tc<float, false>(p, D, st);
  return (int)(s_ ? dispatch_tc<int8_t, true>(p, D, st) : dispatch_tc<int8_t, false>(p, D, st));
}

}  // extern "C"
