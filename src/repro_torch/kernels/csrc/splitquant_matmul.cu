// Fused SplitQuant dequant-matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/splitquant_matmul.py
// (_kernel, pallas_call at :83):
//     y[m, n] = sum_k x[m, k] * W[k, n],
//     W[k, n] = q[k, n] * recip[cid[k, n], n] + shift[cid[k, n], n]
// with q packed 8/bits per byte along K and cid packed four per byte
// (kernels/packing.py). W is computed in fp32 (a separate multiply and
// add, as the reference rounds them), rounded to x's type as ref.py
// does, and the product is accumulated in fp32.
//
// What bounds it. The serving paths give it two regimes. M is the
// engine's decode batch (8 slots), a prompt chunk (96 rows), or an
// rwkv6 wave prefill (8 x the padded length, up to 2048 rows). At
// M <= 96 the product is far below the H100's ~295 FLOP/byte ridge and is
// bound by the bytes of the packed weight (0.75 B per element at INT4
// with 2-bit cluster ids). At M ~ 2048 it is above the ridge and bound by
// the bf16 tensor-core rate (989 TFLOP/s).
//
// bf16 x: sq_matmul_wgmma_kernel, on the tensor cores. A block of two
// warpgroups owns a BM x 128 tile of y (BM = 128, one 64 x 128 wgmma tile
// per warpgroup; BM = 64 when M <= 64, 64 x 64 each) and walks K in tiles
// of 64. A ring of 3 (BM 128) or 4 (BM 64) stages in shared memory holds
// the x tile (bf16, 128-byte swizzle) and the packed code and cluster-id
// tiles, filled by 16-byte cp.async requests one or two tiles ahead. All
// 256 threads dequantize each packed tile ONCE into a bf16 B tile in
// shared memory, K-major (B[n][k]) with the 128-byte swizzle: a packed
// byte holds neighbouring k of one column, so a thread's 8 values of a
// column are one 16-byte store. Then each warpgroup issues four
// wgmma.m64nNk16 (fp32 accumulators in registers); the B tile is
// double-buffered, so those products run while the block dequantizes
// the next tile. The dequantized weight never goes to device memory, and
// the weight is dequantized M/BM times in all. Two blocks share an SM.
// When the (M, N) grid would leave SMs idle, K is split across blocks:
// each split writes fp32 partial sums to a workspace that
// split_reduce_kernel adds in split order, so the result is the same from
// call to call. Ragged M, N and K are zero-filled in shared memory
// (explicit masks), not padded by the caller.
//
// What holds it back (measured, PERF.md): the dequantization, ~10
// instructions per weight element (code decode, two selects each of the
// cluster's recip and shift, multiply, add, convert), issued M/BM times
// per element; at M = 8 that alone is well above the time to read the
// packed weight. At M ~ 2048 also the L2 traffic of re-reading the x
// tile for every 128 columns.
//
// Grouped form (the experts of a MoE layer, grouped_splitquant_matmul):
// y[r] = x[r] . W_e for every row r in [offsets[e], offsets[e+1]), with
// x's rows sorted by expert and W a stack of E packed weights. The same
// two kernels take it: a block is (expert, M tile, N tile), reads its
// expert's row range from `offsets` on the card (no host copy), moves
// its pointers to that expert's rows and packed weight, and exits at
// once when its M tile lies past the expert's rows. The grid holds
// E x ceil(R / BM) M tiles (R = all rows, the most one expert can get),
// so at a decode step of 8 tokens x top-6 most blocks exit at once. No
// K split; the tensor-core form uses BM = 64. The weight of an expert
// with no rows is never read: the work is bound by the packed bytes of
// the experts that got tokens.
//
// fp32 x: sq_matmul_fp32_kernel, on the CUDA cores (fp32 on the tensor
// cores would be TF32 and change the numbers). Each warp lane owns 4
// neighbouring columns; a block covers 8 rows x 128 columns; its 8 warps
// split each 64-deep K tile and their partial sums are added in a fixed
// order. Only the reduced fp32 models take it.
#include "common.cuh"
#include "sm90.cuh"

#include <type_traits>

namespace {

// ------------------------------------------------ bf16 x, tensor cores ---
constexpr int TC_BK = 64;

// Tiles of the tensor-core kernel: BM x 128 outputs per block of two
// warpgroups (BM 128: stacked in M, one 64 x 128 wgmma tile each; BM 64:
// side by side in N, 64 x 64 each). A ring stage holds one K tile of x
// (bf16, swizzled) and of the packed codes and ids; the dequantized B
// tiles (bf16, swizzled) are double-buffered beside the ring, so the
// wgmma of one K tile runs while the block dequantizes the next.
template <int BITS, int BM>
struct TcCfg {
  static constexpr int BN = 128;
  static constexpr int THREADS = 256;
  static constexpr int NT = BM == 64 ? 64 : 128;   // columns per warpgroup
  static constexpr int STAGES = BM == 64 ? 4 : 3;  // 2 blocks per SM
  static constexpr int LEAD = STAGES - 2;          // K tiles loaded ahead
  static constexpr int PITCH = BN + 16;            // bytes per packed row
  static constexpr int CHUNKS = BN / 16;           // 16-byte chunks per packed row
  static constexpr int Q_ROWS = TC_BK * BITS / 8;  // packed code rows per tile
  static constexpr int C_ROWS = TC_BK / 4;         // packed cid rows per tile
  static constexpr int Q_OFF = BM * TC_BK * 2;     // after the x tile
  static constexpr int C_OFF = Q_OFF + Q_ROWS * PITCH;
  static constexpr int STAGE = (C_OFF + C_ROWS * PITCH + 1023) / 1024 * 1024;
  static constexpr int B_TILE = BN * TC_BK * 2;    // one dequantized B tile
  static constexpr int SMEM = 1024 + 2 * B_TILE + STAGES * STAGE;  // + alignment
};

// One 16-byte chunk of `rows` x `cols` bytes at (row, col), or the bytes
// in range and zeros beyond (synchronous), into shared memory.
__device__ __forceinline__ void load_bytes16(uint8_t* dst, uint32_t dst_s,
                                             const uint8_t* src, int row,
                                             int col, int rows, int cols,
                                             bool vec) {
  const uint8_t* p = src + (size_t)row * cols + col;
  if (vec && row < rows && col + 16 <= cols) {
    sm90::cp_async16(dst_s, p);
    return;
  }
  uint32_t w[4] = {0, 0, 0, 0};
  if (row < rows)
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (col + b < cols) w[b / 4] |= (uint32_t)p[b] << (8 * (b % 4));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Fill one ring stage with K tile [kt, kt + 64): x rows [m0, m0 + BM) in
// k < k_hi (zeros elsewhere), and the packed rows of weight columns
// [n0, n0 + 128).
template <int BITS, int BM>
__device__ __forceinline__ void load_tile(uint8_t* st, uint32_t st_s,
                                          const __nv_bfloat16* x,
                                          const uint8_t* qp, const uint8_t* cp,
                                          int M, int K, int N, int m0, int n0,
                                          int kt, int k_hi, bool vec_x,
                                          bool vec_w) {
  using C = TcCfg<BITS, BM>;
  const auto* xs = reinterpret_cast<const unsigned short*>(x);
  for (int i = threadIdx.x; i < BM * 8; i += C::THREADS) {
    const int r = i >> 3, c = i & 7;
    const int m = m0 + r, k = kt + c * 8;
    const uint32_t off = sm90::sw128(r, c);
    if (vec_x && m < M && k + 8 <= k_hi) {
      sm90::cp_async16(st_s + off, xs + (size_t)m * K + k);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      if (m < M)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (k + e < k_hi)
            w[e / 2] |= (uint32_t)xs[(size_t)m * K + k + e] << (16 * (e % 2));
      *reinterpret_cast<uint4*>(st + off) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  const int q0 = kt * BITS / 8, c0 = kt / 4;
  for (int i = threadIdx.x; i < (C::Q_ROWS + C::C_ROWS) * C::CHUNKS;
       i += C::THREADS) {
    const int r = i / C::CHUNKS, c = i % C::CHUNKS;
    if (r < C::Q_ROWS) {
      const int off = C::Q_OFF + r * C::PITCH + c * 16;
      load_bytes16(st + off, st_s + off, qp, q0 + r, n0 + c * 16,
                   K * BITS / 8, N, vec_w);
    } else {
      const int off = C::C_OFF + (r - C::Q_ROWS) * C::PITCH + c * 16;
      load_bytes16(st + off, st_s + off, cp, c0 + r - C::Q_ROWS, n0 + c * 16,
                   K / 4, N, vec_w);
    }
  }
}

// v[c] for a cluster id c < 4, or c < 3 when !KC4 (one select fewer)
template <bool KC4>
__device__ __forceinline__ float pick(const float (&v)[4], uint32_t c) {
  const float lo = (c & 1) ? v[1] : v[0];
  if constexpr (!KC4) return (c & 2) ? v[2] : lo;
  const float hi = (c & 1) ? v[3] : v[2];
  return (c & 2) ? hi : lo;
}

// Dequantize k = [8 kc, 8 kc + 8) of columns 4 cq .. 4 cq + 3 of a staged
// packed tile into the swizzled K-major bf16 tile bs (one 16-byte store
// per column).
template <int BITS, int PITCH, bool KC4>
__device__ __forceinline__ void dequant_item(const uint8_t* sq, const uint8_t* sc,
                                             uint8_t* bs, int cq, int kc,
                                             const float (&rc)[4][4],
                                             const float (&sh)[4][4]) {
  constexpr int PER = 8 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1;
  constexpr int QMIN = -(1 << (BITS - 1));
  uint32_t qw[BITS], cw[2];
#pragma unroll
  for (int i = 0; i < BITS; ++i)
    qw[i] = *reinterpret_cast<const uint32_t*>(sq + (kc * BITS + i) * PITCH + cq * 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    cw[i] = *reinterpret_cast<const uint32_t*>(sc + (kc * 2 + i) * PITCH + cq * 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t o[4];
#pragma unroll
    for (int e2 = 0; e2 < 4; ++e2) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * e2 + h;
        // code u at bit `at` of a 16-bit half of the word, read as the
        // float 2^23 + u 2^at; then u + QMIN = f 2^-at - 2^(23-at) + QMIN,
        // exact in one fma (integers below 2^24, power-of-two scaling)
        const int at = 8 * (j & 1) + BITS * (e % PER);
        const uint32_t half = j < 2 ? qw[e / PER] : qw[e / PER] >> 16;
        const float f =
            __uint_as_float(sm90::lop3_and_or(half, MASK << at, 0x4B000000u));
        const float q = __fmaf_rn(f, 1.f / (float)(1 << at),
                                  (float)QMIN - (float)(1 << (23 - at)));
        const uint32_t c = (cw[e / 4] >> (8 * j + 2 * (e % 4))) & 3u;
        v[h] = __fadd_rn(__fmul_rn(q, pick<KC4>(rc[j], c)), pick<KC4>(sh[j], c));
      }
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[0], v[1]);
      o[e2] = *reinterpret_cast<const uint32_t*>(&b);
    }
    const int n = cq * 4 + j;
    *reinterpret_cast<uint4*>(bs + sm90::sw128(n, kc)) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <int NT>
__device__ __forceinline__ void fence_acc(float (&acc)[NT / 2]) {
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) sm90::fence_operand(acc[i]);
}

template <int BITS, int BM, bool KC4>
__global__ void __launch_bounds__(256, 2)
sq_matmul_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ qp,
                       const uint8_t* __restrict__ cp,
                       const float* __restrict__ recip,
                       const float* __restrict__ shift,
                       __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                       int M, int K, int N, int kcl, int k_per_split,
                       int vec_x, int vec_w,
                       const int* __restrict__ offsets, int m_tiles) {
  using C = TcCfg<BITS, BM>;
  constexpr int NT = C::NT;
  int mt = blockIdx.x;
  if (offsets != nullptr) {          // grouped: this block's expert
    const int e = blockIdx.x / m_tiles;
    mt = blockIdx.x % m_tiles;
    const int r0 = offsets[e];
    M = offsets[e + 1] - r0;
    if (mt * BM >= M) return;
    x += (size_t)r0 * K;
    y += (size_t)r0 * N;
    qp += (size_t)e * (K * BITS / 8) * N;
    cp += (size_t)e * (K / 4) * N;
    recip += (size_t)e * kcl * N;
    shift += (size_t)e * kcl * N;
  }
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = sm90::smem_addr(smem_raw);
  const uint32_t pad = ((raw_s + 1023u) & ~1023u) - raw_s;
  uint8_t* bs = smem_raw + pad;                 // two dequantized B tiles
  const uint32_t bs_s = raw_s + pad;
  uint8_t* ring = bs + 2 * C::B_TILE;
  const uint32_t ring_s = bs_s + 2 * C::B_TILE;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int m0 = mt * BM, n0 = blockIdx.y * C::BN;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int tiles = (k_hi - k_lo + TC_BK - 1) / TC_BK;

  // this thread's dequant item: 8 k (chunk kc) of 4 columns (quad cq);
  // the 8 lanes of a store phase hit 8 different swizzled chunks
  const int warp = tid >> 5;
  const int kc = (lane & 3) + 4 * (warp & 1);
  const int cq = (warp >> 1) * 8 + (lane >> 2);
  float rc[4][4], sh[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + cq * 4 + j;
      const bool ok = n < N && c < kcl;
      rc[j][c] = ok ? recip[(size_t)c * N + n] : 0.f;
      sh[j][c] = ok ? shift[(size_t)c * N + n] : 0.f;
    }

  // this warpgroup's 64 x NT sub-tile of y
  const int wrow = BM == 64 ? 0 : 64 * wg;
  const int wcol = BM == 64 ? 64 * wg : 0;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int u = 0; u < C::LEAD; ++u) {
    if (u < tiles)
      load_tile<BITS, BM>(ring + u * C::STAGE, ring_s + u * C::STAGE, x, qp, cp,
                          M, K, N, m0, n0, k_lo + u * TC_BK, k_hi, vec_x, vec_w);
    sm90::cp_async_commit();
  }

  for (int t = 0; t < tiles; ++t) {
    // Tile t has landed. Both warpgroups have waited for their wgmma of
    // tile t-2 (wait_group 1 below), so its stage and B buffer are free.
    sm90::cp_async_wait<C::LEAD - 1>();
    __syncthreads();
    const int u = t + C::LEAD;
    if (u < tiles) {
      const int su = u % C::STAGES;
      load_tile<BITS, BM>(ring + su * C::STAGE, ring_s + su * C::STAGE, x, qp,
                          cp, M, K, N, m0, n0, k_lo + u * TC_BK, k_hi, vec_x,
                          vec_w);
    }
    sm90::cp_async_commit();
    const int s = t % C::STAGES;
    uint8_t* st = ring + s * C::STAGE;
    const int bi = t & 1;
    dequant_item<BITS, C::PITCH, KC4>(st + C::Q_OFF, st + C::C_OFF,
                                      bs + bi * C::B_TILE, cq, kc, rc, sh);
    sm90::fence_proxy_async();             // x and B, for wgmma
    __syncthreads();

    // tile t's products run while the next iteration dequantizes t+1
    const uint32_t a_s = ring_s + s * C::STAGE + wrow * 128;
    const uint32_t b_s = bs_s + bi * C::B_TILE + wcol * 128;
    fence_acc<NT>(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint64_t da = sm90::sw128_desc(a_s + kk * 32);
      const uint64_t db = sm90::sw128_desc(b_s + kk * 32);
      if constexpr (NT == 128)
        sm90::wgmma_m64n128k16(acc, da, db);
      else
        sm90::wgmma_m64n64k16(acc, da, db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    fence_acc<NT>(acc);
  }
  sm90::wgmma_wait<0>();
  fence_acc<NT>(acc);

  // accumulator fragment: acc[4j + 2h + v] is row 16 w + lane/4 + 8 h,
  // column 8 j + 2 (lane % 4) + v of the warpgroup's 64 x NT sub-tile
  const int wi = (tid & 127) >> 5;
  const int row0 = m0 + wrow + wi * 16 + (lane >> 2);
  const int col0 = n0 + wcol + (lane & 3) * 2;
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h, n = col0 + 8 * j;
      if (m >= M || n >= N) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (gridDim.z == 1) {
        __nv_bfloat16* dst = y + (size_t)m * N + n;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (n + 1 < N) dst[1] = __float2bfloat16_rn(v1);
        }
      } else {
        float* dst = ws + ((size_t)blockIdx.z * M + m) * N + n;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (n + 1 < N) dst[1] = v1;
        }
      }
    }
}

// ----------------------------------------------- fp32 x, CUDA cores ---
constexpr int BM = 8;
constexpr int BN = 128;
constexpr int WARPS = 8;
constexpr int BK = 64;
constexpr int ROWS_PER_WARP = BK / WARPS;

template <int BITS>
__global__ void __launch_bounds__(WARPS * 32)
sq_matmul_fp32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qp,
                      const uint8_t* __restrict__ cp, const float* __restrict__ recip,
                      const float* __restrict__ shift, float* __restrict__ y,
                      float* __restrict__ ws, int M, int K, int N, int kc,
                      int k_per_split, const int* __restrict__ offsets,
                      int m_tiles) {
  int mt = blockIdx.x;
  if (offsets != nullptr) {          // grouped: this block's expert
    const int e = blockIdx.x / m_tiles;
    mt = blockIdx.x % m_tiles;
    const int r0 = offsets[e];
    M = offsets[e + 1] - r0;
    if (mt * BM >= M) return;
    x += (size_t)r0 * K;
    y += (size_t)r0 * N;
    qp += (size_t)e * (K * BITS / 8) * N;
    cp += (size_t)e * (K / 4) * N;
    recip += (size_t)e * kc * N;
    shift += (size_t)e * kc * N;
  }
  constexpr int PER = 8 / BITS;
  constexpr int MASK = (1 << BITS) - 1;
  constexpr int QMIN = -(1 << (BITS - 1));
  __shared__ float xs[BM][BK];
  __shared__ float part[WARPS][BM][BN];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = mt * BM;
  const int nb = blockIdx.y * BN;
  const int n0 = nb + lane * 4;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const bool vec = (N % 4 == 0) && (((uintptr_t)qp | (uintptr_t)cp) % 4 == 0) &&
                   (n0 + 3 < N);

  float rc[4][4], sh[4][4];  // [column j][cluster c]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool ok = (n0 + j < N) && (c < kc);
      rc[j][c] = ok ? recip[(size_t)c * N + n0 + j] : 0.f;
      sh[j][c] = ok ? shift[(size_t)c * N + n0 + j] : 0.f;
    }

  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int kt = k_lo; kt < k_hi; kt += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += blockDim.x) {
      const int r = i / BK, kk = i % BK;
      const int m = m0 + r, kg = kt + kk;
      xs[r][kk] = (m < M && kg < k_hi) ? x[(size_t)m * K + kg] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < ROWS_PER_WARP; ++kk) {
      const int kl = warp * ROWS_PER_WARP + kk;
      const int kg = kt + kl;
      if (kg < k_hi) {
        const uint8_t* qrow = qp + (size_t)(kg / PER) * N;
        const uint8_t* crow = cp + (size_t)(kg / 4) * N;
        const int qs = (kg % PER) * BITS, cs = (kg % 4) * 2;
        uint32_t qb = 0, cb = 0;
        if (vec) {
          qb = *reinterpret_cast<const uint32_t*>(qrow + n0);
          cb = *reinterpret_cast<const uint32_t*>(crow + n0);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + j < N) {
              qb |= (uint32_t)qrow[n0 + j] << (8 * j);
              cb |= (uint32_t)crow[n0 + j] << (8 * j);
            }
        }
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = ((qb >> (8 * j)) >> qs) & MASK;
          const uint32_t c = ((cb >> (8 * j)) >> cs) & 3;
          w[j] = __fadd_rn(__fmul_rn((float)(u + QMIN), pick<true>(rc[j], c)),
                           pick<true>(sh[j], c));
        }
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float xv = xs[m][kl];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int m = i / BN, col = i % BN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[w][m][col];
    const int mg = m0 + m, ng = nb + col;
    if (mg < M && ng < N) {
      if (gridDim.z == 1)
        y[(size_t)mg * N + ng] = s;
      else
        ws[((size_t)blockIdx.z * M + mg) * N + ng] = s;
    }
  }
}

// ------------------------------------------------------ K-split sum ---
template <typename T>
__global__ void split_reduce_kernel(const float* __restrict__ ws, T* __restrict__ y,
                                    int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[(size_t)z * MN + i];
  y[i] = rt::from_f<T>(s);
}

template <typename T>
cudaError_t reduce_splits(float* ws, void* y, int M, int N, int splits,
                          cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int MN = M * N;
  split_reduce_kernel<T><<<(MN + 255) / 256, 256, 0, st>>>(ws, (T*)y, MN, splits);
  return cudaGetLastError();
}

// Grouped launches (offsets != nullptr): M is all rows, the grid holds
// E x m_tiles M tiles and splits is 1.
template <int BITS, int BM_, bool KC4>
cudaError_t launch_wgmma(const void* x, const uint8_t* qp, const uint8_t* cp,
                         const float* recip, const float* shift, void* y,
                         float* ws, int M, int K, int N, int kc, int splits,
                         int k_per_split, const int* offsets, int m_tiles,
                         int E, cudaStream_t st) {
  using C = TcCfg<BITS, BM_>;
  auto kern = sq_matmul_wgmma_kernel<BITS, BM_, KC4>;
  // the dynamic shared-memory limit is raised once per device
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && !(raised >> dev & 1u)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    raised |= 1u << dev;
  }
  const bool vec_x = K % 8 == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_w = N % 16 == 0 && ((uintptr_t)qp | (uintptr_t)cp) % 16 == 0;
  const int mx = offsets ? E * m_tiles : (M + BM_ - 1) / BM_;
  dim3 grid(mx, (N + C::BN - 1) / C::BN, splits);
  kern<<<grid, C::THREADS, C::SMEM, st>>>(
      (const __nv_bfloat16*)x, qp, cp, recip, shift, (__nv_bfloat16*)y, ws, M, K,
      N, kc, k_per_split, vec_x, vec_w, offsets, m_tiles);
  return reduce_splits<__nv_bfloat16>(ws, y, M, N, splits, st);
}

template <int BITS>
cudaError_t launch_bits(const void* x, const uint8_t* qp, const uint8_t* cp,
                        const float* recip, const float* shift, void* y,
                        float* ws, int M, int K, int N, int kc, int x_is_bf16,
                        int bm, int splits, int k_per_split, const int* offsets,
                        int m_tiles, int E, cudaStream_t st) {
  if (x_is_bf16) {
    auto go = [&](auto bm_, auto kc4_) {
      return launch_wgmma<BITS, decltype(bm_)::value, decltype(kc4_)::value>(
          x, qp, cp, recip, shift, y, ws, M, K, N, kc, splits, k_per_split,
          offsets, m_tiles, E, st);
    };
    using I64 = std::integral_constant<int, 64>;
    using I128 = std::integral_constant<int, 128>;
    using K3 = std::false_type;
    using K4 = std::true_type;
    if (bm == 64) return kc == 4 ? go(I64{}, K4{}) : go(I64{}, K3{});
    return kc == 4 ? go(I128{}, K4{}) : go(I128{}, K3{});
  }
  const int mx = offsets ? E * m_tiles : (M + BM - 1) / BM;
  dim3 grid(mx, (N + BN - 1) / BN, splits);
  sq_matmul_fp32_kernel<BITS><<<grid, WARPS * 32, 0, st>>>(
      (const float*)x, qp, cp, recip, shift, (float*)y, ws, M, K, N, kc,
      k_per_split, offsets, m_tiles);
  return reduce_splits<float>(ws, y, M, N, splits, st);
}

cudaError_t launch_any(const void* x, const void* qp, const void* cp,
                       const void* recip, const void* shift, void* y, void* ws,
                       int M, int K, int N, int bits, int kc, int x_is_bf16,
                       int bm, int splits, int k_per_split, const int* offsets,
                       int m_tiles, int E, cudaStream_t st) {
  const auto* q8 = (const uint8_t*)qp;
  const auto* c8 = (const uint8_t*)cp;
  const auto* r = (const float*)recip;
  const auto* s = (const float*)shift;
  switch (bits) {
    case 2: return launch_bits<2>(x, q8, c8, r, s, y, (float*)ws, M, K, N, kc,
                                  x_is_bf16, bm, splits, k_per_split, offsets,
                                  m_tiles, E, st);
    case 4: return launch_bits<4>(x, q8, c8, r, s, y, (float*)ws, M, K, N, kc,
                                  x_is_bf16, bm, splits, k_per_split, offsets,
                                  m_tiles, E, st);
    case 8: return launch_bits<8>(x, q8, c8, r, s, y, (float*)ws, M, K, N, kc,
                                  x_is_bf16, bm, splits, k_per_split, offsets,
                                  m_tiles, E, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// Dynamic shared memory of a block of the tensor-core kernel, in bytes
// (ptxas reports only static shared memory); 0 for an unknown tile.
int splitquant_matmul_smem(int bits, int bm) {
  const bool big = bm == 128;
  if (bm != 64 && !big) return 0;
  switch (bits) {
    case 2: return big ? TcCfg<2, 128>::SMEM : TcCfg<2, 64>::SMEM;
    case 4: return big ? TcCfg<4, 128>::SMEM : TcCfg<4, 64>::SMEM;
    case 8: return big ? TcCfg<8, 128>::SMEM : TcCfg<8, 64>::SMEM;
    default: return 0;
  }
}

// y (M, N) = x (M, K) . W; x and y are bf16 when x_is_bf16 (tensor-core
// kernel, bm 64 or 128), else fp32 (CUDA-core kernel, bm 8); bn is 128.
//  K is split into `splits` slices of
// k_per_split (a multiple of 64) rows, none empty; ws: fp32 scratch of
// splits*M*N floats (unused when splits == 1).
int splitquant_matmul(const void* x, const void* qp, const void* cp,
                      const void* recip, const void* shift, void* y, void* ws,
                      int M, int K, int N, int bits, int kc, int x_is_bf16,
                      int bm, int splits, int k_per_split, void* stream) {
  const bool tile_ok = x_is_bf16 ? (bm == 64 || bm == 128) : bm == BM;
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || kc < 1 || kc > 4 || !tile_ok ||
      splits < 1 || k_per_split <= 0 || k_per_split % TC_BK ||
      (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K ||
      (long long)M * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return (int)launch_any(x, qp, cp, recip, shift, y, ws, M, K, N, bits, kc,
                         x_is_bf16, bm, splits, k_per_split, nullptr, 0, 1,
                         (cudaStream_t)stream);
}

// Grouped: y (R, N) with y[r] = x[r] . W_e for r in [offsets[e],
// offsets[e+1]); x (R, K) sorted by expert, bf16 (tensor-core kernel,
// BM 64) or fp32 (CUDA-core kernel, BM 8), as y; qp (E, K*bits/8, N),
// cp (E, K/4, N), recip/shift (E, kc, N); offsets (E+1) int32 on the
// card, non-decreasing from 0 to R. m_tiles: M tiles per expert in the
// grid, at least ceil(R / BM).
int grouped_splitquant_matmul(const void* x, const void* qp, const void* cp,
                              const void* recip, const void* shift,
                              const void* offsets, void* y, int R, int K,
                              int N, int E, int m_tiles, int bits, int kc,
                              int x_is_bf16, void* stream) {
  const int bm = x_is_bf16 ? 64 : BM;
  if (R <= 0 || N <= 0 || K <= 0 || K % 4 || E <= 0 || kc < 1 || kc > 4 ||
      offsets == nullptr || m_tiles < (R + bm - 1) / bm ||
      (long long)E * m_tiles > 0x7fffffffLL || (long long)R * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int k_per_split = (K + TC_BK - 1) / TC_BK * TC_BK;
  return (int)launch_any(x, qp, cp, recip, shift, y, nullptr, R, K, N, bits,
                         kc, x_is_bf16, bm, 1, k_per_split,
                         (const int*)offsets, m_tiles, E, (cudaStream_t)stream);
}

}  // extern "C"
