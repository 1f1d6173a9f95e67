// Fused SplitQuant dequant-matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/splitquant_matmul.py
// (_kernel, pallas_call at :83):
//     y[m, n] = sum_k x[m, k] * W[k, n],
//     W[k, n] = q[k, n] * recip[cid[k, n], n] + shift[cid[k, n], n]
// with q packed 8/bits per byte along K and cid packed four per byte.
//
// What bounds it: on the serving path M is the decode batch (8 slots)
// or one prompt chunk (<= 96 rows), far below the ~295 FLOP/byte ridge
// of the H100, so the kernel is bound by the bytes of the packed weight
// (0.75 B per element at INT4 with 2-bit cluster ids).
//
// Design: each warp lane owns 4 neighbouring output columns, so a warp
// reads 128 neighbouring bytes of a packed row (one 4-byte load per lane
// when aligned): the code and cid streams load coalesced. A block covers
// BM=8 rows of x x 128 columns; its 8 warps split each 64-deep K tile,
// x tiles are staged in shared memory and read as broadcasts, and the
// partial sums of the warps are added in a fixed order at the end. The
// weight is dequantized in fp32 (separate multiply and add, as the
// reference rounds them), rounded to x's type as ref.py:37 does, and
// accumulated in fp32. When the grid would leave SMs idle (a narrow N at
// decode), K is also split across blocks: each split writes fp32 partial
// sums to a workspace that a second small kernel adds in split order, so
// the result is deterministic. Ragged M, N and K edges are masked, not
// padded. A wgmma/TMA pipeline is later work.
#include "common.cuh"

namespace {

constexpr int BM = 8;
constexpr int BN = 128;
constexpr int WARPS = 8;
constexpr int BK = 64;
constexpr int ROWS_PER_WARP = BK / WARPS;

__device__ __forceinline__ float pick(const float (&v)[4], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}

template <int BITS, typename T>
__global__ void __launch_bounds__(WARPS * 32)
sq_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ qp,
                 const uint8_t* __restrict__ cp, const float* __restrict__ recip,
                 const float* __restrict__ shift, T* __restrict__ y,
                 float* __restrict__ ws, int M, int K, int N, int kc,
                 int k_per_split) {
  constexpr int PER = 8 / BITS;
  constexpr int MASK = (1 << BITS) - 1;
  constexpr int QMIN = -(1 << (BITS - 1));
  __shared__ float xs[BM][BK];
  __shared__ float part[WARPS][BM][BN];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;
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
      xs[r][kk] = (m < M && kg < k_hi) ? rt::to_f(x[(size_t)m * K + kg]) : 0.f;
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
          const int c = ((cb >> (8 * j)) >> cs) & 3;
          const float deq = __fadd_rn(__fmul_rn((float)(u + QMIN), pick(rc[j], c)),
                                      pick(sh[j], c));
          w[j] = rt::round_to<T>(deq);
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
        y[(size_t)mg * N + ng] = rt::from_f<T>(s);
      else
        ws[((size_t)blockIdx.z * M + mg) * N + ng] = s;
    }
  }
}

template <typename T>
__global__ void split_reduce_kernel(const float* __restrict__ ws, T* __restrict__ y,
                                    int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[(size_t)z * MN + i];
  y[i] = rt::from_f<T>(s);
}

template <int BITS, typename T>
cudaError_t launch(const void* x, const uint8_t* qp, const uint8_t* cp,
                   const float* recip, const float* shift, void* y, float* ws,
                   int M, int K, int N, int kc, int splits, cudaStream_t st) {
  const int tiles = (K + BK - 1) / BK;
  const int per = (tiles + splits - 1) / splits;
  const int k_per_split = per * BK;
  splits = (tiles + per - 1) / per;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  sq_matmul_kernel<BITS, T><<<grid, WARPS * 32, 0, st>>>(
      (const T*)x, qp, cp, recip, shift, (T*)y, ws, M, K, N, kc, k_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int MN = M * N;
  split_reduce_kernel<T><<<(MN + 255) / 256, 256, 0, st>>>(ws, (T*)y, MN, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bits(int bits, const void* x, const uint8_t* qp,
                          const uint8_t* cp, const float* recip,
                          const float* shift, void* y, float* ws, int M, int K,
                          int N, int kc, int splits, cudaStream_t st) {
  switch (bits) {
    case 2: return launch<2, T>(x, qp, cp, recip, shift, y, ws, M, K, N, kc, splits, st);
    case 4: return launch<4, T>(x, qp, cp, recip, shift, y, ws, M, K, N, kc, splits, st);
    case 8: return launch<8, T>(x, qp, cp, recip, shift, y, ws, M, K, N, kc, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// y (M, N) = x (M, K) . W; x and y are bf16 when x_is_bf16, else fp32.
// ws: fp32 scratch of splits*M*N floats (unused when splits == 1).
int splitquant_matmul(const void* x, const void* qp, const void* cp,
                      const void* recip, const void* shift, void* y, void* ws,
                      int M, int K, int N, int bits, int kc, int x_is_bf16,
                      int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || kc < 1 || kc > 4 || splits < 1 ||
      (long long)M * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* q8 = (const uint8_t*)qp;
  const auto* c8 = (const uint8_t*)cp;
  const auto* r = (const float*)recip;
  const auto* s = (const float*)shift;
  if (x_is_bf16)
    return (int)dispatch_bits<__nv_bfloat16>(bits, x, q8, c8, r, s, y, (float*)ws,
                                             M, K, N, kc, splits, st);
  return (int)dispatch_bits<float>(bits, x, q8, c8, r, s, y, (float*)ws, M, K, N,
                                   kc, splits, st);
}

}  // extern "C"
