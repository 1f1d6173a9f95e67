// Fused decode attention over the slot KV cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (_fused_kernel, pallas_call at :164): one query token per slot
// attends over that slot's cache rows with an online softmax. INT8 codes
// are dequantized per sub-channel chunk as (q - Z) / S next to the dot
// product; an entry is valid when 0 <= kv_pos <= q_pos; the G = Hq/Hkv
// query heads of a group share one pass over their kv-head (K/V are
// never broadcast to Hq); chunks with no valid entry are skipped; an
// empty slot returns exact 0.
//
// What bounds it: every valid cache entry is read once and used for
// 4*G*D flops, so at the serving shapes (G = 1 for stablelm, 16 for
// chatglm3) it is bound by the bytes of the codes and per-entry scales.
//
// Design: one block per (kv-head, slot) walks T in chunks of 32 rows.
// The block first tests the chunk's positions (one syncthreads_or) and
// skips dead chunks without touching their codes; otherwise it
// dequantizes the K chunk into shared memory (neighbouring threads read
// neighbouring bytes of a row), forms the G x 32 scores, updates the
// running max and sum with one warp per query head (lane = row), then
// dequantizes the V chunk into the same buffer and accumulates P.V.
// The fp32 state stays in shared memory for the whole sweep. N * Hkv
// blocks leave most of the 132 SMs idle for the GQA archs; splitting T
// across blocks (flash-decoding) is later work.
#include "common.cuh"

namespace {

constexpr int TC = 32;
constexpr int THREADS = 128;

template <typename KV>
__device__ __forceinline__ float load_kv(const KV* p, size_t i, const float* s,
                                         const float* z, size_t si) {
  return rt::to_f(p[i]);
}
template <>
__device__ __forceinline__ float load_kv<int8_t>(const int8_t* p, size_t i,
                                                 const float* s, const float* z,
                                                 size_t si) {
  return rt::dequant_kv(p[i], s[si], z[si]);
}

template <typename KV, typename Q>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const Q* __restrict__ q, const KV* __restrict__ k,
              const KV* __restrict__ v, const int* __restrict__ kv_pos,
              const int* __restrict__ q_pos, const float* __restrict__ ks,
              const float* __restrict__ kz, const float* __restrict__ vs,
              const float* __restrict__ vz, Q* __restrict__ o, int T, int Hq,
              int Hkv, int D, int C, float qscale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, n = blockIdx.y;
  const int G = Hq / Hkv;
  const int DP = D + 1;                      // padded row: no bank conflicts
  float* qs = smem;                          // [G][D]
  float* acc = qs + G * D;                   // [G][D]
  float* kvs = acc + G * D;                  // [TC][D+1]
  float* S = kvs + TC * DP;                  // [G][TC]
  float* m_run = S + G * TC;                 // [G]
  float* l_run = m_run + G;                  // [G]
  float* corr = l_run + G;                   // [G]
  int* valid = (int*)(corr + G);             // [TC]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = blockDim.x / 32;
  const int qp = q_pos[n];
  const int cl = D / max(C, 1);

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    qs[i] = __fmul_rn(rt::to_f(q[((size_t)n * Hq + h * G + g) * D + d]), qscale);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_run[g] = rt::NEG_INF;
    l_run[g] = 0.f;
  }

  for (int t0 = 0; t0 < T; t0 += TC) {
    int any = 0;
    if (tid < TC) {
      const int t = t0 + tid;
      const int p = t < T ? kv_pos[(size_t)n * T + t] : -1;
      valid[tid] = (p >= 0) && (p <= qp);
      any = valid[tid];
    }
    if (!__syncthreads_or(any)) continue;

    // K chunk → shared (dequantized), rows past T read as 0
    for (int i = tid; i < TC * D; i += blockDim.x) {
      const int t = i / D, d = i % D;
      float val = 0.f;
      if (t0 + t < T) {
        const size_t row = ((size_t)n * T + t0 + t) * Hkv + h;
        val = load_kv<KV>(k, row * D + d, ks, kz, row * C + d / cl);
      }
      kvs[t * DP + d] = val;
    }
    __syncthreads();
    for (int i = tid; i < G * TC; i += blockDim.x) {
      const int g = i / TC, t = i % TC;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qs[g * D + d], kvs[t * DP + d], s);
      S[i] = valid[t] ? s : rt::NEG_INF;
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      const float s = S[g * TC + lane];
      const float m_new = fmaxf(m_run[g], rt::warp_max(s));
      const float p = valid[lane] ? expf(s - m_new) : 0.f;
      S[g * TC + lane] = p;
      const float sum = rt::warp_sum(p);
      if (lane == 0) {
        const float c = expf(m_run[g] - m_new);
        corr[g] = c;
        l_run[g] = l_run[g] * c + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < TC * D; i += blockDim.x) {
      const int t = i / D, d = i % D;
      float val = 0.f;
      if (t0 + t < T) {
        const size_t row = ((size_t)n * T + t0 + t) * Hkv + h;
        val = load_kv<KV>(v, row * D + d, vs, vz, row * C + d / cl);
      }
      kvs[t * DP + d] = val;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      float a = 0.f;
      for (int t = 0; t < TC; ++t) a = fmaf(S[g * TC + t], kvs[t * DP + d], a);
      acc[i] = acc[i] * corr[g] + a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    const float l = l_run[g];
    const float out = l > 0.f ? acc[i] / fmaxf(l, 1e-30f) : 0.f;
    o[((size_t)n * Hq + h * G + g) * D + d] = rt::from_f<Q>(out);
  }
}

template <typename KV, typename Q>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_pos,
                   const int* q_pos, const float* ks, const float* kz,
                   const float* vs, const float* vz, void* o, int N, int T,
                   int Hq, int Hkv, int D, int C, float qscale, cudaStream_t st) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * (2 * G * D + TC * (D + 1) + G * TC + 3 * G) + sizeof(int) * TC;
  auto kern = decode_kernel<KV, Q>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(Hkv, N), THREADS, smem, st>>>(
      (const Q*)q, (const KV*)k, (const KV*)v, kv_pos, q_pos, ks, kz, vs, vz,
      (Q*)o, T, Hq, Hkv, D, C, qscale);
  return cudaGetLastError();
}

// The slot cache holds int8 codes or fp32 values (engine.kvcache).
template <typename Q>
cudaError_t dispatch_kv(int int8, const void* q, const void* k, const void* v,
                        const int* kv_pos, const int* q_pos, const float* ks,
                        const float* kz, const float* vs, const float* vz,
                        void* o, int N, int T, int Hq, int Hkv, int D, int C,
                        float qscale, cudaStream_t st) {
  if (int8)
    return launch<int8_t, Q>(q, k, v, kv_pos, q_pos, ks, kz, vs, vz, o, N, T, Hq,
                             Hkv, D, C, qscale, st);
  return launch<float, Q>(q, k, v, kv_pos, q_pos, ks, kz, vs, vz, o, N, T, Hq,
                          Hkv, D, C, qscale, st);
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* kv_pos, const void* q_pos,
                                const void* ks, const void* kz, const void* vs,
                                const void* vz, void* o, int N, int T, int Hq,
                                int Hkv, int D, int C, int int8, int q_is_bf16,
                                float qscale, void* stream) {
  if (N <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      (int8 && (C <= 0 || D % C != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* kp = (const int*)kv_pos;
  const auto* qp = (const int*)q_pos;
  const auto *a = (const float*)ks, *b = (const float*)kz, *c = (const float*)vs,
             *d = (const float*)vz;
  if (q_is_bf16)
    return (int)dispatch_kv<__nv_bfloat16>(int8, q, k, v, kp, qp, a, b, c, d, o, N,
                                           T, Hq, Hkv, D, C, qscale, st);
  return (int)dispatch_kv<float>(int8, q, k, v, kp, qp, a, b, c, d, o, N, T, Hq,
                                 Hkv, D, C, qscale, st);
}
