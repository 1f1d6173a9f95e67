// Fused chunked-prefill attention over one slot's KV cache for Hopper
// (sm_90a), with the chunk's K/V quantized in an epilogue launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/prefill_attention.py
// (_prefill_kernel, pallas_call at :299; entry prefill_attention at
// :407) in its fp and int8 per-entry (dynamic) modes. One prompt chunk
// of Sq queries attends (a) the slot's cache rows that were written
// before the chunk (valid iff 0 <= kv_pos < pos_start; INT8 codes are
// dequantized per sub-channel chunk as (q - Z) / S) and (b) the chunk's
// own full-precision K/V under the causal mask key <= query and
// key < length, with an online softmax across both.
//
// What bounds it: every live cache row (D code bytes plus 2*C fp32
// scales for each of K and V) is used by the Sq*G queries of its
// kv-head, 4*Sq*G*D flops for K and V together. At Sq = 96, G = 1,
// D = 64, C = 4 that is ~128 flops per byte, below the ~295 flop/byte
// ridge of the bf16 tensor cores (989 TFLOP/s over 3.35 TB/s), so the
// card's bound is the bytes. This kernel does the work as fp32 FMAs on
// the CUDA cores (67 TFLOP/s, a ~20 flop/byte ridge), which makes it
// slower than that bound by construction; a tensor-core (wgmma)
// formulation is later work.
//
// Design: one block per (query block, kv-head). A block owns R = Bq*G
// query rows (G heads of one group for Bq queries) so K/V are read once
// per group and never broadcast to Hq. It walks the cache in chunks of
// 32 rows, skipping chunks with no valid row after one syncthreads_or,
// dequantizes each live K chunk into shared memory, forms R x 32 scores,
// updates the running max and sum with one warp per query row (lane =
// key row), then streams the V chunk through the same buffer. The chunk's
// own K/V follow through the same loop with the causal mask. Scores,
// running state and the output accumulator stay in shared memory.
//
// Epilogue (quantize_kv, a second launch from the same wrapper): one
// thread per (token, head, sub-channel chunk) computes min/max → (S, Z)
// → codes with common.cuh's exact-rounding helpers, so codes and scales
// are bit-identical to engine.kvcache.quantize_kv.
#include "common.cuh"

namespace {

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

template <typename KV, typename X>
__global__ void __launch_bounds__(THREADS)
prefill_kernel(const X* __restrict__ q, const X* __restrict__ kn,
               const X* __restrict__ vn, const KV* __restrict__ ck,
               const KV* __restrict__ cv, const int* __restrict__ kv_pos,
               const float* __restrict__ ks, const float* __restrict__ kz,
               const float* __restrict__ vs, const float* __restrict__ vz,
               X* __restrict__ o, int Sq, int T, int Hq, int Hkv, int D, int C,
               int Bq, int pos_start, int length, float qscale) {
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
    auto load = [&](const KV* base, const float* s, const float* z) {
      return [=](int t, int d) {
        if (t0 + t >= T) return 0.f;
        const size_t row = (size_t)(t0 + t) * Hkv + h;
        return load_cache<KV>(base, row * D + d, s, z, row * C + d / cl);
      };
    };
    int* valid = sm.valid;
    chunk_update(sm, R, D, load(ck, ks, kz), load(cv, vs, vz),
                 [=](int r, int t) { return valid[t] != 0; });
  }

  // (b) the chunk's own K/V, causal and < length
  const int q_last = min(Sq, q0 + Bq) - 1;
  for (int t0 = 0; t0 < Sq && t0 < length && t0 <= q_last; t0 += TC) {
    auto load = [&](const X* base) {
      return [=](int t, int d) {
        if (t0 + t >= Sq) return 0.f;
        return rt::to_f(base[((size_t)(t0 + t) * Hkv + h) * D + d]);
      };
    };
    chunk_update(sm, R, D, load(kn), load(vn), [=](int r, int t) {
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

// Per-(row, chunk) dynamic INT8 quantization, bit-identical to
// engine.kvcache.quantize_kv (value_range → qparams → quantize, bits=8,
// asymmetric).
template <typename X>
__global__ void quantize_kv_kernel(const X* __restrict__ x, int8_t* __restrict__ codes,
                                   float* __restrict__ scale, float* __restrict__ zero,
                                   int groups, int chunk_len) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= groups) return;
  const X* p = x + (size_t)gi * chunk_len;
  float beta = rt::to_f(p[0]), alpha = beta;
  for (int i = 1; i < chunk_len; ++i) {
    const float v = rt::to_f(p[i]);
    beta = fminf(beta, v);
    alpha = fmaxf(alpha, v);
  }
  const float s = rt::dyn_scale(beta, alpha, 255.f);
  const float z = rt::dyn_zero(s, beta, 8);
  scale[gi] = s;
  zero[gi] = z;
  int8_t* out = codes + (size_t)gi * chunk_len;
  for (int i = 0; i < chunk_len; ++i) out[i] = rt::quant_code(s, rt::to_f(p[i]), z, -128.f, 127.f);
}

template <typename KV, typename X>
cudaError_t launch(const void* q, const void* kn, const void* vn, const void* ck,
                   const void* cv, const int* kv_pos, const float* ks,
                   const float* kz, const float* vs, const float* vz, void* o,
                   int Sq, int T, int Hq, int Hkv, int D, int C, int pos_start,
                   int length, float qscale, cudaStream_t st) {
  const int G = Hq / Hkv;
  const int Bq = G >= 32 ? 1 : 32 / G;
  const int R = Bq * G;
  const size_t smem = sizeof(float) * (2 * R * D + TC * (D + 1) + R * TC + 3 * R) +
                      sizeof(int) * TC;
  auto kern = prefill_kernel<KV, X>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Sq + Bq - 1) / Bq, Hkv), THREADS, smem, st>>>(
      (const X*)q, (const X*)kn, (const X*)vn, (const KV*)ck, (const KV*)cv, kv_pos,
      ks, kz, vs, vz, (X*)o, Sq, T, Hq, Hkv, D, C, Bq, pos_start, length, qscale);
  return cudaGetLastError();
}

// The slot cache holds int8 codes or fp32 values (engine.kvcache).
template <typename X>
cudaError_t dispatch_cache(int int8, const void* q, const void* kn, const void* vn,
                           const void* ck, const void* cv, const int* kv_pos,
                           const float* ks, const float* kz, const float* vs,
                           const float* vz, void* o, int Sq, int T, int Hq,
                           int Hkv, int D, int C, int pos_start, int length,
                           float qscale, cudaStream_t st) {
  if (int8)
    return launch<int8_t, X>(q, kn, vn, ck, cv, kv_pos, ks, kz, vs, vz, o, Sq, T,
                             Hq, Hkv, D, C, pos_start, length, qscale, st);
  return launch<float, X>(q, kn, vn, ck, cv, kv_pos, ks, kz, vs, vz, o, Sq, T, Hq,
                          Hkv, D, C, pos_start, length, qscale, st);
}

}  // namespace

extern "C" {

int prefill_attention(const void* q, const void* kn, const void* vn,
                      const void* ck, const void* cv, const void* kv_pos,
                      const void* ks, const void* kz, const void* vs,
                      const void* vz, void* o, int Sq, int T, int Hq, int Hkv,
                      int D, int C, int pos_start, int length, int int8,
                      int x_is_bf16, float qscale, void* stream) {
  if (Sq <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      (int8 && (C <= 0 || D % C != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* kp = (const int*)kv_pos;
  const auto *a = (const float*)ks, *b = (const float*)kz, *c = (const float*)vs,
             *d = (const float*)vz;
  if (x_is_bf16)
    return (int)dispatch_cache<__nv_bfloat16>(int8, q, kn, vn, ck, cv, kp, a, b, c,
                                              d, o, Sq, T, Hq, Hkv, D, C,
                                              pos_start, length, qscale, st);
  return (int)dispatch_cache<float>(int8, q, kn, vn, ck, cv, kp, a, b, c, d, o, Sq,
                                    T, Hq, Hkv, D, C, pos_start, length, qscale,
                                    st);
}

// x (groups, chunk_len) → codes int8 (groups, chunk_len), scale/zero (groups,)
int quantize_kv(const void* x, void* codes, void* scale, void* zero, int groups,
                int chunk_len, int x_is_bf16, void* stream) {
  if (groups <= 0 || chunk_len <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 128, blocks = (groups + threads - 1) / threads;
  if (x_is_bf16)
    quantize_kv_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (int8_t*)codes, (float*)scale, (float*)zero, groups,
        chunk_len);
  else
    quantize_kv_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)x, (int8_t*)codes, (float*)scale, (float*)zero, groups,
        chunk_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
