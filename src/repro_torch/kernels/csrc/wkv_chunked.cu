// Chunked RWKV6 WKV (data-dependent-decay linear attention) for Hopper
// (sm_90a), with a carry-in state and the final state out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv_chunked.py
// (_kernel, pallas_call at :75; entry wkv_chunked at :66) in the form the
// model runs, wkv_chunked_jnp (:112): per head, with chunk length L = 16
// and in-chunk log-decays c[t] = Σ_{s≤t} log w_s (inclusive) and
// cp = c − log w (exclusive),
//
//   att[t,s] = Σ_k r[t,k]·k[s,k]·exp(cp[t,k] − c[s,k])    (s < t)
//   att[t,t] = Σ_k r[t,k]·u[k]·k[t,k]
//   y        = att·v + (r ⊙ exp(cp))·S
//   S       ← exp(c[L−1]) ⊙ S + (k ⊙ exp(c[L−1] − c))ᵀ·v
//
// Every exponent is a difference of a decreasing cumsum, so it is ≤ 0 and
// never overflows; exp(cp)·exp(−c) is never formed. log w is taken of
// max(w, 1e-30), so a decay that underflowed to 0 stays finite. y is
// rounded to r's type on the store, as the reference casts it. L is 16
// and not a tuning knob: the chunked form's rounding depends on it.
//
// What bounds it: the bytes (r, k, v once in their type, w in fp32, y
// out, S in and out) over ~3 operations per byte, so the card's bound is
// memory; the exps of the (L, L, K) pairwise decays (~8K per chunk and
// head) go to the special-function units.
//
// Design: the TPU kernel walks the chunks in its sequential grid axis
// with S in VMEM scratch. Here one block owns (head, slab of VS value
// columns) and walks the T/16 chunks in a loop with its (K, VS) slice of
// S in shared memory: the columns of S and y are independent, so a block
// needs only its slab of v and recomputes the small L×L att. The wrapper
// narrows the slab when there are too few heads to fill the SMs. Per
// chunk: load r, k, log w and the v slab (fp32, rows padded to K+1
// against bank conflicts), one thread per key column runs the cumsum,
// then the exponent terms, att (one thread per (t, s)), y (one thread per
// output), and the S update.
#include "common.cuh"

namespace {

constexpr int L = 16;
constexpr int THREADS = 256;

template <typename X>
__global__ void __launch_bounds__(THREADS)
wkv_kernel(const X* __restrict__ r, const X* __restrict__ k, const X* __restrict__ v,
           const float* __restrict__ w, const float* __restrict__ u,
           const float* __restrict__ s0, X* __restrict__ y, float* __restrict__ s_out,
           int T, int K, int V, int VS) {
  extern __shared__ float smem[];
  const int KP = K + 1, LP = L + 1;
  float* rs = smem;              // (L, KP) r
  float* ks = rs + L * KP;       // (L, KP) k
  float* cs = ks + L * KP;       // (L, KP) c, inclusive
  float* cps = cs + L * KP;      // (L, KP) cp = c − log w (log w first)
  float* rexp = cps + L * KP;    // (L, KP) r ⊙ exp(cp)
  float* kdec = rexp + L * KP;   // (L, KP) k ⊙ exp(c[L−1] − c)
  float* vs = kdec + L * KP;     // (L, VS) the v slab
  float* att = vs + L * VS;      // (L, LP)
  float* S = att + L * LP;       // (K, VS) the state slab
  float* us = S + K * VS;        // (K,)
  const int bh = blockIdx.x, j0 = blockIdx.y * VS, tid = threadIdx.x;
  const size_t baseK = (size_t)bh * T * K, baseV = (size_t)bh * T * V;

  for (int i = tid; i < K * VS; i += THREADS) {
    const int kk = i / VS, j = i % VS;
    S[i] = s0 ? s0[((size_t)bh * K + kk) * V + j0 + j] : 0.f;
  }
  for (int i = tid; i < K; i += THREADS) us[i] = u[(size_t)bh * K + i];

  for (int t0 = 0; t0 < T; t0 += L) {
    for (int i = tid; i < L * K; i += THREADS) {
      const int t = i / K, kk = i % K;
      const size_t g = baseK + (size_t)(t0 + t) * K + kk;
      rs[t * KP + kk] = rt::to_f(r[g]);
      ks[t * KP + kk] = rt::to_f(k[g]);
      cps[t * KP + kk] = logf(fmaxf(w[g], 1e-30f));
    }
    for (int i = tid; i < L * VS; i += THREADS) {
      const int t = i / VS, j = i % VS;
      vs[i] = rt::to_f(v[baseV + (size_t)(t0 + t) * V + j0 + j]);
    }
    __syncthreads();
    for (int kk = tid; kk < K; kk += THREADS) {
      float c = 0.f;
      for (int t = 0; t < L; ++t) {
        const float lw = cps[t * KP + kk];
        c = __fadd_rn(c, lw);
        cs[t * KP + kk] = c;
        cps[t * KP + kk] = __fsub_rn(c, lw);
      }
    }
    __syncthreads();
    for (int i = tid; i < L * K; i += THREADS) {
      const int t = i / K, kk = i % K, e = t * KP + kk;
      rexp[e] = rs[e] * expf(cps[e]);
      kdec[e] = ks[e] * expf(cs[(L - 1) * KP + kk] - cs[e]);
    }
    for (int i = tid; i < L * L; i += THREADS) {
      const int t = i / L, s = i % L;
      float a = 0.f;
      if (s < t) {
        for (int kk = 0; kk < K; ++kk)
          a += rs[t * KP + kk] * ks[s * KP + kk] * expf(cps[t * KP + kk] - cs[s * KP + kk]);
      } else if (s == t) {
        for (int kk = 0; kk < K; ++kk) a += rs[t * KP + kk] * us[kk] * ks[t * KP + kk];
      }
      att[t * LP + s] = a;
    }
    __syncthreads();
    for (int i = tid; i < L * VS; i += THREADS) {
      const int t = i / VS, j = i % VS;
      float intra = 0.f, inter = 0.f;
      for (int s = 0; s <= t; ++s) intra += att[t * LP + s] * vs[s * VS + j];
      for (int kk = 0; kk < K; ++kk) inter += rexp[t * KP + kk] * S[kk * VS + j];
      y[baseV + (size_t)(t0 + t) * V + j0 + j] = rt::from_f<X>(intra + inter);
    }
    __syncthreads();
    for (int i = tid; i < K * VS; i += THREADS) {
      const int kk = i / VS, j = i % VS;
      float upd = 0.f;
      for (int t = 0; t < L; ++t) upd += kdec[t * KP + kk] * vs[t * VS + j];
      S[i] = expf(cs[(L - 1) * KP + kk]) * S[i] + upd;
    }
    __syncthreads();
  }
  for (int i = tid; i < K * VS; i += THREADS) {
    const int kk = i / VS, j = i % VS;
    s_out[((size_t)bh * K + kk) * V + j0 + j] = S[i];
  }
}

template <typename X>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                   const float* u, const float* s0, void* y, float* s_out, int BH,
                   int T, int K, int V, int VS, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (6 * L * (K + 1) + L * VS + L * (L + 1) + K * VS + K);
  auto kern = wkv_kernel<X>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(BH, V / VS), THREADS, smem, st>>>((const X*)r, (const X*)k, (const X*)v,
                                                w, u, s0, (X*)y, s_out, T, K, V, VS);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k (BH, T, K) and v (BH, T, V) in one type (bf16 when x_is_bf16, else
// fp32); w (BH, T, K), u (BH, K), s0 (BH, K, V) or null, all fp32 →
// y (BH, T, V) in r's type, s_out (BH, K, V) fp32. T % 16 == 0,
// V % VS == 0, K and V at most 128.
int wkv_chunked(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s_out, int BH, int T,
                int K, int V, int VS, int x_is_bf16, void* stream) {
  if (BH <= 0 || T <= 0 || T % L != 0 || K <= 0 || K > 128 || V <= 0 || V > 128 ||
      VS <= 0 || V % VS != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto *wf = (const float*)w, *uf = (const float*)u, *sf = (const float*)s0;
  if (x_is_bf16)
    return (int)launch<__nv_bfloat16>(r, k, v, wf, uf, sf, y, (float*)s_out, BH, T, K,
                                      V, VS, st);
  return (int)launch<float>(r, k, v, wf, uf, sf, y, (float*)s_out, BH, T, K, V, VS,
                            st);
}

}  // extern "C"
