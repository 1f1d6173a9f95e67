// The gradient of the chunked RWKV6 WKV (wkv_chunked.cu) for Hopper
// (sm_90a): given ȳ (the gradient on y) and S̄ (on the final state), dr,
// dk, dv, dw, du and ds0.
//
// Replaces no TPU kernel: the JAX package differentiates the jnp form
// wkv_chunked_jnp (src/repro/kernels/wkv_chunked.py:112) with jax.vjp, and
// this kernel computes the same gradient for the port's autograd Function
// (WkvChunked in kernels/wkv_chunked.py). Per head, with dS_t the gradient
// on the state after step t (dS_T = S̄) and w clamped to max(w, 1e-30) as
// the forward's log clamps it:
//
//   dS_{t-1} = w_t ⊙ dS_t + r_t ȳ_tᵀ,               ds0 = dS_0
//   dr_t[i]  = Σ_j S_{t-1}[i,j] ȳ_t[j] + u_i k_t[i] (v_t · ȳ_t)
//   dk_t[i]  = Σ_j dS_t[i,j] v_t[j]    + u_i r_t[i] (v_t · ȳ_t)
//   dv_t[j]  = Σ_i dS_t[i,j] k_t[i]    + ȳ_t[j] Σ_i r_t[i] u_i k_t[i]
//   du_i     = Σ_t r_t[i] k_t[i] (v_t · ȳ_t)
//   dw_t[i]  = Σ_j S_{t-1}[i,j] dS_t[i,j] where w_t[i] > 1e-30, else 0
//
// Every element (i, j) of the state is a scalar recurrence of its own;
// only the sums couple them. The states S_{t-1} are recomputed forwards
// and never recovered from S_t by dividing by w, which underflows.
//
// What bounds it: about 14 fp32 operations a state element and step (the
// state forwards, its gradient backwards, and the four sums), ~35 a byte
// of input and output at the shapes of training (K = V = 64). Taken at
// the card's peak operation rate (989 TFLOP/s), as every kernel's bound
// is, that is below the time its bytes take at 3.35 TB/s, so its bound is
// its bytes; on the CUDA cores alone (67 TFLOP/s) the operations would
// take about twice that. This first kernel is bound in practice by the two walks over T of
// dependent steps a block makes and the per-chunk sums out of shared
// memory (PERF.md); the chunked (GLA-style) backward on the tensor cores is
// its second pass (ROADMAP).
//
// Design. A block of 512 threads owns (head, slab of VS value columns),
// K·VS <= 1024 state elements, two a thread (VS = 16 at K = 64: four
// blocks a head). Each thread keeps its elements' S and dS in registers.
//
// A. Forward sweep over the chunks of 16 steps: the state entering each
//    chunk is stored to a scratch (BH, T/16, K, V) (the block's slab), and
//    the chunk's k, w, v are staged in shared memory for the steps.
// B. The chunks backwards: r, k, w, v, ȳ of the chunk staged, the states
//    recomputed from the chunk's entering state into spre[t] = S_{t-1},
//    then dS walked back through the chunk into sds[t] = dS_t. Both are
//    (16, K, VS+1) in shared memory (the pad keeps the row reads of the
//    sums conflict-free). Then the sums of the chunk: a thread a (t, key)
//    row for dr, dk and dw over the slab's columns, a thread a (t, column)
//    for dv over every key (complete in the block), and a thread a key
//    accumulating du. dr, dk, dw and du are partial over the slab: they
//    go to a scratch (3, BH, NS, T, K) and (BH, NS, K), and
// C. a second kernel adds the NS slabs' partials in slab order and writes
//    dr, dk in the input type and dw, du in fp32.
//
// Deterministic: every sum is taken by one thread in a fixed order, the
// slabs are added in a fixed order by the second pass, and there are no
// atomics, so two launches on the same inputs give the same bytes.
#include "common.cuh"

namespace {

constexpr int L = 16;                  // steps a chunk
constexpr int THREADS = 512;
constexpr int EPT = 2;                 // state elements a thread
constexpr int ELEMS = THREADS * EPT;   // K·VS at most
constexpr float W_MIN = 1e-30f;        // the forward's clamp of w

// Bytes of dynamic shared memory of a block (the layout of wkv_bwd_kernel).
__host__ __device__ inline size_t bwd_smem_bytes(int K, int VS) {
  const size_t f = (size_t)3 * L * K + (size_t)2 * L * VS + K + 2 * L +
                   (size_t)2 * L * K * (VS + 1);
  return 4 * f;
}

template <typename X>
__global__ void __launch_bounds__(THREADS, 1)
wkv_bwd_kernel(const X* __restrict__ r, const X* __restrict__ k, const X* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, const X* __restrict__ yb,
               const float* __restrict__ sb, X* __restrict__ dv,
               float* __restrict__ ds0, float* __restrict__ s_chunk,
               float* __restrict__ part, float* __restrict__ part_u, int BH, int T,
               int K, int V, int VS) {
  extern __shared__ __align__(16) float sm[];
  const int VP = VS + 1;
  float* sr = sm;                      // (L, K) r
  float* sk = sr + L * K;              // (L, K) k
  float* sw = sk + L * K;              // (L, K) max(w, 1e-30)
  float* sv = sw + L * K;              // (L, VS) v of the slab
  float* sy = sv + L * VS;             // (L, VS) ȳ of the slab
  float* su = sy + L * VS;             // (K) u
  float* svy = su + K;                 // (L) v·ȳ over the slab
  float* sruk = svy + L;               // (L) Σ_i r u k over every key
  float* spre = sruk + L;              // (L, K, VP) S_{t-1}
  float* sds = spre + (size_t)L * K * VP;   // (L, K, VP) dS_t

  const int bh = blockIdx.x, slab = blockIdx.y, NS = gridDim.y;
  const int j0 = slab * VS, width = min(VS, V - j0);
  const int tid = threadIdx.x;
  const int nchunks = T / L;
  const size_t hk = (size_t)bh * T * K;     // the head in r, k, w
  const size_t hv = (size_t)bh * T * V;     // the head in v, ȳ, dv
  const size_t sk0 = (size_t)bh * K * V;    // the head in s0, S̄, ds0
  const size_t P = (size_t)BH * NS * T * K; // one of dr, dk, dw in part

  int ei[EPT], ej[EPT], es[EPT];
  bool act[EPT];
  float S[EPT], dS[EPT];
#pragma unroll
  for (int m = 0; m < EPT; ++m) {
    const int e = tid + THREADS * m;
    ei[m] = e / VS;
    ej[m] = e - ei[m] * VS;
    act[m] = ei[m] < K && ej[m] < width;
    es[m] = ei[m] * VP + ej[m];
    S[m] = act[m] && s0 ? s0[sk0 + (size_t)ei[m] * V + j0 + ej[m]] : 0.f;
  }
  for (int i = tid; i < K; i += THREADS) su[i] = u[(size_t)bh * K + i];

  // stage k, w (and r) of chunk n, and v (and ȳ) of the slab
  auto stage = [&](int n, bool back) {
    const size_t base = hk + (size_t)n * L * K;
    for (int x = tid; x < L * K; x += THREADS) {
      sk[x] = rt::to_f(k[base + x]);
      sw[x] = fmaxf(w[base + x], W_MIN);
      if (back) sr[x] = rt::to_f(r[base + x]);
    }
    for (int x = tid; x < L * VS; x += THREADS) {
      const int t = x / VS, jj = x - t * VS;
      const size_t o = hv + (size_t)(n * L + t) * V + j0 + jj;
      const bool in = jj < width;
      sv[x] = in ? rt::to_f(v[o]) : 0.f;
      if (back) sy[x] = in ? rt::to_f(yb[o]) : 0.f;
    }
  };

  // -- A: the forward sweep; the state entering each chunk to the scratch
  for (int n = 0; n < nchunks; ++n) {
    float* sc = s_chunk + ((size_t)bh * nchunks + n) * K * V + j0;
#pragma unroll
    for (int m = 0; m < EPT; ++m)
      if (act[m]) sc[(size_t)ei[m] * V + ej[m]] = S[m];
    stage(n, false);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < L; ++t)
#pragma unroll
      for (int m = 0; m < EPT; ++m)
        if (act[m])
          S[m] = fmaf(sw[t * K + ei[m]], S[m], sk[t * K + ei[m]] * sv[t * VS + ej[m]]);
    __syncthreads();
  }

  // -- B: the chunks backwards
#pragma unroll
  for (int m = 0; m < EPT; ++m)
    dS[m] = act[m] && sb ? sb[sk0 + (size_t)ei[m] * V + j0 + ej[m]] : 0.f;
  float du_acc = 0.f;   // thread i < K: key i's du over the slab
  for (int n = nchunks - 1; n >= 0; --n) {
    const float* sc = s_chunk + ((size_t)bh * nchunks + n) * K * V + j0;
#pragma unroll
    for (int m = 0; m < EPT; ++m) S[m] = act[m] ? sc[(size_t)ei[m] * V + ej[m]] : 0.f;
    stage(n, true);
    __syncthreads();
    // the chunk's step sums, by warp 0 while the others recompute
    if (tid < L) {
      float a = 0.f;
      for (int jj = 0; jj < width; ++jj) a += sv[tid * VS + jj] * sy[tid * VS + jj];
      svy[tid] = a;
    } else if (tid < 2 * L) {
      const int t = tid - L;
      float a = 0.f;
      for (int i = 0; i < K; ++i) a += sr[t * K + i] * su[i] * sk[t * K + i];
      sruk[t] = a;
    }
    // the chunk's states: spre[t] = S_{t-1}
#pragma unroll
    for (int t = 0; t < L; ++t)
#pragma unroll
      for (int m = 0; m < EPT; ++m)
        if (act[m]) {
          spre[t * K * VP + es[m]] = S[m];
          S[m] = fmaf(sw[t * K + ei[m]], S[m], sk[t * K + ei[m]] * sv[t * VS + ej[m]]);
        }
    // back through the chunk: sds[t] = dS_t, then dS_{t-1}
#pragma unroll
    for (int t = L - 1; t >= 0; --t)
#pragma unroll
      for (int m = 0; m < EPT; ++m)
        if (act[m]) {
          sds[t * K * VP + es[m]] = dS[m];
          dS[m] = fmaf(sw[t * K + ei[m]], dS[m], sr[t * K + ei[m]] * sy[t * VS + ej[m]]);
        }
    __syncthreads();
    // dr, dk, dw over the slab's columns: a (t, key) row a thread
    for (int x = tid; x < L * K; x += THREADS) {
      const int t = x / K, i = x - t * K;
      const float* pre = spre + (size_t)(t * K + i) * VP;
      const float* ds = sds + (size_t)(t * K + i) * VP;
      const float *yr = sy + t * VS, *vr = sv + t * VS;
      float a = 0.f, b = 0.f, c = 0.f;
      for (int jj = 0; jj < width; ++jj) {
        a += pre[jj] * yr[jj];
        b += ds[jj] * vr[jj];
        c += pre[jj] * ds[jj];
      }
      const float uvy = su[i] * svy[t];
      const size_t o = (((size_t)bh * NS + slab) * T + n * L + t) * K + i;
      part[o] = a + sk[x] * uvy;
      part[P + o] = b + sr[x] * uvy;
      part[2 * P + o] = sw[x] > W_MIN ? c : 0.f;
    }
    // dv over every key: a (t, column) a thread
    for (int x = tid; x < L * width; x += THREADS) {
      const int t = x / width, jj = x - t * width;
      float a = 0.f;
      for (int i = 0; i < K; ++i) a += sds[(size_t)(t * K + i) * VP + jj] * sk[t * K + i];
      dv[hv + (size_t)(n * L + t) * V + j0 + jj] =
          rt::from_f<X>(a + sy[t * VS + jj] * sruk[t]);
    }
    if (tid < K)
      for (int t = 0; t < L; ++t) du_acc += sr[t * K + tid] * sk[t * K + tid] * svy[t];
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < EPT; ++m)
    if (act[m] && ds0) ds0[sk0 + (size_t)ei[m] * V + j0 + ej[m]] = dS[m];
  if (tid < K) part_u[((size_t)bh * NS + slab) * K + tid] = du_acc;
}

// C: the slabs' partials added in slab order
template <typename X>
__global__ void __launch_bounds__(256)
wkv_bwd_combine(const float* __restrict__ part, const float* __restrict__ part_u,
                X* __restrict__ dr, X* __restrict__ dk, float* __restrict__ dw,
                float* __restrict__ du, int BH, int NS, int T, int K) {
  const size_t TK = (size_t)T * K, n = (size_t)BH * TK, P = n * NS;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x; x < n; x += stride) {
    const size_t bh = x / TK;
    const float* p = part + bh * NS * TK + (x - bh * TK);
    float a = 0.f, b = 0.f, c = 0.f;
    for (int s = 0; s < NS; ++s) {
      a += p[s * TK];
      b += p[P + s * TK];
      c += p[2 * P + s * TK];
    }
    dr[x] = rt::from_f<X>(a);
    dk[x] = rt::from_f<X>(b);
    dw[x] = c;
    if (x < (size_t)BH * K) {
      const size_t h = x / K, i = x - h * K;
      float d = 0.f;
      for (int s = 0; s < NS; ++s) d += part_u[(h * NS + s) * K + i];
      du[x] = d;
    }
  }
}

template <typename X>
cudaError_t launch_bwd(const void* r, const void* k, const void* v, const float* w,
                       const float* u, const float* s0, const void* yb, const float* sb,
                       void* dr, void* dk, void* dv, float* dw, float* du, float* ds0,
                       float* s_chunk, float* part, float* part_u, int BH, int T, int K,
                       int V, int VS, cudaStream_t st) {
  const int NS = (V + VS - 1) / VS;
  const size_t smem = bwd_smem_bytes(K, VS);
  auto kern = wkv_bwd_kernel<X>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(BH, NS), THREADS, smem, st>>>(
      (const X*)r, (const X*)k, (const X*)v, w, u, s0, (const X*)yb, sb, (X*)dv, ds0,
      s_chunk, part, part_u, BH, T, K, V, VS);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)BH * T * K;
  const int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  wkv_bwd_combine<X><<<blocks, 256, 0, st>>>(part, part_u, (X*)dr, (X*)dk, dw, du, BH,
                                             NS, T, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k (BH, T, K), v and y_bar (BH, T, V) in one type (bf16 when
// x_is_bf16, else fp32); w (BH, T, K), u (BH, K), s0 and s_bar (BH, K, V)
// or null, fp32 → dr, dk (BH, T, K) and dv (BH, T, V) in that type, dw
// (BH, T, K), du (BH, K) and ds0 (BH, K, V, null when s0 is) in fp32.
// Scratch: s_chunk (BH, T/16, K, V), part (3, BH, NS, T, K), part_u (BH,
// NS, K) fp32, NS = ceil(V / VS). T % 16 == 0, K and V at most 128, VS
// value columns a block with K·VS <= 1024 (wkv_bwd_slab).
int wkv_chunked_bwd(const void* r, const void* k, const void* v, const void* w,
                    const void* u, const void* s0, const void* y_bar, const void* s_bar,
                    void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
                    void* s_chunk, void* part, void* part_u, int BH, int T, int K, int V,
                    int VS, int x_is_bf16, void* stream) {
  if (BH <= 0 || T <= 0 || T % L != 0 || K <= 0 || K > 128 || V <= 0 || V > 128 ||
      VS <= 0 || VS > V || K * VS > ELEMS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto *wf = (const float*)w, *uf = (const float*)u, *sf = (const float*)s0,
             *sbf = (const float*)s_bar;
  auto *dwf = (float*)dw, *duf = (float*)du, *ds0f = (float*)ds0, *sc = (float*)s_chunk,
       *pf = (float*)part, *puf = (float*)part_u;
  if (x_is_bf16)
    return (int)launch_bwd<__nv_bfloat16>(r, k, v, wf, uf, sf, y_bar, sbf, dr, dk, dv,
                                          dwf, duf, ds0f, sc, pf, puf, BH, T, K, V, VS, st);
  return (int)launch_bwd<float>(r, k, v, wf, uf, sf, y_bar, sbf, dr, dk, dv, dwf, duf,
                                ds0f, sc, pf, puf, BH, T, K, V, VS, st);
}

// Dynamic shared memory of one block of the first pass.
int wkv_chunked_bwd_smem(int K, int VS) { return (int)bwd_smem_bytes(K, VS); }

}  // extern "C"
