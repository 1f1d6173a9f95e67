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
// never overflows; exp(cp)·exp(−c) is never formed, and each pair (t, s)
// takes its own exponential. log w is taken of max(w, 1e-30), so a decay
// that underflowed to 0 stays finite. c and cp are kept times log2(e), so
// an exponential is one ex2.approx of the same difference (relative error
// ≲ |exponent|·2^-23; results below 2^-126 flush to 0). y is rounded to
// r's type on the store, as the reference casts it. L is 16 and not a
// tuning knob: the chunked form's rounding depends on it.
//
// What bounds it: the bytes (r, k, v once in their type, w in fp32, y
// out, S in and out) over ~3 operations per byte, so the card's bound is
// memory, and the fp32 CUDA cores would take about as long for the same
// operations. The (L, L, K) pairwise exponentials (~8K per chunk and head)
// go to the special-function units at 16 a clock and SM. In practice the
// kernel is bound by the 16 dependent chunks of each head: per chunk a
// block runs log w, att beside the next chunk's terms, the products, and
// the exchange, each phase a few thousand cycles while five blocks share
// an SM (PERF.md).
//
// Design. A cluster of two blocks owns (head, slab of VS <= 64 value
// columns; wkv_plan in kernels/wkv_chunked.py picks VS) and walks the
// T/16 chunks in a loop. The two blocks split the keys: block `rank` owns
// keys rank·KPH.. (K padded to 2·KPH, KPH = 32 or 64), so each computes
// the exponent terms, att and its share of y over half the keys and keeps
// S for those keys; y is the sum of the two shares, exchanged through
// distributed shared memory (block 0 keeps rows t 0-7, block 1 rows
// 8-15). Nothing is computed twice, and 2·BH blocks spread evenly over
// the SMs. A block is four warps; per chunk:
//
// - prefetch: the v slab of chunk n+1 is requested with 16-byte cp.async
//   into the other half of a double buffer at the top of chunk n, and
//   chunk n+2's r, k, w (the block's keys of 16 rows) into their single
//   buffer once chunk n+1's exponent terms have read it, so no global
//   load is exposed;
// - log w of chunk n+1, in place, by all threads;
// - warp 3: chunk n+1's exponent terms (a lane a key: the cumsum in order,
//   r·exp(cp), k·exp(c_last − c), exp(c_last); two sets by chunk parity),
//   beside warps 0-2: chunk n's att. The causal triangle is cut into ten
//   4x4 (t, s) tiles; a tile belongs to KPH/4 lanes, one per group of
//   four keys, each summing its keys for the tile's pairs, and a shuffle
//   reduce-scatter leaves the pairs spread over the lanes. A warp takes
//   tiles of one kind (off-diagonal or diagonal) so its code path is
//   uniform, and the diagonal tiles compute no exponential above or on
//   the diagonal (r·u·k there), so none is wasted;
// - y and the S update on the tensor cores, in fp32 accuracy: warp j
//   holds S for slab columns 16j..16j+15 and the block's keys as the
//   accumulator fragments of mma.sync m16n8k8 (rows: columns, columns:
//   keys). S ← exp(c_last)·S + vᵀ·kdec is one product over the 16 rows t;
//   y = S·(r·exp(cp))ᵀ + vᵀ·attᵀ reads S's accumulator registers straight
//   as the A operand (the key order inside each group of eight permuted,
//   and the B operand's rows with it). Every fp32 operand is split into a
//   TF32 high part and its remainder, and each product takes three MMAs
//   (hi·hi + hi·lo + lo·hi, error ~2^-21 of a product); a bf16 v is exact
//   in TF32 and needs two. No operand is rounded to TF32 or bf16 alone;
// - y: a block sends the peer's rows of its share and arrives at the
//   cluster barrier; it waits one chunk later, adds the peer's share
//   (block 0's first) and stores y.
//
// Three block barriers a chunk (landed, log w written, att written) and
// one split cluster barrier.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int L = 16;
constexpr int AP = 20;         // att row pitch (floats), conflict-free B reads
constexpr float LOG2E = 1.4426950408889634f;
enum { VEC_RKW = 1, VEC_V = 2 };

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Bytes of dynamic shared memory of a block with KPH keys (the layout of
// wkv_kernel below).
__host__ __device__ inline size_t smem_bytes(int xsize, int KPH) {
  const size_t pset = (size_t)4 * L * (KPH + 4) + 2 * L * (KPH + 8) + KPH;
  const size_t f32 = 2 * pset + 2 * L * AP + 2 * 4 * 32 * 4 + KPH;
  const size_t raw = (size_t)2 * L * KPH * xsize + (size_t)L * KPH * 4;
  return 4 * f32 + raw + (size_t)2 * L * 64 * xsize;
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

// x ≈ hi + lo as TF32 operands without a conversion instruction: hi is x
// rounded to TF32 (ties away) by integer arithmetic on its bits, lo the
// exact remainder x − hi, which the tensor core reads to TF32 by dropping
// its low 13 bits; the remainder's error is below 2^-21 of |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// d += a·b, m16n8k8, TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in fp32 accuracy from split operands (a_lo all 0 when EXACT_A:
// bf16 inputs are exact in TF32)
template <bool EXACT_A>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (!EXACT_A) mma(d, al, bh[0], bh[1]);
  mma(d, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
}

// One step of a shuffle reduce-scatter over the lanes that differ in bit
// `o`: of the 2·HALF values, a lane keeps the upper half if its bit is
// set, else the lower, and adds its partner's copy of the kept half.
template <int HALF>
__device__ __forceinline__ void reduce_half(float* v, bool upper, int o) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

template <typename X> __device__ __forceinline__ float ld_f(const X* p) { return rt::to_f(*p); }

template <int KPH>
constexpr int min_blocks() { return KPH == 32 ? 5 : 3; }

// A cluster of two blocks owns (head, slab of VS <= 64 value columns);
// block `rank` owns the KPH keys rank·KPH.. (K padded to 2·KPH). A block
// is four warps, warp j holding S for slab columns 16j..16j+15 and the
// block's keys as KPH/8 accumulator tiles.
template <typename X, int KPH>
__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(128, min_blocks<KPH>())
wkv_kernel(const X* __restrict__ r, const X* __restrict__ k, const X* __restrict__ v,
           const float* __restrict__ w, const float* __restrict__ u,
           const float* __restrict__ s0, X* __restrict__ y, float* __restrict__ s_out,
           int T, int K, int V, int VS, int flags) {
  namespace cg = cooperative_groups;
  constexpr int NTW = KPH / 8;         // key tiles of eight
  constexpr int KA = KPH + 4;          // r, k, cp, c row pitch (16-byte rows)
  constexpr int KPP = KPH + 8;         // rexp / kdec row pitch: conflict-free B reads
  constexpr int PSZ = 4 * L * KA + 2 * L * KPP + KPH;   // one set of exponent terms
  constexpr int LT = KPH / 4;          // lanes of an att tile (key quads): 8 or 16
  constexpr int TPW = 32 / LT;         // att tiles a warp takes at once
  constexpr int KEEP = 16 / LT;        // att entries a lane keeps
  constexpr int JOBS = LT == 8 ? 3 : 5;
  // tiles by slot: off-diagonal jobs first (15: no tile), then diagonal
  constexpr unsigned long long ORDER = LT == 8 ? 0x9520FF876431ull : 0x9520876431ull;
  constexpr int DIAG0 = LT == 8 ? 8 : 6;
  constexpr int VSP = 64;              // v slab row pitch
  constexpr bool BF16 = sizeof(X) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two sets (by chunk parity) of: r, k, cp·log2 e, c·log2 e (L, KA),
  // r·exp(cp), k·exp(c_last − c) (L, KPP), exp(c_last) (KPH)
  float* pset = reinterpret_cast<float*>(smem_raw);
  float* att_hi = pset + 2 * PSZ;                     // (L, AP) TF32 high part
  float* att_lo = att_hi + L * AP;                    // (L, AP) TF32 remainder
  float* recv = att_lo + L * AP;                      // (2, 4 warps, 32, 4) the peer's y
  float* us = recv + 2 * 4 * 32 * 4;                  // (KPH) u
  X* rb = reinterpret_cast<X*>(us + KPH);             // (L, KPH) r of the next chunk
  X* kb = rb + L * KPH;                               // (L, KPH) k
  float* wb = reinterpret_cast<float*>(kb + L * KPH); // (L, KPH) w
  X* vbuf = reinterpret_cast<X*>(wb + L * KPH);       // 2 x (L, VSP) v slab

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* peer_recv = cluster.map_shared_rank(recv, rank ^ 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, jw = 16 * warp;
  const int bh = blockIdx.x, j0 = (blockIdx.y >> 1) * VS;
  const int width = min(VS, V - j0);
  const int kofs = rank * KPH, kl = max(0, min(K - kofs, KPH));   // live keys
  const int nchunks = T / L;

  for (int i = tid; i < KPH; i += 128) us[i] = i < kl ? u[(size_t)bh * K + kofs + i] : 0.f;
  for (int i = tid; i < L * AP; i += 128) att_hi[i] = att_lo[i] = 0.f;

  // S as accumulator fragments: S[nt][0..3] = S[key][col] at keys
  // kofs+8nt+2q (+1) and slab columns jw+g (+8)
  float S[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * nt + 2 * q + (e & 1), col = jw + g + 8 * (e >> 1);
      S[nt][e] = (s0 != nullptr && key < kl && col < width)
                     ? s0[((size_t)bh * K + kofs + key) * V + j0 + col]
                     : 0.f;
    }

  auto fetch_rkw = [&](int n) {
    const size_t gk = ((size_t)bh * T + (size_t)n * L) * K + kofs;
    if (flags & VEC_RKW) {
      const int rk_row = kl * (int)sizeof(X) / 16, w_row = kl * 4 / 16;
      for (int c = tid; c < L * rk_row; c += 128) {
        const int t = c / rk_row, cc = c - t * rk_row;
        const size_t src = gk + (size_t)t * K;
        sm90::cp_async16(sm90::smem_addr(reinterpret_cast<char*>(rb + t * KPH) + 16 * cc),
                         reinterpret_cast<const char*>(r + src) + 16 * cc);
        sm90::cp_async16(sm90::smem_addr(reinterpret_cast<char*>(kb + t * KPH) + 16 * cc),
                         reinterpret_cast<const char*>(k + src) + 16 * cc);
      }
      for (int c = tid; c < L * w_row; c += 128) {
        const int t = c / w_row, cc = c - t * w_row;
        sm90::cp_async16(sm90::smem_addr(reinterpret_cast<char*>(wb + t * KPH) + 16 * cc),
                         reinterpret_cast<const char*>(w + gk + (size_t)t * K) + 16 * cc);
      }
    } else {
      for (int i = tid; i < L * KPH; i += 128) {
        const int t = i / KPH, j = i - t * KPH;
        if (j < kl) {
          rb[i] = r[gk + (size_t)t * K + j];
          kb[i] = k[gk + (size_t)t * K + j];
          wb[i] = w[gk + (size_t)t * K + j];
        }
      }
    }
    sm90::cp_async_commit();
  };
  auto fetch_v = [&](int n) {
    X* vb = vbuf + (n & 1) * L * VSP;
    const size_t gv = ((size_t)bh * T + (size_t)n * L) * V + j0;
    if (flags & VEC_V) {
      const int per_row = width * (int)sizeof(X) / 16;
      for (int c = tid; c < L * per_row; c += 128) {
        const int t = c / per_row, cc = c - t * per_row;
        sm90::cp_async16(
            sm90::smem_addr(reinterpret_cast<char*>(vb + t * VSP) + 16 * cc),
            reinterpret_cast<const char*>(v + gv + (size_t)t * V) + 16 * cc);
      }
    } else {
      for (int i = tid; i < L * width; i += 128) {
        const int t = i / width, j = i - t * width;
        vb[t * VSP + j] = v[gv + (size_t)t * V + j];
      }
    }
    sm90::cp_async_commit();
  };

  // log w of the landed chunk, in place, by all threads
  auto log_w = [&]() {
    for (int i = tid; i < L * KPH; i += 128)
      if (i % KPH < kl) wb[i] = logf(fmaxf(wb[i], 1e-30f));
  };
  // exponent terms of the landed chunk (log w in place) into set `ps`, by
  // warp 3: a lane a key, the cumsum in order, then the terms
  auto exponent_terms = [&](float* ps) {
    float* rr = ps;
    float* kk = rr + L * KA;
    float* cpl = kk + L * KA;
    float* cl = cpl + L * KA;
    float* rexp = cl + L * KA;
    float* kdec = rexp + L * KPP;
    float* dec = kdec + L * KPP;
    for (int kc = lane; kc < KPH; kc += 32) {
      const bool live = kc < kl;
      float lw[L], cv[L];
      float c = 0.f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        lw[t] = live ? wb[t * KPH + kc] : 0.f;
        c = __fadd_rn(c, lw[t]);
        cv[t] = c;
      }
      const float last2 = __fmul_rn(c, LOG2E);
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const float cpv = __fmul_rn(__fsub_rn(cv[t], lw[t]), LOG2E);
        const float c2 = __fmul_rn(cv[t], LOG2E);
        const float rv = live ? ld_f(rb + t * KPH + kc) : 0.f;
        const float kv = live ? ld_f(kb + t * KPH + kc) : 0.f;
        rr[t * KA + kc] = rv;
        kk[t * KA + kc] = kv;
        cpl[t * KA + kc] = cpv;
        cl[t * KA + kc] = c2;
        rexp[t * KPP + kc] = rv * ex2(cpv);
        kdec[t * KPP + kc] = kv * ex2(last2 - c2);
      }
      dec[kc] = live ? ex2(last2) : 0.f;
    }
  };

  // y of chunk m: this block's kept share plus the peer's, in rank order
  auto store_y = [&](int m, float4 mine) {
    const float4 other = *reinterpret_cast<const float4*>(recv + (((m & 1) * 4 + warp) * 32 + lane) * 4);
    const float o4[4] = {other.x, other.y, other.z, other.w};
    const float k4[4] = {mine.x, mine.y, mine.z, mine.w};
    X* yb = y + ((size_t)bh * T + (size_t)m * L) * V + j0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 8 * rank + 2 * q + (e & 1), col = jw + g + 8 * (e >> 1);
      const float val = rank ? __fadd_rn(o4[e], k4[e]) : __fadd_rn(k4[e], o4[e]);
      if (col < width) yb[(size_t)t * V + col] = rt::from_f<X>(val);
    }
  };
  float4 kept = make_float4(0.f, 0.f, 0.f, 0.f);

  fetch_rkw(0);
  fetch_v(0);
  cluster.sync();                                      // both blocks running
  sm90::cp_async_wait<0>();
  __syncthreads();
  log_w();
  __syncthreads();
  if (warp == 3) exponent_terms(pset);
  __syncthreads();                                     // raw buffer read
  if (nchunks > 1) fetch_rkw(1);
  for (int n = 0; n < nchunks; ++n) {
    sm90::cp_async_wait<0>();
    __syncthreads();          // chunk n's terms written, n+1's r, k, w and n's v landed
    if (n + 1 < nchunks) {
      fetch_v(n + 1);
      log_w();
    }
    __syncthreads();                                   // n+1's log w written
    const X* vb = vbuf + (n & 1) * L * VSP;
    const float* ps = pset + (n & 1) * PSZ;
    const float* cpl = ps + 2 * L * KA;
    const float* cl = cpl + L * KA;
    const float* rexp = cl + L * KA;
    const float* kdec = rexp + L * KPP;
    const float* dec = kdec + L * KPP;

    if (warp == 3) {
      // -- the next chunk's exponent terms, beside this chunk's att
      if (n + 1 < nchunks) exponent_terms(pset + ((n + 1) & 1) * PSZ);
    } else {
      // -- att over this block's keys, tile by tile: the LT lanes of a
      //    tile each sum four keys, a warp takes TPW tiles of one kind
      const float* rr = ps;
      const float* kk = rr + L * KA;
      const int lt = lane % LT, kq = 4 * lt;
      float uq[4];
      load4(us + kq, uq);
      for (int job = warp; job < JOBS; job += 3) {
        const int slot = job * TPW + lane / LT;
        const int tile = (int)((ORDER >> (4 * slot)) & 15);
        const bool active = tile != 15, diag = slot >= DIAG0;   // diag: uniform in the warp
        const int tt = active ? tile : 0;
        const int tq = tt >= 6 ? 3 : tt >= 3 ? 2 : tt >= 1 ? 1 : 0;
        const int sq = tt - tq * (tq + 1) / 2;
        float ra[4][4], pa[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          load4(rr + (4 * tq + a) * KA + kq, ra[a]);
          load4(cpl + (4 * tq + a) * KA + kq, pa[a]);
        }
        float acc[16];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float kb4[4], cb[4];
          load4(kk + (4 * sq + b) * KA + kq, kb4);
          load4(cl + (4 * sq + b) * KA + kq, cb);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            float s = 0.f;
            if (!diag || a > b) {
#pragma unroll
              for (int e = 0; e < 4; ++e) s += ra[a][e] * kb4[e] * ex2(pa[a][e] - cb[e]);
            } else if (a == b) {
#pragma unroll
              for (int e = 0; e < 4; ++e) s += ra[a][e] * uq[e] * kb4[e];
            }
            acc[a * 4 + b] = s;
          }
        }
        if (LT == 16) reduce_half<8>(acc, lt & 8, 8);
        reduce_half<(LT == 16 ? 4 : 8)>(acc, lt & 4, 4);
        reduce_half<(LT == 16 ? 2 : 4)>(acc, lt & 2, 2);
        reduce_half<(LT == 16 ? 1 : 2)>(acc, lt & 1, 1);
        if (active) {
#pragma unroll
          for (int e = 0; e < KEEP; ++e) {
            const int idx = lt * KEEP + e;
            const int at = (4 * tq + (idx >> 2)) * AP + 4 * sq + (idx & 3);
            uint32_t hi, lo;
            split(acc[e], hi, lo);
            att_hi[at] = __uint_as_float(hi);
            att_lo[at] = __uint_as_float(lo);
          }
        }
      }
    }
    __syncthreads();                                   // att written, raw buffer read
    if (n + 2 < nchunks) fetch_rkw(n + 2);

    // -- v of the warp's columns as A fragments (rows: columns jw+g (+8),
    //    k: rows t = 8ks + q (+4)); bf16 is exact in TF32
    uint32_t vh[2][4], vl[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = ld_f(vb + (8 * ks + q + 4 * (e >> 1)) * VSP + jw + g + 8 * (e & 1));
        if (BF16) {
          vh[ks][e] = __float_as_uint(x);
          vl[ks][e] = 0u;
        } else {
          split(x, vh[ks][e], vl[ks][e]);
        }
      }

    // -- this block's share of yᵀ (16 columns x 16 rows t): S·(r·exp(cp))ᵀ
    //    + vᵀ·attᵀ over its keys
    float yacc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < NTW; ++ks) {
      // S's accumulator registers as A: column q ↔ key 8ks+2q, q+4 ↔ 8ks+2q+1
      uint32_t ah[4], al[4];
      split(S[ks][0], ah[0], al[0]);
      split(S[ks][2], ah[1], al[1]);
      split(S[ks][1], ah[2], al[2]);
      split(S[ks][3], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 b = *reinterpret_cast<const float2*>(rexp + (8 * nt + g) * KPP + 8 * ks + 2 * q);
        uint32_t bh2[2], bl2[2];
        split(b.x, bh2[0], bl2[0]);
        split(b.y, bh2[1], bl2[1]);
        mma3<false>(yacc[nt], ah, al, bh2, bl2);
      }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int nt = ks; nt < 2; ++nt) {              // att[t][s] = 0 for s > t
        const int at = (8 * nt + g) * AP + 8 * ks + q;
        const uint32_t bh2[2] = {__float_as_uint(att_hi[at]), __float_as_uint(att_hi[at + 4])};
        const uint32_t bl2[2] = {__float_as_uint(att_lo[at]), __float_as_uint(att_lo[at + 4])};
        mma3<BF16>(yacc[nt], vh[ks], vl[ks], bh2, bl2);
      }

    // -- S ← exp(c_last)·S + vᵀ·kdec (rows t as the product's k)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const float2 d = *reinterpret_cast<const float2*>(dec + 8 * nt + 2 * q);
      S[nt][0] *= d.x;
      S[nt][1] *= d.y;
      S[nt][2] *= d.x;
      S[nt][3] *= d.y;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t bh2[2], bl2[2];
        split(kdec[(8 * ks + q) * KPP + 8 * nt + g], bh2[0], bl2[0]);
        split(kdec[(8 * ks + q + 4) * KPP + 8 * nt + g], bh2[1], bl2[1]);
        mma3<BF16>(S[nt], vh[ks], vl[ks], bh2, bl2);
      }
    }

    // -- y: block 0 keeps rows 0-7 and sends rows 8-15 to block 1, which
    //    keeps 8-15; both add block 0's share first. The cluster barrier
    //    is split: a block arrives once its share is sent and waits one
    //    chunk later, before it adds the peer's share of the previous
    //    chunk, so the barrier's latency hides behind a chunk of work.
    if (n > 0) {
      cluster_wait();
      store_y(n - 1, kept);
    }
    const float4 send = rank ? make_float4(yacc[0][0], yacc[0][1], yacc[0][2], yacc[0][3])
                             : make_float4(yacc[1][0], yacc[1][1], yacc[1][2], yacc[1][3]);
    kept = rank ? make_float4(yacc[1][0], yacc[1][1], yacc[1][2], yacc[1][3])
                : make_float4(yacc[0][0], yacc[0][1], yacc[0][2], yacc[0][3]);
    *reinterpret_cast<float4*>(peer_recv + (((n & 1) * 4 + warp) * 32 + lane) * 4) = send;
    cluster_arrive();
  }
  cluster_wait();
  store_y(nchunks - 1, kept);

#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * nt + 2 * q + (e & 1), col = jw + g + 8 * (e >> 1);
      if (key < kl && col < width)
        s_out[((size_t)bh * K + kofs + key) * V + j0 + col] = S[nt][e];
    }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename X, int KPH>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                   const float* u, const float* s0, void* y, float* s_out, int BH,
                   int T, int K, int V, int VS, cudaStream_t st) {
  const size_t smem = smem_bytes(sizeof(X), KPH);
  const int xs = (int)sizeof(X);
  int flags = 0;
  if (aligned16(r) && aligned16(k) && aligned16(w) && (K * xs) % 16 == 0 && K % 4 == 0)
    flags |= VEC_RKW;
  if (aligned16(v) && (V * xs) % 16 == 0 && (VS >= V || (VS * xs) % 16 == 0))
    flags |= VEC_V;
  auto kern = wkv_kernel<X, KPH>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(BH, 2 * ((V + VS - 1) / VS)), 128, smem, st>>>(
      (const X*)r, (const X*)k, (const X*)v, w, u, s0, (X*)y, s_out, T, K, V, VS, flags);
  return cudaGetLastError();
}

template <typename X>
cudaError_t launch_kp(const void* r, const void* k, const void* v, const float* w,
                      const float* u, const float* s0, void* y, float* s_out, int BH,
                      int T, int K, int V, int VS, cudaStream_t st) {
  if (VS > 64) return cudaErrorInvalidValue;
  if (K <= 64) return launch<X, 32>(r, k, v, w, u, s0, y, s_out, BH, T, K, V, VS, st);
  return launch<X, 64>(r, k, v, w, u, s0, y, s_out, BH, T, K, V, VS, st);
}

}  // namespace

extern "C" {

// r, k (BH, T, K) and v (BH, T, V) in one type (bf16 when x_is_bf16, else
// fp32); w (BH, T, K), u (BH, K), s0 (BH, K, V) or null, all fp32 →
// y (BH, T, V) in r's type, s_out (BH, K, V) fp32. T % 16 == 0, K and V at
// most 128; VS value columns a block (wkv_plan), at most 64.
int wkv_chunked(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s_out, int BH, int T,
                int K, int V, int VS, int x_is_bf16, void* stream) {
  if (BH <= 0 || T <= 0 || T % L != 0 || K <= 0 || K > 128 || V <= 0 || V > 128 ||
      VS <= 0 || VS > V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto *wf = (const float*)w, *uf = (const float*)u, *sf = (const float*)s0;
  if (x_is_bf16)
    return (int)launch_kp<__nv_bfloat16>(r, k, v, wf, uf, sf, y, (float*)s_out, BH, T,
                                         K, V, VS, st);
  return (int)launch_kp<float>(r, k, v, wf, uf, sf, y, (float*)s_out, BH, T, K, V, VS,
                               st);
}

// Dynamic shared memory of one block (wkv_plan's smem, for the record).
int wkv_chunked_smem(int K, int x_is_bf16) {
  return (int)smem_bytes(x_is_bf16 ? 2 : 4, K <= 64 ? 32 : 64);
}

}  // extern "C"
