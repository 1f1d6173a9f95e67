// The decode attention kernel's templates and launchers, shared by
// decode_attention.cu (head_dims up to 128 and the C entry points) and
// decode_attention_d256.cu (the head_dim-256 instantiations), two nvcc
// processes that the build runs side by side. The design is described in
// decode_attention.cu.
#pragma once
#include "common.cuh"
#include "sm90.cuh"

#include <type_traits>

namespace decode_attn {

constexpr int TR = 32;          // rows per warp tile
constexpr int MAX_WARPS = 4;
constexpr int MAX_D = 256;      // columns per lane in P.V: ceil(D / 32) <= 8
constexpr int MAX_SPLITS = 64;  // the merge's weights fit any block's shared memory
constexpr int SMEM_MAX = 232448;

struct Args {
  const void *q, *k, *v;
  const int *kv_pos, *q_pos;
  const float *ks, *kz, *vs, *vz;
  void* o;
  float* part_o;   // (splits, N, Hq, D) fp32
  float* part_ml;  // (splits, N, Hq, 2): running max, sum
  int* counter;    // (N, Hkv * G / GB), 0 between calls
  int N, T, Hq, Hkv, D, C, cl_mul, rows, splits;  // chunk of column d: (d * cl_mul) >> 16
  int stat;        // ks..vz are per-layer (Hkv, C) constants
  float qscale;
};

// Per-warp shared-memory layout, in bytes. `by_row`: P.V runs with lane =
// row (GB = 1, D <= 64) and takes 1/S in registers, so a stage holds four
// scale arrays (S, Z of K, then of V) instead of six (with 1/S); with
// static scales (`stat`) it holds none.
struct Geo {
  int kp;     // pitch of a K or V code row: D * sizeof(KV) up to a power of
              // two of 16-byte pieces (D = 112: 128, 256 or 512 bytes)
  int sp;     // pitch of a scale row, in floats (odd: no bank conflicts)
  int na;     // scale arrays a stage holds
  int stage;  // one stage: K rows, V rows, then the scale arrays
  int warp;   // two stages, the P buffer and the tiles' valid-row masks
};

// 32-row tiles a warp walks at most: a split holds at most 4 * MAX_TW
// tiles (the launcher checks), and a warp keeps one valid-row mask each.
constexpr int MAX_TW = 64;

__host__ __device__ inline Geo geo(int D, int C, int kv_bytes, int GB, bool by_row,
                                   bool stat) {
  Geo g;
  g.kp = 16;
  while (g.kp < D * kv_bytes) g.kp *= 2;
  g.sp = C + 1;
  g.na = C && !stat ? (by_row ? 4 : 6) : 0;
  g.stage = (2 * TR * g.kp + g.na * TR * g.sp * 4 + 15) / 16 * 16;
  g.warp = (2 * g.stage + TR * (GB + 1) * 4 + MAX_TW * 4 + 15) / 16 * 16;
  return g;
}

// Bytes before the warps' regions: q (GB x D floats), on the row path q
// summed per sub-channel chunk (C floats), and with static scales their
// table (6 x C floats), rounded up to 16.
__host__ __device__ inline int head_bytes(int GB, int D, int C, bool by_row, bool stat) {
  return (GB * D * 4 + (by_row ? C * 4 : 0) + (stat ? 6 * C * 4 : 0) + 15) / 16 * 16;
}

// Byte offsets of the 16-byte chunks of a tile of `kp`-byte code rows:
// chunk c of row r lies at r * kp + 16 * (c ^ x(r)), x(r) the row's index
// among the rows that share a 128-byte bank window (modulo the chunks a
// row has, at most 8), so 8 lanes reading chunk c of 8 consecutive rows
// (lane = row) hit 8 different bank groups. kp is a power of two (Geo
// pads a row of 7, 14 or 28 pieces, D = 112, to 8, 16 or 32), so c ^ x(r)
// stays inside the row; the padding piece is never read.
struct Swizzle {
  int kp, shift, mask;
  __device__ Swizzle(int kp_) : kp(kp_) {
    const int nck = kp / 16;
    shift = kp >= 128 ? 0 : kp == 64 ? 1 : 2;   // log2(128 / kp), kp >= 32
    mask = (nck < 8 ? nck : 8) - 1;
  }
  __device__ __forceinline__ int x16(int r) const { return ((r >> shift) & mask) << 4; }
  __device__ __forceinline__ int at(int r, int c) const { return r * kp + ((c << 4) ^ x16(r)); }
};

// Four bf16 values (8 bytes) widened to floats exactly.
__device__ __forceinline__ float4 bf16x4_f(const unsigned char* p) {
  const uint2 w = *(const uint2*)p;
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// One float16 value (the low or high half of a word) widened exactly.
__device__ __forceinline__ float f16_f(uint32_t w, bool hi) {
  return __half2float(__ushort_as_half((unsigned short)(hi ? w >> 16 : w & 0xffffu)));
}

// Four float16 values (8 bytes) widened to floats exactly.
__device__ __forceinline__ float4 f16x4_f(const unsigned char* p) {
  const uint2 w = *(const uint2*)p;
  return make_float4(f16_f(w.x, false), f16_f(w.x, true), f16_f(w.y, false),
                     f16_f(w.y, true));
}

// Four cache values of a float cache (fp32, bf16 or float16) at element
// offset d of a row, through the row's chunk swizzle.
template <typename KV>
__device__ __forceinline__ float4 row4(const unsigned char* row, int d, int swl) {
  if constexpr (std::is_same<KV, __nv_bfloat16>::value) return bf16x4_f(row + ((d * 2) ^ swl));
  else if constexpr (std::is_same<KV, __half>::value) return f16x4_f(row + ((d * 2) ^ swl));
  else return *(const float4*)(row + ((d * 4) ^ swl));
}

// Log-sum-exp merge of `parts` partial states (max, sum, acc) of GB query
// heads in a fixed order, empty ones (sum 0) weighing 0. The weights come
// first, one (head, part) a thread; then each thread sums four
// neighbouring outputs at a time over the parts, with the loads of four
// such groups in flight together. ml(g, j) and acc4(g, j, d) read a part
// (acc4: columns d..d+3); out(g, d, value) writes one result.
template <int GB, typename ML, typename ACC, typename OUT>
__device__ __forceinline__ void merge_parts(float* wsm, int parts, int D, ML ml,
                                            ACC acc4, OUT out) {
  float* wt = wsm;                        // [GB][parts] weights
  float* lj = wsm + GB * parts;           // [GB][parts] sums
  float* ltot = wsm + 2 * GB * parts;     // [GB] total sum
  for (int i = threadIdx.x; i < GB * parts; i += blockDim.x) {
    const float2 v = ml(i / parts, i % parts);
    wt[i] = v.y > 0.f ? v.x : rt::NEG_INF;   // the part's max, if any
    lj[i] = v.y;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < GB; g += blockDim.x) {
    float M = rt::NEG_INF, L = 0.f;
    for (int j = 0; j < parts; ++j) M = fmaxf(M, wt[g * parts + j]);
    for (int j = 0; j < parts; ++j) {
      const float l = lj[g * parts + j];
      const float e = l > 0.f ? expf(wt[g * parts + j] - M) : 0.f;
      wt[g * parts + j] = e;
      L += l * e;
    }
    ltot[g] = L;
  }
  __syncthreads();
  constexpr int U = 4;
  const int n4 = GB * D / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += U * blockDim.x) {
    float4 A[U];
#pragma unroll
    for (int u = 0; u < U; ++u) A[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    // every part holds finite values (an empty one zeros), so the loads
    // need no condition and are all in flight together
#pragma unroll 4
    for (int j = 0; j < parts; ++j) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = min(i0 + u * (int)blockDim.x, n4 - 1);
        const int g = i / (D / 4), d = (i % (D / 4)) * 4;
        const float e = wt[g * parts + j];
        const float4 v = acc4(g, j, d);
        A[u].x = fmaf(v.x, e, A[u].x);
        A[u].y = fmaf(v.y, e, A[u].y);
        A[u].z = fmaf(v.z, e, A[u].z);
        A[u].w = fmaf(v.w, e, A[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= n4) break;
      const int g = i / (D / 4), d = (i % (D / 4)) * 4;
      const float L = ltot[g];
      const float r[4] = {A[u].x, A[u].y, A[u].z, A[u].w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out(g, d + k, L > 0.f ? __fdiv_rn(r[k], fmaxf(L, 1e-30f)) : 0.f);
    }
  }
}

// DM > 0 (GB = 1, D <= 64): P.V with lane = row as well, into DM >= D
// per-lane accumulators added across the warp once at the end; DM = 0:
// P.V with lane = columns (GB > 1, or D >= 112, where GB x D accumulators
// per lane would not fit in registers), DLM >= ceil(D / 32) columns a
// lane. The row path over an int8 cache is bounded to 128 registers a
// thread so that four blocks of four warps fit an SM.
template <int GB, int DM, typename KV, typename Q, int DLM>
__global__ void __launch_bounds__(MAX_WARPS * 32,
                                  DM > 0 && std::is_same<KV, int8_t>::value ? 4 : 1)
decode_split_kernel(Args a) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr bool BY_ROW = DM > 0;
  constexpr int NCH = GB == 1 ? 4 : 1;       // independent FMA chains in Q.K
  // scale arrays of a stage: S and Z of K and of V; 1/S of each unless
  // the row path takes it in registers
  constexpr int KS = 0, KZ = 1, KR = 2, VS = BY_ROW ? 2 : 3, VZ = VS + 1, VR = 5;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  const int D = a.D, C = a.C, DL = (D + 31) / 32;  // P.V columns a lane, the last masked
  const int G = a.Hq / a.Hkv, groups = G / GB;
  const int h = blockIdx.x / groups;
  const int hq0 = h * G + (blockIdx.x % groups) * GB;  // first query head
  const int n = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int W = blockDim.x / 32;
  const unsigned FULL = 0xffffffffu;
  const bool stat = INT8 && a.stat;
  const Geo gm = geo(D, C, (int)sizeof(KV), GB, BY_ROW, stat);
  const Swizzle sw(gm.kp);
  const int SQ = TR * gm.sp;                                // one scale array
  float* qs = (float*)smem;                                 // [GB][D]
  float* qsum = qs + GB * D;                                // [C], row path only
  float* stab = qsum + (BY_ROW ? C : 0);                    // [6][C], static only
  // where compute() reads a tile's scales: the stage's rows (pitch gm.sp,
  // arrays SQ apart), or the static table (pitch 0, arrays C apart)
  const int srp = stat ? 0 : gm.sp, saq = stat ? C : SQ;
  unsigned char* region = smem + head_bytes(GB, D, C, BY_ROW, stat);
  unsigned char* wbase = region + warp * gm.warp;
  float* P = (float*)(wbase + 2 * gm.stage);                // [TR][GB+1]
  uint32_t* vmask = (uint32_t*)(P + TR * (GB + 1));         // [MAX_TW]

  {  // q (pre-scaled): the GB heads' rows are contiguous; four loads in flight
    const Q* qg = (const Q*)a.q + ((size_t)n * a.Hq + hq0) * D;
    for (int i0 = tid; i0 < GB * D; i0 += 4 * blockDim.x) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        v[u] = i < GB * D ? rt::to_f(__ldg(qg + i)) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < GB * D) qs[i] = __fmul_rn(v[u], a.qscale);
      }
    }
  }
  if (stat) {  // the kv-head's per-layer S and Z (and 1/S on the column path)
    for (int c = tid; c < C; c += blockDim.x) {
      const float s_k = a.ks[h * C + c], s_v = a.vs[h * C + c];
      stab[KS * C + c] = s_k;
      stab[KZ * C + c] = a.kz[h * C + c];
      stab[VS * C + c] = s_v;
      stab[VZ * C + c] = a.vz[h * C + c];
      if (!BY_ROW) {
        stab[KR * C + c] = __frcp_rn(s_k);
        stab[VR * C + c] = __frcp_rn(s_v);
      }
    }
  }
  __syncthreads();
  if (INT8 && BY_ROW) {  // q summed over each sub-channel chunk
    const int cl = D / C;
    for (int c = tid; c < C; c += blockDim.x) {
      float t = 0.f;
      for (int d = 0; d < cl; ++d) t += qs[c * cl + d];
      qsum[c] = t;
    }
    __syncthreads();
  }

  const int qp = a.q_pos[n];
  const int lo = s * a.rows, hi = min(a.T, lo + a.rows);
  const int ntiles = (hi - lo + TR - 1) / TR;
  const int* pos = a.kv_pos + (size_t)n * a.T;
  const int rb = D * (int)sizeof(KV), nck = rb / 16;
  // the lane's (row, 16-byte chunk) and (row, scale) in a tile, and the
  // rows a pass covers where nck divides 32; C divides 32 (the launcher
  // checks). A row of 7, 14 or 28 chunks (D = 112) takes the chunks of
  // the tile in turn instead, TR * nck of them.
  const bool even = 32 % nck == 0;
  const int kr0 = even ? lane / nck : 0, kc0 = even ? lane % nck : 0,
            kstep = even ? 32 / nck : 0;
  const int sr0 = C ? lane / C : 0, sc0 = C ? lane % C : 0, sstep = C ? 32 / C : TR;

  // accr / bz4 (row path, int8): sum_r w_r code_{r,d} and sum_r w_r Z_r
  // per group of four columns, w_r = p_r / S_r; P.V = accr - bz4
  constexpr int NR = DM > 0 ? DM : 1;
  float m[GB], l[GB], acc[GB][DLM], accr[NR], bz4[(NR + 3) / 4];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = rt::NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DLM; ++i) acc[g][i] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < NR; ++d) accr[d] = 0.f;
#pragma unroll
  for (int j = 0; j < (NR + 3) / 4; ++j) bz4[j] = 0.f;

  auto pos_of = [&](int tile) {  // the lane's row of a tile; -1 past the range
    const int t = lo + tile * TR + lane;
    return tile < ntiles && t < hi ? pos[t] : -1;
  };
  auto ok = [&](int p) { return p >= 0 && p <= qp; };
  // codes and scales of a tile by cp.async; rows past the range are
  // zero-filled (scale 1) so that P.V may multiply them by p = 0
  auto issue = [&](int tile, int st) {
    const int t0 = lo + tile * TR;
    unsigned char* buf = wbase + st * gm.stage;
    auto piece = [&](int r, int c) {
      const int at = sw.at(r, c);
      unsigned char* dk = buf + at;
      unsigned char* dv = buf + TR * gm.kp + at;
      if (t0 + r >= hi) {
        *(uint4*)dk = make_uint4(0u, 0u, 0u, 0u);
        *(uint4*)dv = make_uint4(0u, 0u, 0u, 0u);
        return;
      }
      const size_t off = (((size_t)n * a.T + t0 + r) * a.Hkv + h) * rb + c * 16;
      sm90::cp_async16(sm90::smem_addr(dk), (const char*)a.k + off);
      sm90::cp_async16(sm90::smem_addr(dv), (const char*)a.v + off);
    };
    if (even)
      for (int r = kr0, c = kc0; r < TR; r += kstep) piece(r, c);
    else
      for (int i = lane; i < TR * nck; i += 32) piece(i / nck, i % nck);
    if (INT8 && !stat) {
      float* sb = (float*)(buf + 2 * TR * gm.kp);
      for (int r = sr0, c = sc0; r < TR; r += sstep) {
        const int so = r * gm.sp + c;
        if (t0 + r >= hi) {
          sb[KS * SQ + so] = sb[VS * SQ + so] = 1.f;
          sb[KZ * SQ + so] = sb[VZ * SQ + so] = 0.f;
          continue;
        }
        const size_t si = (((size_t)n * a.T + t0 + r) * a.Hkv + h) * C + c;
        sm90::cp_async4(sm90::smem_addr(sb + KS * SQ + so), a.ks + si);
        sm90::cp_async4(sm90::smem_addr(sb + KZ * SQ + so), a.kz + si);
        sm90::cp_async4(sm90::smem_addr(sb + VS * SQ + so), a.vs + si);
        sm90::cp_async4(sm90::smem_addr(sb + VZ * SQ + so), a.vz + si);
      }
    }
  };
  auto compute = [&](int st, bool valid) {
    unsigned char* buf = wbase + st * gm.stage;
    float* sb = stat ? stab : (float*)(buf + 2 * TR * gm.kp);
    if (INT8 && !BY_ROW && !stat) {  // the tile's reciprocal scales, once per (row, chunk)
      for (int r = sr0; r < TR; r += sstep) {
        const int so = r * gm.sp + sc0;
        sb[KR * SQ + so] = __frcp_rn(sb[KS * SQ + so]);
        sb[VR * SQ + so] = __frcp_rn(sb[VS * SQ + so]);
      }
      __syncwarp();
    }

    // Q.K: lane = row
    float sc[GB][NCH];
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int j = 0; j < NCH; ++j) sc[g][j] = 0.f;
    const unsigned char* kr = buf + lane * gm.kp;
    const int swl = sw.x16(lane);               // the lane's row's chunk XOR, x 16
    if (INT8 && BY_ROW) {
      // the scale folded out of each chunk c of the row:
      // s = sum_c (1/S_c) (sum_{d in c} q_d code_d - Z_c sum_{d in c} q_d)
      const float* srow = sb + lane * srp;
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      int c_cur = 0;
      auto fold = [&](int c) {
        const float tc = (t[0] + t[1]) + (t[2] + t[3]);
        sc[0][0] = fmaf(__frcp_rn(srow[KS * saq + c]),
                        fmaf(-srow[KZ * saq + c], qsum[c], tc), sc[0][0]);
        t[0] = t[1] = t[2] = t[3] = 0.f;
      };
#pragma unroll
      for (int d0 = 0; d0 < NR; d0 += 16) {
        if (d0 >= D) break;
        const uint4 raw = *(const uint4*)(kr + (d0 ^ swl));
        const uint32_t words[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                                   raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
        for (int sub = 0; sub < 4; ++sub) {
          const int d = d0 + 4 * sub, c = (d * a.cl_mul) >> 16;
          if (c != c_cur) {  // the same chunk on every lane
            fold(c_cur);
            c_cur = c;
          }
          const float4 q4 = *(const float4*)&qs[d];
          t[0] = fmaf(q4.x, rt::code_f(words[sub], 0), t[0]);
          t[1] = fmaf(q4.y, rt::code_f(words[sub], 1), t[1]);
          t[2] = fmaf(q4.z, rt::code_f(words[sub], 2), t[2]);
          t[3] = fmaf(q4.w, rt::code_f(words[sub], 3), t[3]);
        }
      }
      fold(c_cur);
    } else if (INT8) {
      const float* srow = sb + lane * srp;
      int c_cur = -1;
      float S = 1.f, Z = 0.f, R = 1.f;
      for (int d0 = 0; d0 < D; d0 += 16) {
        const uint4 raw = *(const uint4*)(kr + (d0 ^ swl));
        const uint32_t words[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                                   raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
        for (int sub = 0; sub < 4; ++sub) {
          // a chunk is a whole number of 4-column groups (cl % 4 == 0)
          const int d = d0 + 4 * sub, c = (d * a.cl_mul) >> 16;
          if (c != c_cur) {  // the same chunk on every lane
            c_cur = c;
            S = srow[KS * saq + c];
            Z = srow[KZ * saq + c];
            R = srow[KR * saq + c];
          }
          float kv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) kv[j] = rt::dequant_kv_rcp(rt::code_f(words[sub], j), S, R, Z);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            const float4 q4 = *(const float4*)&qs[g * D + d];
            float& acc_s = sc[g][sub % NCH];
            acc_s = fmaf(q4.x, kv[0], acc_s);
            acc_s = fmaf(q4.y, kv[1], acc_s);
            acc_s = fmaf(q4.z, kv[2], acc_s);
            acc_s = fmaf(q4.w, kv[3], acc_s);
          }
        }
      }
    } else {
      for (int d = 0; d < D; d += 4) {
        const float4 kv = row4<KV>(kr, d, swl);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float4 q4 = *(const float4*)&qs[g * D + d];
          float& acc_s = sc[g][(d / 4) % NCH];
          acc_s = fmaf(q4.x, kv.x, acc_s);
          acc_s = fmaf(q4.y, kv.y, acc_s);
          acc_s = fmaf(q4.z, kv.z, acc_s);
          acc_s = fmaf(q4.w, kv.w, acc_s);
        }
      }
    }

    // online softmax; the sum stays a per-lane partial
    float p_row = 0.f;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float sg = sc[g][0];
#pragma unroll
      for (int j = 1; j < NCH; ++j) sg += sc[g][j];
      const float sv = valid ? sg : rt::NEG_INF;
      const float m_new = fmaxf(m[g], rt::warp_max(sv));
      const float p = valid ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + p;
      m[g] = m_new;
      if constexpr (DM > 0) {
        if (corr != 1.f) {  // the same on every lane
#pragma unroll
          for (int d = 0; d < DM; ++d) accr[d] *= corr;
#pragma unroll
          for (int j = 0; j < DM / 4; ++j) bz4[j] *= corr;
        }
        p_row = p;
      } else {
#pragma unroll
        for (int i = 0; i < DLM; ++i) acc[g][i] *= corr;
        P[lane * (GB + 1) + g] = p;
      }
    }
    __syncwarp();

    if constexpr (DM > 0) {
      // P.V: lane = row; per chunk c of the row w = p / S_c, so that
      // p (code - Z_c) / S_c = w code - w Z_c: accr += w code, bz4 += w Z_c
      const unsigned char* vr = buf + (TR + lane) * gm.kp;
      if (INT8) {
        const float* srow = sb + lane * srp;
        int c_cur = -1;
        float w = 0.f, wz = 0.f;
#pragma unroll
        for (int d0 = 0; d0 < DM; d0 += 16) {
          if (d0 >= D) break;
          const uint4 raw = *(const uint4*)(vr + (d0 ^ swl));
          const uint32_t words[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                                     raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
          for (int sub = 0; sub < 4; ++sub) {
            const int d = d0 + 4 * sub, c = (d * a.cl_mul) >> 16;
            if (c != c_cur) {
              c_cur = c;
              w = p_row * __frcp_rn(srow[VS * saq + c]);
              wz = w * srow[VZ * saq + c];
            }
            bz4[d / 4] += wz;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              accr[d + j] = fmaf(w, rt::code_f(words[sub], j), accr[d + j]);
          }
        }
      } else {
#pragma unroll
        for (int d = 0; d < DM; d += 4) {
          if (d >= D) break;
          const float4 v4 = row4<KV>(vr, d, swl);
          accr[d] = fmaf(p_row, v4.x, accr[d]);
          accr[d + 1] = fmaf(p_row, v4.y, accr[d + 1]);
          accr[d + 2] = fmaf(p_row, v4.z, accr[d + 2]);
          accr[d + 3] = fmaf(p_row, v4.w, accr[d + 3]);
        }
      }
      return;
    }

    // P.V: lane = columns lane + 32 i < D; rows with p = 0 add 0
    const unsigned char* vb = buf + TR * gm.kp;
#pragma unroll
    for (int i = 0; i < DLM; ++i) {
      if (i >= DL) break;
      const int d = lane + 32 * i, c = INT8 ? (d * a.cl_mul) >> 16 : 0;
      if (d >= D) break;   // D = 112: lanes 16-31 have three columns
      // the column's 16-byte chunk (XORed by row, as the copy placed it)
      // and its 4-byte word within the chunk; its byte in that word
      const int db = d * (int)sizeof(KV), wo = (db & 15) & ~3, bj = db & 3;
#pragma unroll 4
      for (int r = 0; r < TR; ++r) {
        const uint32_t w = *(const uint32_t*)(vb + sw.at(r, db >> 4) + wo);
        float vv;
        if (INT8) {
          const float* srow = sb + r * srp + c;
          vv = rt::dequant_kv_rcp(rt::code_f(w ^ 0x80808080u, bj), srow[VS * saq],
                                  srow[VR * saq], srow[VZ * saq]);
        } else if (std::is_same<KV, __half>::value) {  // the word's low or high half
          vv = f16_f(w, bj != 0);
        } else if (sizeof(KV) == 2) {  // the bf16 in the word's low or high half
          vv = __uint_as_float(bj ? (w & 0xffff0000u) : (w << 16));
        } else {
          vv = __uint_as_float(w);
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) acc[g][i] = fmaf(P[r * (GB + 1) + g], vv, acc[g][i]);
      }
    }
  };

  // the warp's tiles: warp, warp + W, ...; first the valid-row mask of
  // each (one ballot over the lanes' rows), the positions of eight tiles
  // in flight at once, so the walk never waits on a position
  const int ntw = warp < ntiles ? (ntiles - warp + W - 1) / W : 0;
  for (int k0 = 0; k0 < ntw; k0 += 8) {
    int p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) p[u] = pos_of(warp + (k0 + u) * W);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const uint32_t msk = __ballot_sync(FULL, ok(p[u]));
      if (lane == 0 && k0 + u < ntw) vmask[k0 + u] = msk;
    }
  }
  __syncwarp();

  // the walk, double-buffered: a tile with no valid row is skipped
  // without touching its codes
  int cur = warp;
  bool cur_live = ntw > 0 && vmask[0] != 0;
  if (cur_live) issue(cur, 0);
  sm90::cp_async_commit();
  for (int it = 0; it < ntw; ++it) {
    const bool nxt_live = it + 1 < ntw && vmask[it + 1] != 0;
    if (nxt_live) issue(cur + W, (it + 1) & 1);
    sm90::cp_async_commit();
    if (cur_live) {
      sm90::cp_async_wait<1>();
      __syncwarp();
      compute(it & 1, (vmask[it] >> lane) & 1u);
      __syncwarp();  // the buffer is refilled in the next iteration
    }
    cur += W;
    cur_live = nxt_live;
  }
  sm90::cp_async_wait<0>();
#pragma unroll
  for (int g = 0; g < GB; ++g) l[g] = rt::warp_sum(l[g]);
  if constexpr (DM > 0) {  // the row-path accumulators, added across the warp
#pragma unroll
    for (int d = 0; d < DM; ++d) accr[d] = rt::warp_sum(accr[d]);
    if (INT8) {
#pragma unroll
      for (int j = 0; j < DM / 4; ++j) {
        const float b = rt::warp_sum(bz4[j]);
#pragma unroll
        for (int k = 0; k < 4; ++k) accr[4 * j + k] -= b;
      }
    }
  }

  // merge the block's warps in warp order
  __syncthreads();
  float* aw = (float*)region;        // [W][GB][D], 16-byte aligned (float4 reads)
  float* mw = aw + W * GB * D;       // [W][GB]
  float* lw = mw + W * GB;           // [W][GB]
  float* wsm = lw + W * GB;          // merge weights
  if constexpr (DM > 0) {
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D && d % 32 == lane) aw[warp * D + d] = accr[d];
  }
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int i = 0; i < DLM; ++i)
      if (DM == 0 && i < DL && lane + 32 * i < D) aw[(warp * GB + g) * D + lane + 32 * i] = acc[g][i];
    if (lane == 0) {
      mw[warp * GB + g] = m[g];
      lw[warp * GB + g] = l[g];
    }
  }
  __syncthreads();
  Q* out = (Q*)a.o;
  const size_t row0 = (size_t)n * a.Hq + hq0;
  if (a.splits == 1) {
    merge_parts<GB>(
        wsm, W, D, [&](int g, int w) { return make_float2(mw[w * GB + g], lw[w * GB + g]); },
        [&](int g, int w, int d) { return *(const float4*)&aw[(w * GB + g) * D + d]; },
        [&](int g, int d, float v) { out[(row0 + g) * D + d] = rt::from_f<Q>(v); });
    return;
  }
  // this split's partial: the warps' merge, unnormalized; each warp's
  // weight exp(m_w - M) per head first (0 for a warp with no valid row)
  float* ew = wsm;                   // [W][GB]
  for (int g = tid; g < GB; g += blockDim.x) {
    float M = rt::NEG_INF, L = 0.f;
    for (int w = 0; w < W; ++w)
      if (lw[w * GB + g] > 0.f) M = fmaxf(M, mw[w * GB + g]);
    for (int w = 0; w < W; ++w) {
      const float e = lw[w * GB + g] > 0.f ? expf(mw[w * GB + g] - M) : 0.f;
      ew[w * GB + g] = e;
      L += lw[w * GB + g] * e;
    }
    const size_t prow = (size_t)s * a.N * a.Hq + row0 + g;
    a.part_ml[2 * prow] = M;
    a.part_ml[2 * prow + 1] = L;
  }
  __syncthreads();
  for (int i = tid; i < GB * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float A = 0.f;
    for (int w = 0; w < W; ++w) A = fmaf(aw[(w * GB + g) * D + d], ew[w * GB + g], A);
    a.part_o[((size_t)s * a.N * a.Hq + row0 + g) * D + d] = A;
  }

  // the last block of this (slot, head group) merges the splits in order
  __threadfence();
  __syncthreads();
  int* counter = a.counter + (size_t)n * gridDim.x + blockIdx.x;
  if (tid == 0) last_block = atomicAdd(counter, 1) == a.splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const size_t stride = (size_t)a.N * a.Hq;
  merge_parts<GB>(
      wsm, a.splits, D,
      [&](int g, int j) {
        const size_t prow = j * stride + row0 + g;
        return make_float2(__ldcg(a.part_ml + 2 * prow), __ldcg(a.part_ml + 2 * prow + 1));
      },
      [&](int g, int j, int d) {
        return __ldcg((const float4*)(a.part_o + (j * stride + row0 + g) * D + d));
      },
      [&](int g, int d, float v) { out[(row0 + g) * D + d] = rt::from_f<Q>(v); });
  if (tid == 0) *counter = 0;
}

// Dynamic shared memory of a block, and the warps it launches with: the
// plan's warps, fewer if they would not fit.
inline size_t block_smem(int D, int C, int kv_bytes, int GB, bool stat, int& warps) {
  const bool by_row = GB == 1 && D <= 64;
  const Geo gm = geo(D, C, kv_bytes, GB, by_row, stat);
  for (; warps >= 1; --warps) {
    const size_t smem = (size_t)head_bytes(GB, D, C, by_row, stat) + (size_t)warps * gm.warp;
    if (smem <= SMEM_MAX) return smem;
  }
  return 0;
}

template <int GB, int DM, typename KV, typename Q, int DLM = 4>
cudaError_t launch(const Args& a, int warps, cudaStream_t st) {
  const size_t smem = block_smem(a.D, a.C, (int)sizeof(KV), GB, a.stat != 0, warps);
  if (warps < 1) return cudaErrorInvalidConfiguration;
  auto kern = decode_split_kernel<GB, DM, KV, Q, DLM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int G = a.Hq / a.Hkv;
  kern<<<dim3(a.Hkv * (G / GB), a.N, a.splits), warps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

// D = 256 (eight P.V columns a lane, at most 4 heads a block): its
// instantiations are compiled by an nvcc of their own, beside this one
// (decode_attention_d256.cu), for each cache and query type.
template <typename KV, typename Q>
cudaError_t dispatch_d256(const Args& a, int group, int warps, cudaStream_t st);

template <typename KV, typename Q>
cudaError_t dispatch_group(const Args& a, int group, int warps, cudaStream_t st) {
  if (a.D > 128) return dispatch_d256<KV, Q>(a, group, warps, st);
  switch (group) {
    case 16: return launch<16, 0, KV, Q>(a, warps, st);
    case 4: return launch<4, 0, KV, Q>(a, warps, st);
    case 1:  // lane = row in P.V up to D = 64; 128 accumulators would spill
      return a.D <= 64 ? launch<1, 64, KV, Q>(a, warps, st)
                       : launch<1, 0, KV, Q>(a, warps, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace decode_attn
