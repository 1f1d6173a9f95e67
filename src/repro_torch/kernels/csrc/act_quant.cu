// Activation split-quantization (paper §4.2) for Hopper (sm_90a): the
// dynamic per-(row, chunk) form and the static per-chunk form.
//
// Replaces the Pallas TPU kernels src/repro/kernels/act_quant.py:
//   _kernel        (pallas_call at :60; entry act_split_quantize at :48)
//   _static_kernel (pallas_call at :132; entry act_split_quantize_static
//                   at :106)
//
// What bounds them: both read x once and write int8 codes (plus two fp32
// per (row, chunk) for the dynamic form), a few operations per byte, so
// the card's bound is the bytes.
//
// Dynamic: a group of W warps (1, 2, 4 or 8, from the wrapper's
// dynamic_plan) owns one (row, chunk); a block of eight warps takes 8 / W
// consecutive (row, chunk) pairs, so its loads are one contiguous stretch
// of x. The chunk is read from HBM once: a scalar head up to the first
// 16-byte boundary of its x, whole 16-byte vectors (8 bf16 or 4 fp32),
// then a scalar tail; lane j of the group takes vectors j, j + G, ... (G
// lanes in the group), at most V of them, and one head or tail element.
// What bounds it is the bytes in flight: every vector of the chunk is
// copied by cp.async into the lane's own column of a shared-memory buffer
// (4·V KB a block) before the min/max reduction, so they wait there and
// not in registers (40 a thread; seven or eight blocks an SM, where
// holding them in registers allowed three). min/max are reduced by
// __shfl_xor_sync in the warp, then through shared memory across the
// group's warps. Every lane derives the same (S, Z) with common.cuh's
// exact helpers (as in the TPU kernel, and unlike core.quantize.qparams,
// a degenerate range gets zero 0) and quantizes its vectors from the
// buffer; codes leave as one 8-byte (bf16) or 4-byte (fp32) word a
// vector, byte by byte only where q's row is off that alignment relative
// to x's (a view whose data pointer is off a 16-byte boundary). A chunk
// wider than G·V vectors (bf16 past 16,384 columns, fp32 past 8,192)
// takes rounds of G·V vectors: min/max over all rounds, then each round
// copied again for its codes. Codes, scales and zeros are bit-identical
// to the reference.
//
// Static: a thread owns eight consecutive columns over a group of rows
// (see act_quant_static_kernel). The per-chunk (S, Z) are gathered per
// column inside the kernel: the array_split chunk of column j follows
// from (N, n_chunks) alone (the first N % n_chunks chunks are one column
// wider), so no per-column map is built or read. The code is
// clip(rint(S·x + Z)) with the multiply and the add rounded on their own
// (rt::quant_code_static). It is bound by the bytes: one 16-byte load and
// one 8-byte store a thread and row, and the column bookkeeping once a
// thread, where the first design ran a 64-bit modulo and a division per
// element.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int DW = 8;          // warps a block of the dynamic kernel

// The 16-byte vector's values as floats: 8 bf16 or 4 fp32.
__device__ __forceinline__ void unpack_vec(const uint4& w, float (&o)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(u[i] << 16);
    o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack_vec(const uint4& w, float (&o)[4]) {
  o[0] = __uint_as_float(w.x);
  o[1] = __uint_as_float(w.y);
  o[2] = __uint_as_float(w.z);
  o[3] = __uint_as_float(w.w);
}

// Round r's vectors of this lane, v = gl + G·(r·V + j) for j < V and
// v < nv, copied into its own column of buf (buf[j][threadIdx.x]) by
// cp.async: the bytes in flight wait in shared memory, not in registers.
template <int V>
__device__ __forceinline__ void stage_round(const uint4* __restrict__ pv, int gl, int G,
                                            int nv, int r, uint4 (*buf)[DW * 32]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int v = gl + G * (r * V + j);
    if (v < nv) sm90::cp_async16(sm90::smem_addr(&buf[j][threadIdx.x]), pv + v);
  }
  sm90::cp_async_commit();
}

template <typename X, int V>
__global__ void __launch_bounds__(DW * 32)
act_quant_dynamic_kernel(const X* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, float* __restrict__ zero, int items,
                         int N, int n_chunks, int bits, int W) {
  constexpr int EPV = 16 / (int)sizeof(X);      // x values a vector
  __shared__ uint4 buf[V][DW * 32];
  __shared__ float red[2][DW];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int item = blockIdx.x * (DW / W) + warp / W;   // (row, chunk)
  const int G = W * 32, gl = (warp % W) * 32 + lane;   // lanes, lane in group
  const bool valid = item < items;
  const int row = valid ? item / n_chunks : 0, chunk = valid ? item % n_chunks : 0;
  const int cw = N / n_chunks;
  const size_t off = (size_t)row * N + (size_t)chunk * cw;
  const X* p = x + off;
  // head: the columns before p's first 16-byte boundary; then nv vectors
  const int hd = min((int)(((16u - ((uint32_t)(uintptr_t)p & 15u)) & 15u) / sizeof(X)), cw);
  const int nv = (cw - hd) / EPV, tl = cw - hd - nv * EPV;
  const uint4* pv = reinterpret_cast<const uint4*>(p + hd);
  const int rounds = (nv + G * V - 1) / (G * V);
  // the one head or tail column of this lane, if any (hd, tl < EPV <= 8)
  const int ecol = !valid ? -1 : gl < hd ? gl : (gl >= EPV && gl < EPV + tl) ? hd + nv * EPV + gl - EPV : -1;

  if (valid) stage_round<V>(pv, gl, G, nv, 0, buf);
  float beta = __int_as_float(0x7f800000), alpha = -beta;   // +inf, -inf
  float e = 0.f;
  if (ecol >= 0) {
    e = rt::to_f(p[ecol]);
    beta = alpha = e;
  }
  // a lane reads back only the vectors it copied: its own wait suffices
  for (int r = 0; r < rounds; ++r) {
    if (r > 0) stage_round<V>(pv, gl, G, nv, r, buf);
    sm90::cp_async_wait<0>();
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (gl + G * (r * V + j) < nv) {
        float f[EPV];
        unpack_vec(buf[j][threadIdx.x], f);
#pragma unroll
        for (int i = 0; i < EPV; ++i) {
          beta = fminf(beta, f[i]);
          alpha = fmaxf(alpha, f[i]);
        }
      }
    }
  }
  beta = rt::warp_min(beta);
  alpha = rt::warp_max(alpha);
  if (W > 1) {                                   // uniform over the block
    if (lane == 0) {
      red[0][warp] = beta;
      red[1][warp] = alpha;
    }
    __syncthreads();
    const int w0 = warp - warp % W;
    for (int i = 0; i < W; ++i) {
      beta = fminf(beta, red[0][w0 + i]);
      alpha = fmaxf(alpha, red[1][w0 + i]);
    }
  }
  if (!valid) return;
  const float s = rt::dyn_scale(beta, alpha, (float)((1 << bits) - 1));
  const float z = __fsub_rn(alpha, beta) > 0.f ? rt::dyn_zero(s, beta, bits) : 0.f;
  const float qmin = -(float)(1 << (bits - 1)), qmax = (float)((1 << (bits - 1)) - 1);
  int8_t* out = q + off + hd;
  // q's vectors share x's alignment unless x is a view off 16 bytes
  const bool qvec = ((uintptr_t)out & (EPV - 1)) == 0;
  for (int r = 0; r < rounds; ++r) {
    if (rounds > 1) {
      stage_round<V>(pv, gl, G, nv, r, buf);
      sm90::cp_async_wait<0>();
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int v = gl + G * (r * V + j);
      if (v < nv) {
        float f[EPV];
        unpack_vec(buf[j][threadIdx.x], f);
        uint32_t w[EPV / 4];
#pragma unroll
        for (int i = 0; i < EPV / 4; ++i) w[i] = 0u;
#pragma unroll
        for (int i = 0; i < EPV; ++i)
          w[i / 4] |= (uint32_t)(uint8_t)rt::quant_code(s, f[i], z, qmin, qmax) << (8 * (i % 4));
        int8_t* dst = out + (size_t)v * EPV;
        if (qvec) {
          if constexpr (EPV == 8)
            __stcs(reinterpret_cast<uint2*>(dst), make_uint2(w[0], w[1]));
          else
            __stcs(reinterpret_cast<unsigned int*>(dst), w[0]);
        } else {
#pragma unroll
          for (int i = 0; i < EPV; ++i) dst[i] = (int8_t)(w[i / 4] >> (8 * (i % 4)));
        }
      }
    }
  }
  if (ecol >= 0) q[off + ecol] = rt::quant_code(s, e, z, qmin, qmax);
  if (gl == 0) {
    scale[item] = s;
    zero[item] = z;
  }
}

// Static: a thread owns up to QV consecutive columns (a "slot") and
// walks QR rows of them; a block is QS slots by QW rows of threads, each
// warp on its own rows. Slot 0 is the head [0, hd) when x's rows start hd columns short
// of a 16-byte boundary (hd = 0 otherwise), then whole vectors of QV from
// hd, then the tail. The slot's chunk ids follow from base = N / n_chunks
// and rem = N % n_chunks (chunk c starts at c·base + min(c, rem)) in
// 32-bit arithmetic before the row loop, a vector that straddles a
// boundary taking each column's own (S, Z), so the row loop has no index
// arithmetic. A full slot whose x is 16-byte aligned (every row's, when
// N·sizeof(x) is a multiple of 16) loads 16 bytes (bf16) or 2 x 16 bytes
// (fp32) a row, all of its QR rows before the first code (and before the
// (S, Z) gather), and stores its eight codes as 8 bytes when q's row is
// 8-byte aligned (byte by byte otherwise); the head, the tail and any
// width whose rows do not share one alignment take the scalar path of the
// same kernel.
constexpr int QV = 8;          // columns a slot
constexpr int QS = 32;         // slots a block: its threads along a row
constexpr int QW = 4;          // rows of threads a block
constexpr int QR = 4;          // rows a thread takes a row group

// The first column of slot `slot` and its width.
__device__ __forceinline__ void slot_cols(int slot, int hd, int N, int& c0, int& c1) {
  if (hd > 0) {
    c0 = slot == 0 ? 0 : hd + QV * (slot - 1);
    c1 = slot == 0 ? hd : min(c0 + QV, N);
  } else {
    c0 = QV * slot;
    c1 = min(c0 + QV, N);
  }
}

// Eight x of a row from its 16-byte words (one for bf16, two for fp32).
__device__ __forceinline__ void unpack(const uint4 (&w)[1], float (&o)[QV]) {
  const uint32_t u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(u[i] << 16);
    o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4 (&w)[2], float (&o)[QV]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    o[4 * i] = __uint_as_float(w[i].x);
    o[4 * i + 1] = __uint_as_float(w[i].y);
    o[4 * i + 2] = __uint_as_float(w[i].z);
    o[4 * i + 3] = __uint_as_float(w[i].w);
  }
}

// The QR rows of row group r0 this thread loads: its 16-byte words of each.
template <typename X, int NW>
__device__ __forceinline__ void load_rows(const X* __restrict__ x, int r0, int R, int N,
                                          int c0, uint4 (&raw)[QR][NW]) {
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int row = r0 + i * QW + threadIdx.y;
    if (row < R) {
      const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)row * N + c0);
#pragma unroll
      for (int j = 0; j < NW; ++j) raw[i][j] = __ldcs(p + j);
    }
  }
}

template <typename X>
__global__ void __launch_bounds__(QS * QW)
act_quant_static_kernel(const X* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ zero, int8_t* __restrict__ q, int R,
                        int N, int n_chunks, int bits, int hd, int nslots, int x_vec) {
  constexpr int NW = QV * (int)sizeof(X) / 16;   // 16-byte words a row
  const int slot = blockIdx.x * QS + threadIdx.x;
  if (slot >= nslots) return;
  int c0, c1;
  slot_cols(slot, hd, N, c0, c1);
  const int width = c1 - c0;
  const bool full = width == QV;
  const bool xv = full && x_vec;
  const bool qv = full && (N % QV) == 0 && (c0 % QV) == 0;
  const int stride = gridDim.y * QW * QR;
  // the first row group's loads go out before the (S, Z) gather
  uint4 raw[QR][NW];
  if (xv) load_rows<X, NW>(x, blockIdx.y * QW * QR, R, N, c0, raw);

  const int base = N / n_chunks, rem = N % n_chunks;
  const int wide = rem * (base + 1);          // columns in the wider chunks
  int cid = c0 < wide ? c0 / (base + 1) : rem + (c0 - wide) / base;
  int next = (cid + 1) * base + min(cid + 1, rem);
  float s[QV], z[QV];
#pragma unroll
  for (int e = 0; e < QV; ++e) {
    while (c0 + e >= next && cid + 1 < n_chunks) {
      ++cid;
      next = (cid + 1) * base + min(cid + 1, rem);
    }
    s[e] = scale[cid];
    z[e] = zero[cid];
  }
  const float qmin = -(float)(1 << (bits - 1)), qmax = (float)((1 << (bits - 1)) - 1);
  for (int r0 = blockIdx.y * QW * QR; r0 < R; r0 += stride) {
    if (xv) {
      if (r0 != blockIdx.y * QW * QR) load_rows<X, NW>(x, r0, R, N, c0, raw);
#pragma unroll
      for (int i = 0; i < QR; ++i) {
        const int row = r0 + i * QW + threadIdx.y;
        if (row >= R) break;
        float xf[QV];
        unpack(raw[i], xf);
        uint32_t packed[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < QV; ++e)
          packed[e / 4] |= (uint32_t)(uint8_t)rt::quant_code_static(s[e], xf[e], z[e], qmin,
                                                                    qmax)
                           << (8 * (e % 4));
        int8_t* dst = q + (size_t)row * N + c0;
        if (qv) {
          __stcs(reinterpret_cast<uint2*>(dst), make_uint2(packed[0], packed[1]));
        } else {
#pragma unroll
          for (int e = 0; e < QV; ++e) dst[e] = (int8_t)(packed[e / 4] >> (8 * (e % 4)));
        }
      }
    } else {
      for (int i = 0; i < QR; ++i) {
        const int row = r0 + i * QW + threadIdx.y;
        if (row >= R) break;
        const size_t off = (size_t)row * N + c0;
#pragma unroll
        for (int e = 0; e < QV; ++e)
          if (e < width)
            q[off + e] = rt::quant_code_static(s[e], rt::to_f(x[off + e]), z[e], qmin, qmax);
      }
    }
  }
}

// The dynamic kernel at its plan: warps (1, 2, 4, 8) a (row, chunk) and
// vecs (1, 2, 4, 8) 16-byte vectors a lane, from the wrapper's dynamic_plan.
template <typename X>
void launch_dynamic(const X* x, int8_t* q, float* scale, float* zero, int items, int N,
                    int n_chunks, int bits, int warps, int vecs, cudaStream_t st) {
  const int grid = (items + DW / warps - 1) / (DW / warps);
  switch (vecs) {
    case 1:
      act_quant_dynamic_kernel<X, 1><<<grid, DW * 32, 0, st>>>(x, q, scale, zero, items, N,
                                                               n_chunks, bits, warps);
      break;
    case 2:
      act_quant_dynamic_kernel<X, 2><<<grid, DW * 32, 0, st>>>(x, q, scale, zero, items, N,
                                                               n_chunks, bits, warps);
      break;
    case 4:
      act_quant_dynamic_kernel<X, 4><<<grid, DW * 32, 0, st>>>(x, q, scale, zero, items, N,
                                                               n_chunks, bits, warps);
      break;
    default:
      act_quant_dynamic_kernel<X, 8><<<grid, DW * 32, 0, st>>>(x, q, scale, zero, items, N,
                                                               n_chunks, bits, warps);
  }
}

}  // namespace

extern "C" {

// x (R, N) → q int8 (R, N), scale/zero fp32 (R, n_chunks); N % n_chunks == 0.
int act_quant_dynamic(const void* x, void* q, void* scale, void* zero, int R, int N,
                      int n_chunks, int bits, int x_is_bf16, int warps, int vecs,
                      void* stream) {
  if (R <= 0 || n_chunks <= 0 || N % n_chunks != 0 || N < n_chunks || bits < 2 ||
      bits > 8 || (long long)R * n_chunks > 0x7fffffffLL ||
      (warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
      (vecs != 1 && vecs != 2 && vecs != 4 && vecs != 8) ||
      (uintptr_t)x % (x_is_bf16 ? 2 : 4) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int items = R * n_chunks;
  if (x_is_bf16)
    launch_dynamic((const __nv_bfloat16*)x, (int8_t*)q, (float*)scale, (float*)zero, items,
                   N, n_chunks, bits, warps, vecs, st);
  else
    launch_dynamic((const float*)x, (int8_t*)q, (float*)scale, (float*)zero, items, N,
                   n_chunks, bits, warps, vecs, st);
  return (int)cudaGetLastError();
}

// x (R, N), scale/zero fp32 (n_chunks,) over array_split chunks → q int8 (R, N)
int act_quant_static(const void* x, const void* scale, const void* zero, void* q,
                     int R, int N, int n_chunks, int bits, int x_is_bf16, void* stream) {
  if (R <= 0 || N <= 0 || n_chunks <= 0 || n_chunks > N || bits < 2 || bits > 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int xs = x_is_bf16 ? 2 : 4;
  const uintptr_t mis = (uintptr_t)x & 15;
  // rows share x's alignment when a row is a whole number of 16-byte units
  const bool rows_aligned = ((size_t)N * xs) % 16 == 0 && mis % xs == 0;
  const int hd = rows_aligned ? (int)(((16 - mis) & 15) / xs) : 0;
  const int hd_cols = hd < N ? hd : N;
  const int nslots = (hd_cols > 0) + (N - hd_cols + QV - 1) / QV;
  // a block a row group of QW·QR rows (several in turn past 65535 groups)
  const int gx = (nslots + QS - 1) / QS, groups = (R + QW * QR - 1) / (QW * QR);
  const int gy = groups < 65535 ? groups : 65535;
  const dim3 grid(gx, gy), block(QS, QW);
  const int x_vec = rows_aligned ? 1 : 0;
  if (x_is_bf16)
    act_quant_static_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (const float*)zero,
        (int8_t*)q, R, N, n_chunks, bits, hd_cols, nslots, x_vec);
  else
    act_quant_static_kernel<float><<<grid, block, 0, st>>>(
        (const float*)x, (const float*)scale, (const float*)zero, (int8_t*)q, R, N,
        n_chunks, bits, hd_cols, nslots, x_vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
