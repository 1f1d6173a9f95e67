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
// the card's bound is the bytes. The dynamic form reads its chunk twice
// (min/max, then codes); the second read is from L1/L2 at these widths.
//
// Dynamic: one warp per (row, chunk), eight rows per block and one chunk
// per grid column. Lanes stride over the chunk (neighbouring lanes on
// neighbouring columns), reduce min/max with shuffles in fp32, and every
// lane derives the same (S, Z) with common.cuh's exact helpers. As in the
// TPU kernel (and unlike core.quantize.qparams), a degenerate range gets
// zero 0. Codes, scales and zeros are bit-identical to the reference.
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

namespace {

constexpr int WARPS = 8;

template <typename X>
__global__ void __launch_bounds__(WARPS * 32)
act_quant_dynamic_kernel(const X* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, float* __restrict__ zero, int R,
                         int N, int n_chunks, int bits) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp, chunk = blockIdx.y;
  if (row >= R) return;
  const int cw = N / n_chunks;
  const size_t off = (size_t)row * N + (size_t)chunk * cw;
  const X* p = x + off;
  float beta = __int_as_float(0x7f800000), alpha = -beta;   // +inf, -inf
  for (int i = lane; i < cw; i += 32) {
    const float v = rt::to_f(p[i]);
    beta = fminf(beta, v);
    alpha = fmaxf(alpha, v);
  }
  beta = rt::warp_min(beta);
  alpha = rt::warp_max(alpha);
  const float s = rt::dyn_scale(beta, alpha, (float)((1 << bits) - 1));
  const float z = __fsub_rn(alpha, beta) > 0.f ? rt::dyn_zero(s, beta, bits) : 0.f;
  const float qmin = -(float)(1 << (bits - 1)), qmax = (float)((1 << (bits - 1)) - 1);
  int8_t* out = q + off;
  for (int i = lane; i < cw; i += 32) out[i] = rt::quant_code(s, rt::to_f(p[i]), z, qmin, qmax);
  if (lane == 0) {
    scale[(size_t)row * n_chunks + chunk] = s;
    zero[(size_t)row * n_chunks + chunk] = z;
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

}  // namespace

extern "C" {

// x (R, N) → q int8 (R, N), scale/zero fp32 (R, n_chunks); N % n_chunks == 0
int act_quant_dynamic(const void* x, void* q, void* scale, void* zero, int R, int N,
                      int n_chunks, int bits, int x_is_bf16, void* stream) {
  if (R <= 0 || n_chunks <= 0 || N % n_chunks != 0 || N < n_chunks || bits < 2 ||
      bits > 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((R + WARPS - 1) / WARPS, n_chunks);
  if (x_is_bf16)
    act_quant_dynamic_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)scale, (float*)zero, R, N,
        n_chunks, bits);
  else
    act_quant_dynamic_kernel<float><<<grid, WARPS * 32, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)scale, (float*)zero, R, N, n_chunks,
        bits);
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
