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
// Static: one thread per element, grid-stride over 16 blocks per SM
// (the wrapper passes the SM count). The per-chunk (S, Z) are
// gathered per column inside the kernel: the array_split chunk of column
// j follows from (N, n_chunks) alone (the first N % n_chunks chunks are
// one column wider), so no per-column map is built or read. The code is
// clip(rint(S·x + Z)) with the multiply and the add rounded on their own.
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

template <typename X>
__global__ void act_quant_static_kernel(const X* __restrict__ x,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ zero,
                                        int8_t* __restrict__ q, size_t total, int N,
                                        int n_chunks, int bits) {
  const int base = N / n_chunks, rem = N % n_chunks;
  const int wide = rem * (base + 1);          // columns in the wider chunks
  const float qmin = -(float)(1 << (bits - 1)), qmax = (float)((1 << (bits - 1)) - 1);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int col = (int)(i % N);
    const int c = col < wide ? col / (base + 1) : rem + (col - wide) / base;
    q[i] = rt::quant_code_static(scale[c], rt::to_f(x[i]), zero[c], qmin, qmax);
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

// x (R, N), scale/zero fp32 (n_chunks,) over array_split chunks → q int8 (R, N);
// sms: the card's SM count
int act_quant_static(const void* x, const void* scale, const void* zero, void* q,
                     int R, int N, int n_chunks, int bits, int x_is_bf16, int sms,
                     void* stream) {
  if (R <= 0 || N <= 0 || n_chunks <= 0 || n_chunks > N || bits < 2 || bits > 8 ||
      sms <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t total = (size_t)R * N;
  const int threads = 256;
  const size_t need = (total + threads - 1) / threads;
  const int blocks = (int)(need < (size_t)sms * 16 ? need : (size_t)sms * 16);
  if (x_is_bf16)
    act_quant_static_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (const float*)zero,
        (int8_t*)q, total, N, n_chunks, bits);
  else
    act_quant_static_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)x, (const float*)scale, (const float*)zero, (int8_t*)q, total,
        N, n_chunks, bits);
  return (int)cudaGetLastError();
}

}  // extern "C"
