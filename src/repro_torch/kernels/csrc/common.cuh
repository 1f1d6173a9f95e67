// Shared helpers of the port's CUDA kernels.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// INT8 KV dequantization (q - Z) / S, each step rounded on its own as
// the reference rounds it (no contraction, true division).
__device__ __forceinline__ float dequant_kv(int8_t q, float s, float z) {
  return __fdiv_rn(__fsub_rn((float)q, z), s);
}
// The same value without a division per element, from the code as a
// float: with inv = __frcp_rn(s) (the correctly rounded 1/s), q0 = x * inv
// is within an ulp of x / s, the residual x - q0 * s is exact in one FMA,
// and q0 + residual * inv rounds to the correctly rounded quotient
// (Markstein's correction), i.e. to __fdiv_rn(x, s) whenever s, 1/s and
// x/s are normal numbers, which every scale the cache holds is
// (tests/test_torch_attention_plan.py checks the identity over the
// scales' range).
__device__ __forceinline__ float dequant_kv_rcp(float qf, float s, float inv, float z) {
  const float x = __fsub_rn(qf, z);
  const float q0 = __fmul_rn(x, inv);
  return __fmaf_rn(__fmaf_rn(-q0, s, x), inv, q0);
}

// Byte j (0-3, a constant) of a word of four int8 codes as an exact float,
// without a conversion instruction (those issue at a quarter of the FMA
// rate): `w80` is the word XOR 0x80808080, so the byte is the code plus
// 128; placed in the low mantissa bits of 2^23 it reads 2^23 + 128 + code,
// and subtracting 2^23 + 128 is exact.
__device__ __forceinline__ float code_f(uint32_t w80, int j) {
  return __int_as_float(__byte_perm(w80, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}

// Dynamic quantization parameters and codes by eqs. (1)-(3), with
// exactly the reference's fp32 operations: true divisions (levels/span,
// 1/amax), rintf (half to even) and no contraction into an FMA
// (__fmul_rn/__fadd_rn/__fsub_rn), so codes and scales are
// bit-identical to core.quantize.qparams/quantize.
//
// S = levels / span; a degenerate range (span = 0) gets S = 1/|amax| so
// its single value maps to code ±1 (S = 1 when amax = 0).
__device__ __forceinline__ float dyn_scale(float beta, float alpha, float levels) {
  const float span = __fsub_rn(alpha, beta);
  const float amax = fmaxf(fabsf(beta), fabsf(alpha));
  const float degenerate = amax > 0.f ? __fdiv_rn(1.f, amax) : 1.f;
  return span > 0.f ? __fdiv_rn(levels, span) : degenerate;
}
// Z = -2^(bits-1) - rint(S·β)
__device__ __forceinline__ float dyn_zero(float s, float beta, int bits) {
  return __fsub_rn(-(float)(1 << (bits - 1)), rintf(__fmul_rn(s, beta)));
}
// clip(rint(S·x) + Z): the zero is an integer, added after the rounding
__device__ __forceinline__ int8_t quant_code(float s, float x, float z, float qmin,
                                             float qmax) {
  return (int8_t)fminf(fmaxf(__fadd_rn(rintf(__fmul_rn(s, x)), z), qmin), qmax);
}
// clip(rint(S·x + Z)): a static (offline) zero is fractional and folded
// into the rounding; the multiply and the add stay two roundings
__device__ __forceinline__ int8_t quant_code_static(float s, float x, float z,
                                                    float qmin, float qmax) {
  return (int8_t)fminf(fmaxf(rintf(__fadd_rn(__fmul_rn(s, x), z)), qmin), qmax);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr float NEG_INF = -1e30f;

}  // namespace rt
