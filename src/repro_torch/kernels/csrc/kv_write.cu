// The K/V cache write of one layer for Hopper (sm_90a): K and V of the new
// rows quantized together (or cast, over an fp32 cache) and stored with
// their per-entry scales and kv_pos straight into the slot rows, in one
// launch. Over an fp cache the rows are cast to its float type, fp32,
// bf16 or float16.
//
// Replaces the Pallas TPU prefill kernel's epilogue `_quantize_chunk`
// (src/repro/kernels/prefill_attention.py:232-245: dynamic at :232, the
// static branch at :241) together with the scatter of the JAX engine's
// jitted step (src/repro/engine/kvcache.py:207 slot_layer_write, :291
// slot_chunk_prefill), which XLA fuses into the same program. The
// standalone quantizers quantize_kv / quantize_kv_static launch it with a
// dense destination.
//
// What bounds it: bytes, and at the serving shapes not even those. A
// stablelm-1.6b decode write moves 8 x 2 x 32 x 64 bf16 values in and as
// many code bytes out (~0.05 MB, 0.00002 ms at 3.35 TB/s); a 96-row chunk
// twelve times that. It does ~4 operations per element. So the kernel is
// launch-bound: what it can do is be ONE launch per layer write, where
// the port had two quantize launches plus ~10 PyTorch index and copy
// kernels that built and used row indices on the host's behalf.
//
// Design:
// - The grid covers K and V of every row. A head vector of D values is
//   cut into C sub-channel chunks of cl = D / C values; P lanes (a power
//   of two, P <= 32) share a chunk and each loads E contiguous values
//   with one vector load of up to 16 bytes (bf16: 8 values, fp32: 4), so
//   a warp reads consecutive 16-byte pieces of consecutive head vectors:
//   coalesced. stablelm-1.6b (D=64, C=4, bf16): E=8, P=2, 8 lanes a
//   head; chatglm3-6b (D=128): E=8, P=4, 16 lanes a head. A chunk whose
//   length E does not divide, or a misaligned operand, takes smaller
//   vectors, down to one value a lane; a chunk of more than 32 x E values
//   gives each lane several vectors (re-read from L1 for the codes).
// - Dynamic mode: the chunk's min and max by __shfl_xor_sync across its P
//   lanes, then S, Z and the codes with common.cuh's rt::dyn_scale,
//   rt::dyn_zero and rt::quant_code. Min and max do not depend on the
//   order, so codes and scales are bit-identical to
//   engine.kvcache.quantize_kv of the JAX package. The chunk's first
//   lane writes its scale and zero.
// - Static mode: the layer's (Hkv, C) constants of K and V are read once
//   per block into shared memory (straight from global memory if the
//   table passes 48 KB); codes clip(rint(S x + Z)) with the product and
//   the sum rounded on their own (rt::quant_code_static, no FMA), as
//   engine.kvcache.quantize_kv_static evaluates op by op. No scale is
//   written.
// - fp mode: a cast to the cache's float type, so a layer's write is one
//   launch in all three cache modes. A bf16 cache (the JAX engine's
//   kv_dtype="bfloat16", whose writes cast to the buffer's dtype at
//   src/repro/engine/kvcache.py:222 and :350) takes the rows rounded to
//   nearest even (__float2bfloat16_rn, as astype and .to() round), packed
//   two a 32-bit word: a bf16 row is copied unchanged, an fp32 one
//   rounded. A float16 cache (kv_dtype="float16") takes each value
//   rounded to nearest even by __float2half_rn, as astype(float16)
//   rounds it (a bf16 value whose exponent float16 lacks overflows to
//   inf or rounds into its subnormals, as there). The vector width E
//   follows the 2-byte destination too: a lane stores E values in one
//   store of up to 16 bytes. A runtime value (`out16`: 1 bf16, 2
//   float16), not another instantiation.
// - Codes leave as packed 32-bit words (8 codes a lane: one 8-byte
//   store).
// - The destination row is computed in the kernel. Decode (`pos` given):
//   row n goes to slot n at t = pos[n] mod T, with kv_pos = pos[n].
//   Window (chunk or verify window of one slot): row r goes to
//   (slot, pos_start + r) and is dropped at or past T; its kv_pos is
//   pos_start + r if r < length, else -1. The row's first lane writes
//   kv_pos. A dense destination is a window of slot 0 with T = rows and
//   no kv_pos.
// - No index divides per element: a thread splits its own index once, in
//   32-bit arithmetic (a 64-bit divide is a long software sequence, and
//   this kernel is all latency).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MODE_FP = 0, MODE_DYNAMIC = 1, MODE_STATIC = 2;
constexpr int SMEM_TABLE_MAX = 48 * 1024;

struct KvArgs {
  const void *xk, *xv;       // K, V: (rows, Hkv, D), fp32 or bf16
  void *dk, *dv;             // destination: (N, T, Hkv, D), int8, fp32 or bf16
  float *ks, *kz, *vs, *vz;  // dynamic: (N, T, Hkv, C) out; static: (Hkv, C) in
  int* kv_pos;               // (N, T) or null
  const int* pos;            // (rows,) decode positions, or null: a window
  long long total;           // threads with a piece: rows * per_row
  unsigned per_row;          // ntens * Hkv * C * P
  int ntens, T, Hkv, D, C, cl, lp, nv, slot, pos_start, length, mode, smem_table;
  int out16;                 // fp mode: a bf16 (1) or float16 (2) destination
};

// E values of the input from one vector load, exactly as floats: a bf16
// value is the high half of its float.
template <bool BF16, int E>
__device__ __forceinline__ void load_vec(const void* p, float (&f)[E]) {
  constexpr int NB = E * (BF16 ? 2 : 4);
  unsigned w[(NB + 3) / 4];
  if constexpr (NB == 16) {
    const uint4 u = __ldg((const uint4*)p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (NB == 8) {
    const uint2 u = __ldg((const uint2*)p);
    w[0] = u.x, w[1] = u.y;
  } else if constexpr (NB == 4) {
    w[0] = __ldg((const unsigned*)p);
  } else {
    w[0] = __ldg((const unsigned short*)p);
  }
#pragma unroll
  for (int j = 0; j < E; ++j)
    f[j] = BF16 ? __uint_as_float(((w[j / 2] >> (16 * (j & 1))) & 0xffffu) << 16)
                : __uint_as_float(w[j]);
}

// E int8 codes packed little-endian into 32-bit words, one store.
template <int E>
__device__ __forceinline__ void store_codes(int8_t* d, const int (&q)[E]) {
  unsigned w[(E + 3) / 4] = {};
#pragma unroll
  for (int j = 0; j < E; ++j) w[j / 4] |= (unsigned)(q[j] & 0xff) << (8 * (j & 3));
  if constexpr (E == 8) *(uint2*)d = make_uint2(w[0], w[1]);
  else if constexpr (E == 4) *(unsigned*)d = w[0];
  else if constexpr (E == 2) *(unsigned short*)d = (unsigned short)w[0];
  else *(unsigned char*)d = (unsigned char)w[0];
}

template <int E>
__device__ __forceinline__ void store_f32(float* d, const float (&f)[E]) {
  if constexpr (E == 8) {
    *(float4*)d = make_float4(f[0], f[1], f[2], f[3]);
    *(float4*)(d + 4) = make_float4(f[4], f[5], f[6], f[7]);
  } else if constexpr (E == 4) {
    *(float4*)d = make_float4(f[0], f[1], f[2], f[3]);
  } else if constexpr (E == 2) {
    *(float2*)d = make_float2(f[0], f[1]);
  } else {
    d[0] = f[0];
  }
}

// E values rounded to bf16 (nearest even) and packed two a word, one store.
template <int E>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* d, const float (&f)[E]) {
  unsigned w[(E + 1) / 2] = {};
#pragma unroll
  for (int j = 0; j < E; ++j)
    w[j / 2] |= (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[j])) << (16 * (j & 1));
  if constexpr (E == 8) *(uint4*)d = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (E == 4) *(uint2*)d = make_uint2(w[0], w[1]);
  else if constexpr (E == 2) *(unsigned*)d = w[0];
  else *(unsigned short*)d = (unsigned short)w[0];
}

// E values rounded to float16 (nearest even) and packed two a word, one
// store.
template <int E>
__device__ __forceinline__ void store_f16(__half* d, const float (&f)[E]) {
  unsigned w[(E + 1) / 2] = {};
#pragma unroll
  for (int j = 0; j < E; ++j)
    w[j / 2] |= (unsigned)__half_as_ushort(__float2half_rn(f[j])) << (16 * (j & 1));
  if constexpr (E == 8) *(uint4*)d = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (E == 4) *(uint2*)d = make_uint2(w[0], w[1]);
  else if constexpr (E == 2) *(unsigned*)d = w[0];
  else *(unsigned short*)d = (unsigned short)w[0];
}

template <bool BF16, int E>
__global__ void __launch_bounds__(THREADS) kv_write_kernel(const KvArgs a) {
  extern __shared__ float table[];  // static: [K S | K Z | V S | V Z], (Hkv, C) each
  // this thread's piece: (((row * ntens + kv) * Hkv + h) * C + c) * P + p
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = g < a.total;
  const int P = 1 << a.lp;
  int p = 0, c = 0, h = 0, kv = 0;
  long long row = 0, drow = -1;
  int pv = 0;
  if (live) {
    // the row split off first, then the rest in 32 bits: no 64-bit
    // divide unless the grid passes 2^32 threads
    unsigned r;
    if (a.total <= 0xffffffffLL) {
      const unsigned g32 = (unsigned)g;
      row = g32 / a.per_row;
      r = g32 - (unsigned)row * a.per_row;
    } else {
      row = g / a.per_row;
      r = (unsigned)(g - row * a.per_row);
    }
    p = (int)(r & (P - 1));
    unsigned q = r >> a.lp;
    c = (int)(q % (unsigned)a.C), q /= (unsigned)a.C;
    h = (int)(q % (unsigned)a.Hkv), kv = (int)(q / (unsigned)a.Hkv);
    if (a.pos) {  // decode: slot `row`, row pos mod T
      pv = a.pos[row];
      int t = pv % a.T;
      if (t < 0) t += a.T;
      drow = row * a.T + t;
    } else {      // window of one slot; rows at or past T are dropped
      const long long t = a.pos_start + row;
      if (t >= 0 && t < a.T) drow = (long long)a.slot * a.T + t;
      pv = row < a.length ? (int)t : -1;
    }
  }
  const bool store = drow >= 0;
  if (store && a.kv_pos && (kv | h | c | p) == 0) a.kv_pos[drow] = pv;

  constexpr int XB = BF16 ? 2 : 4;
  const size_t off = ((size_t)row * a.Hkv + h) * a.D + (size_t)c * a.cl + (size_t)p * E;
  const char* src = (const char*)(kv ? a.xv : a.xk) + off * XB;
  const int step = P * E;  // values between a lane's vectors
  float f[E];
  if (live) load_vec<BF16, E>(src, f);

  // static: the block's table, staged while the loads above are in flight
  const int HC = a.Hkv * a.C;
  const float *kst = a.ks, *kzt = a.kz, *vst = a.vs, *vzt = a.vz;
  if (a.mode == MODE_STATIC && a.smem_table) {
    for (int i = threadIdx.x; i < HC; i += blockDim.x) {
      table[i] = a.ks[i];
      table[HC + i] = a.kz[i];
      if (a.ntens == 2) {
        table[2 * HC + i] = a.vs[i];
        table[3 * HC + i] = a.vz[i];
      }
    }
    __syncthreads();
    kst = table, kzt = table + HC, vst = table + 2 * HC, vzt = table + 3 * HC;
  }

  float s = 0.f, z = 0.f;
  if (a.mode == MODE_DYNAMIC) {
    float lo = __int_as_float(0x7f800000), hi = -lo;
    if (live) {
#pragma unroll
      for (int j = 0; j < E; ++j) lo = fminf(lo, f[j]), hi = fmaxf(hi, f[j]);
      for (int i = 1; i < a.nv; ++i) {
        float e[E];
        load_vec<BF16, E>(src + (size_t)i * step * XB, e);
#pragma unroll
        for (int j = 0; j < E; ++j) lo = fminf(lo, e[j]), hi = fmaxf(hi, e[j]);
      }
    }
    // every lane of the warp takes part; a chunk's P lanes are aligned
    for (int o = P >> 1; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    s = rt::dyn_scale(lo, hi, 255.f);
    z = rt::dyn_zero(s, lo, 8);
    if (store && p == 0) {
      const size_t si = ((size_t)drow * a.Hkv + h) * a.C + c;
      (kv ? a.vs : a.ks)[si] = s;
      (kv ? a.vz : a.kz)[si] = z;
    }
  } else if (a.mode == MODE_STATIC && live) {
    s = (kv ? vst : kst)[h * a.C + c];
    z = (kv ? vzt : kzt)[h * a.C + c];
  }
  if (!store) return;

  const size_t doff = ((size_t)drow * a.Hkv + h) * a.D + (size_t)c * a.cl + (size_t)p * E;
  for (int i = 0; i < a.nv; ++i) {
    if (i) load_vec<BF16, E>(src + (size_t)i * step * XB, f);
    const size_t o = doff + (size_t)i * step;
    if (a.mode == MODE_FP && a.out16 == 2) {
      store_f16<E>((__half*)(kv ? a.dv : a.dk) + o, f);
    } else if (a.mode == MODE_FP && a.out16) {
      store_bf16<E>((__nv_bfloat16*)(kv ? a.dv : a.dk) + o, f);
    } else if (a.mode == MODE_FP) {
      store_f32<E>((float*)(kv ? a.dv : a.dk) + o, f);
    } else {
      int q[E];
#pragma unroll
      for (int j = 0; j < E; ++j)
        q[j] = a.mode == MODE_DYNAMIC ? rt::quant_code(s, f[j], z, -128.f, 127.f)
                                      : rt::quant_code_static(s, f[j], z, -128.f, 127.f);
      store_codes<E>((int8_t*)(kv ? a.dv : a.dk) + o, q);
    }
  }
}

template <bool BF16, int E>
cudaError_t launch(const KvArgs& a, cudaStream_t st) {
  const size_t smem = a.smem_table ? (size_t)16 * a.Hkv * a.C : 0;
  const long long blocks = (a.total + THREADS - 1) / THREADS;
  kv_write_kernel<BF16, E><<<(unsigned)blocks, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) { return !p || (uintptr_t)p % bytes == 0; }

}  // namespace

extern "C" {

// k, v (rows, Hkv, D) (v null: K alone) → destination dk, dv (N, T, Hkv,
// D), int8 codes (mode 1 dynamic, 2 static) or, in mode 0, fp32 (or bf16
// with dst16 = 1, float16 with dst16 = 2); scales:
// dynamic (N, T, Hkv, C) written, static (Hkv, C) read, fp unused (C = 1).
// pos (rows,) int32: the decode map (rows == N); null: the window map of
// `slot` at pos_start with `length` valid rows. kv_pos (N, T) or null.
int kv_write(const void* k, const void* v, void* dk, void* dv, void* kv_pos,
             const void* pos, void* ks, void* kz, void* vs, void* vz, int rows,
             int T, int Hkv, int D, int C, int slot, int pos_start, int length,
             int mode, int x_is_bf16, int dst16, void* stream) {
  const int ntens = v ? 2 : 1;
  if (rows <= 0 || T <= 0 || Hkv <= 0 || D <= 0 || C <= 0 || D % C != 0 ||
      mode < MODE_FP || mode > MODE_STATIC || !k || !dk || (v && !dv) ||
      (mode == MODE_FP && C != 1) || dst16 < 0 || dst16 > 2 ||
      (dst16 && mode != MODE_FP) ||
      (mode != MODE_FP && (!ks || !kz || (v && (!vs || !vz)))))
    return (int)cudaErrorInvalidValue;
  const int xb = x_is_bf16 ? 2 : 4, ob = mode == MODE_FP ? (dst16 ? 2 : 4) : 1;
  const int cl = D / C;
  int E = 16 / xb;
  while (E > 1 && (cl % E || !aligned(k, E * xb) || !aligned(v, E * xb) ||
                   !aligned(dk, E * ob > 16 ? 16 : E * ob) ||
                   !aligned(dv, E * ob > 16 ? 16 : E * ob)))
    E >>= 1;
  const int m = cl / E;  // vectors a chunk
  int lp = 0;
  while (lp < 5 && m % (2 << lp) == 0) ++lp;
  const unsigned per_row = (unsigned)ntens * Hkv * C << lp;
  KvArgs a{k, v, dk, dv, (float*)ks, (float*)kz, (float*)vs, (float*)vz,
           (int*)kv_pos, (const int*)pos, (long long)rows * per_row, per_row,
           ntens, T, Hkv, D, C, cl, lp, m >> lp, slot, pos_start, length, mode,
           mode == MODE_STATIC && 16LL * Hkv * C <= SMEM_TABLE_MAX, dst16};
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_bf16) {
    switch (E) {
      case 8: return (int)launch<true, 8>(a, st);
      case 4: return (int)launch<true, 4>(a, st);
      case 2: return (int)launch<true, 2>(a, st);
      default: return (int)launch<true, 1>(a, st);
    }
  }
  switch (E) {
    case 4: return (int)launch<false, 4>(a, st);
    case 2: return (int)launch<false, 2>(a, st);
    default: return (int)launch<false, 1>(a, st);
  }
}

}  // extern "C"
