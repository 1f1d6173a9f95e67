// Split-T (flash-decoding) decode attention over the slot KV cache for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (_fused_kernel, pallas_call at :164): one query token per slot attends
// over that slot's cache rows with an online softmax. INT8 codes stand for
// (q - Z) / S per sub-channel chunk; an entry is valid when
// 0 <= kv_pos <= q_pos; the query heads of a group share one read of their
// kv-head (K/V are never broadcast to Hq); an empty slot returns exact 0.
//
// What bounds it: every valid cache entry is read once (D code bytes and
// 2*C fp32 scales for each of K and V: 192 B per row and kv-head at
// D = 64, C = 4) and used for 4*G*D flops, so at the serving shapes it is
// bound by those bytes (0.0067 ms for stablelm-1.6b's 8 slots at T = 1024).
// The work, ~0.0005-0.0009 ms at the 67 TFLOP/s of the CUDA cores, is
// below that bound, so it stays on the CUDA cores in fp32, for fp32 and
// bf16 q alike (the fp32 cross-checks keep fp32 arithmetic).
//
// Design. The grid is (kv-head x head group, slot, split): T is cut into
// `splits` ranges of `rows` rows (decode_plan in decode_attention.py picks
// them so the grid comes near two blocks per SM). A block of 1-4 warps
// owns one range; each warp walks its own 32-row tiles of it with no
// block-wide barrier:
//  - the warp first reads the positions of all its tiles (eight tiles'
//    worth of loads in flight at once) into one valid-row mask per tile
//    (a ballot), and skips a tile with no valid row without touching its
//    codes, so a split with no valid row reads no codes and leaves an
//    empty partial (sum 0);
//  - codes come by 16-byte cp.async (scales by 4-byte cp.async) into a
//    double buffer of the warp's own shared memory, so the next tile's
//    bytes are in flight while this one is computed; a code row's 16-byte
//    chunks are XOR-swizzled by row, so a lane per row reads them without
//    bank conflicts and without padding (but at D = 112, below);
//  - a code becomes a float by one byte permute and one exact subtraction
//    (rt::code_f), not by a conversion instruction;
//  - Q.K: lane = row; the lane forms its row's scores for the block's
//    query heads (q, pre-scaled, is read from shared memory as a
//    broadcast: G x D floats would not fit in registers for a lane that
//    needs all of them); a row's dot product needs no shuffle;
//  - the running max is a warp_max; the running sum stays a per-lane
//    partial until the end;
//  - one head (GB = 1) and D <= 64, the row path (stablelm-1.6b): P.V is
//    lane = row as well, into D per-lane accumulators added across the
//    warp once at the end; the scale is folded out of each chunk c of a
//    row: q.k = sum_c (1/S_c) (sum_{d in c} q_d code_d - Z_c sum_{d in c}
//    q_d), the chunk sums of q taken once per block, and P.V accumulates
//    w code and w Z_c with w = p / S_c, subtracted at the end, so a code
//    costs a permute, a subtraction and one FMA in each product. This
//    rounds otherwise than the plain version's per-element (q - Z) / S,
//    within the kernel's fp32 tolerance;
//  - head groups, or D = 128 (the column path, chatglm3-6b): each code is
//    dequantized as (q - Z) * (1/S) corrected by one FMA of its exact
//    residual, which rounds as the true division does
//    (rt::dequant_kv_rcp; tests/test_torch_attention_plan.py checks it),
//    and P.V is lane = D/32 columns, each row's p and 1/S read from
//    shared memory.
// At the end the block's warps are merged in warp order in shared memory.
// With one split the block writes the output. Otherwise it writes an fp32
// partial (acc, max, sum) and the last block of its (slot, head group) to
// finish -- found by __threadfence and an atomic ticket, which that block
// sets back to 0 -- merges all partials by log-sum-exp in split order, so
// two calls give bit-identical output: one launch per layer and step. The
// merge reads four neighbouring outputs a load with the loads of several
// outputs and splits in flight.
//
// Static scales (`stat`, the per-layer (Hkv, C) S and Z of a calibration
// recipe, src/repro/kernels/decode_attention.py:103-105 and :158): the
// block reads its kv-head's C values of S and Z of K and V once into a
// table in shared memory (with 1/S on the column path), a stage holds no
// scale arrays and no scale row is copied per cache row, so a row and
// head costs its 2 * D code bytes alone. Both paths read the table with a
// row pitch of 0 where the dynamic mode reads the stage's rows; the codes
// dequantize as (q - Z) / S as in the dynamic mode. One runtime flag, no
// further instantiation.
//
// Float caches (fp mode): fp32, or bf16 or float16 as the JAX engine
// stores its fp cache with kv_dtype="bfloat16" or "float16"
// (src/repro/kernels/decode_attention.py:109-110 reads it and casts it to
// fp32). A 16-bit row is D * 2 bytes, half the fp32 row, so a stage holds
// half the bytes and the same swizzle and cp.async copies move it; each
// value is widened to fp32 exactly where it is read (a bf16 value's bits
// as the high half of a float, a float16 one by __half2float), and the
// arithmetic is the fp32 cache's. One more cache type of the template
// each.
//
// Heads: a block takes GB = 16, 4 or 1 query heads of a group (the
// largest that divides G); the group's kv-head is read once per block.
//
// head_dim 112 (kimi-k2-1t-a32b, G = 8: GB = 4, the column path) with
// sub-channel chunks of 28 (C = 4): a row is 7, 14 or 28 pieces of 16
// bytes (int8, bf16, fp32), so the stage pads its rows to 8, 16 or 32
// pieces, where the XOR swizzle stays inside the row; a lane copies the
// tile's pieces in turn where their count a row does not divide 32; P.V
// gives a lane ceil(D / 32) = 4 columns, masking those at or past D; the
// chunk of column d is (d * cl_mul) >> 16, exact for d < 256, so a chunk
// length needs no power of two, only a whole number of 4-column groups.
//
// head_dim 256 (paligemma-3b, MQA 8/1: GB = 4, the column path; C = 4:
// chunks of 64 columns): P.V gives a lane DLM = 8 columns, a template
// parameter so that the instantiations at D <= 128 keep their four
// accumulators a head; a block takes at most 4 heads (decode_plan: 16 x
// 8 accumulators a lane would spill). A code row is 256, 512 or 1024
// bytes (int8, 16-bit, fp32): 16, 32 or 64 pieces, a power of two, so
// the swizzle's XOR of the row's index among 8 (kp >= 128) stays inside
// the row and 8 lanes reading piece c of 8 consecutive rows still hit 8
// bank groups; 64 pieces a row (fp32) do not divide a warp, so a lane
// copies the tile's pieces in turn. Two fp32 stages of 32 rows are 128
// KB a warp, so an fp32 cache runs one warp a block (block_smem), int8
// four and a 16-bit cache three.
//
// Shared memory is dynamic: GB*D*4 bytes of q (and C chunk sums on the
// row path, and the static table of 6 * C floats) plus, per warp, two stages of 32 rows of K and V codes (row
// pitch D*sizeof(KV): 1, 2 or 4 bytes a value) and the scale arrays (S and Z of K and V, and 1/S of
// each on the column path; row pitch C + 1 floats), a 32 x (GB+1) float P
// buffer and 64 valid-row masks. Registers, spills and the bytes a block
// takes at the serving shapes are printed by chip_smoke.py (PERF.md).
#include "decode_attention.cuh"

using namespace decode_attn;

// Bytes of dynamic shared memory a block takes (0 if it does not fit);
// kv_bytes: the cache's element size, 1 (int8), 2 (bf16, float16) or 4
// (fp32).
extern "C" int decode_attention_smem(int D, int C, int kv_bytes, int stat, int group,
                                     int warps) {
  const bool int8 = kv_bytes == 1;
  return (int)block_smem(D, int8 ? C : 0, kv_bytes, group, int8 && stat, warps);
}

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* kv_pos, const void* q_pos,
                                const void* ks, const void* kz, const void* vs,
                                const void* vz, void* o, void* part_o,
                                void* part_ml, void* counter, int N, int T,
                                int Hq, int Hkv, int D, int C, int kv_bytes,
                                int kv_f16, int stat, int q_is_bf16, int group,
                                int rows, int splits, int warps, float qscale,
                                void* stream) {
  const bool int8 = kv_bytes == 1;
  if (N <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (kv_bytes != 1 && kv_bytes != 2 && kv_bytes != 4) || (kv_f16 && kv_bytes != 2) ||
      (D != 32 && D != 64 && D != 112 && D != 128 && D != MAX_D) || rows <= 0 ||
      rows % TR != 0 || splits <= 0 || splits > MAX_SPLITS ||
      (D > 128 && group != 4 && group != 1) ||
      (long long)(splits - 1) * rows >= T || (long long)splits * rows < T ||
      warps < 1 || warps > MAX_WARPS || rows / TR > warps * MAX_TW ||
      (Hq / Hkv) % group != 0 ||
      (splits > 1 && (!part_o || !part_ml || !counter)))
    return (int)cudaErrorInvalidValue;
  // sub-channel chunks: cl = D / C columns, a whole number of 4-column
  // groups (D = 112, C = 4: 28), C dividing 32; the row path (D <= 64)
  // meets only powers of two
  int cl_mul = 0;
  if (int8) {
    if (C <= 0 || D % C != 0 || 32 % C != 0) return (int)cudaErrorInvalidValue;
    const int cl = D / C;
    if (cl < 4 || cl % 4) return (int)cudaErrorInvalidValue;
    cl_mul = (65536 + cl - 1) / cl;   // (d * cl_mul) >> 16 == d / cl for d < 256
  }
  Args a{q, k, v, (const int*)kv_pos, (const int*)q_pos, (const float*)ks,
         (const float*)kz, (const float*)vs, (const float*)vz, o,
         (float*)part_o, (float*)part_ml, (int*)counter,
         N, T, Hq, Hkv, D, int8 ? C : 0, cl_mul, rows, splits,
         int8 && stat ? 1 : 0, qscale};
  cudaStream_t st = (cudaStream_t)stream;
  using BF = __nv_bfloat16;
  if (q_is_bf16)
    return (int)(int8 ? dispatch_group<int8_t, BF>(a, group, warps, st)
                 : kv_f16 ? dispatch_group<__half, BF>(a, group, warps, st)
                 : kv_bytes == 2 ? dispatch_group<BF, BF>(a, group, warps, st)
                                 : dispatch_group<float, BF>(a, group, warps, st));
  return (int)(int8 ? dispatch_group<int8_t, float>(a, group, warps, st)
               : kv_f16 ? dispatch_group<__half, float>(a, group, warps, st)
               : kv_bytes == 2 ? dispatch_group<BF, float>(a, group, warps, st)
                               : dispatch_group<float, float>(a, group, warps, st));
}
