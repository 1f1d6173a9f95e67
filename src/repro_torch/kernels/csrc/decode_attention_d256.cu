// head_dim 256 instantiations of the decode attention kernel
// (decode_attention.cuh): GB = 4 and 1 query heads a block, eight P.V
// columns a lane, for every cache type (int8, fp32, bf16, float16) and
// query type (fp32, bf16). Compiled by an nvcc of its own so that the
// build of decode_attention.cu does not carry them too.
#include "decode_attention.cuh"

namespace decode_attn {

template <typename KV, typename Q>
cudaError_t dispatch_d256(const Args& a, int group, int warps, cudaStream_t st) {
  switch (group) {
    case 4: return launch<4, 0, KV, Q, 8>(a, warps, st);
    case 1: return launch<1, 0, KV, Q, 8>(a, warps, st);
    default: return cudaErrorInvalidValue;
  }
}

#define DECODE_D256(KV, Q) \
  template cudaError_t dispatch_d256<KV, Q>(const Args&, int, int, cudaStream_t);
DECODE_D256(int8_t, float)
DECODE_D256(int8_t, __nv_bfloat16)
DECODE_D256(float, float)
DECODE_D256(float, __nv_bfloat16)
DECODE_D256(__nv_bfloat16, float)
DECODE_D256(__nv_bfloat16, __nv_bfloat16)
DECODE_D256(__half, float)
DECODE_D256(__half, __nv_bfloat16)
#undef DECODE_D256

}  // namespace decode_attn
