// The quantize-on-write step (quant_rows) of the quantized ragged
// prefill's quantize pass (ragged_prefill_quant.cu): one warp a fresh
// row, NT threads a block.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attend {

constexpr int NT = 256;             // threads per block
constexpr int NWARPS = NT / 32;

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Quantize-on-write of a chunk of fresh bf16 K (or V) token rows, staged
// as the values the cache will serve: per row, amax over D (one warp per
// row), scale = amax > 0 ? amax / qmax : 1, qf = clamp(rint(x / scale),
// +-qmax), and __float2bfloat16_rn(qf * scale) into `dst` (bf16
// [ntok][D]). This is the reference's `_quantize_block`
// expression: it DIVIDES by the scale (IEEE division, since the kernels
// build without fast math) and rounds half to even (rintf), so payloads
// agree bit for bit with the plain version. `src_of(t)` is the global
// address of fresh row t (bf16, 4-byte aligned). When `pay_of` is given,
// row t's payload (int8: D bytes; int4: D / 2, the even index in the low
// nibble) goes to `pay_of(t)` and its scale to `*scale_out_of(t)`.
template <typename SrcFn, typename PayFn, typename ScaleFn>
__device__ inline void quant_rows(__nv_bfloat16* dst, int ntok, int d, int bits,
                                  SrcFn src_of, PayFn pay_of, ScaleFn scale_out_of) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float qmax = bits == 4 ? 7.f : 127.f;
  for (int t = warp; t < ntok; t += NWARPS) {
    const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(src_of(t));
    float amax = 0.f;
    for (int p = lane; p < d / 2; p += 32) {
      const float2 x = __bfloat1622float2(src[p]);
      amax = fmaxf(amax, fmaxf(fabsf(x.x), fabsf(x.y)));
    }
    amax = warp_max(amax);
    const float s = amax > 0.f ? amax / qmax : 1.f;
    int8_t* pay = pay_of(t);
    for (int p = lane; p < d / 2; p += 32) {
      const float2 x = __bfloat1622float2(src[p]);
      const float q0 = fminf(fmaxf(rintf(x.x / s), -qmax), qmax);
      const float q1 = fminf(fmaxf(rintf(x.y / s), -qmax), qmax);
      dst[t * d + 2 * p] = __float2bfloat16_rn(q0 * s);
      dst[t * d + 2 * p + 1] = __float2bfloat16_rn(q1 * s);
      if (pay != nullptr) {
        const int i0 = (int)q0, i1 = (int)q1;
        if (bits == 4) {
          pay[p] = (int8_t)((i0 & 0xF) | ((i1 & 0xF) << 4));
        } else {
          pay[2 * p] = (int8_t)i0;
          pay[2 * p + 1] = (int8_t)i1;
        }
      }
    }
    if (pay != nullptr && lane == 0) *scale_out_of(t) = s;
  }
}

}  // namespace attend
