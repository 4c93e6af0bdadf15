// The quantize-on-write step (quant_rows) of the quantized ragged
// prefill's quantize pass (ragged_prefill_quant.cu): one warp a fresh
// row, NT threads a block.
#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace attend {

constexpr int NT = 256;             // threads per block
constexpr int NWARPS = NT / 32;

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Quantize-on-write of a chunk of fresh K (or V) token rows of type T
// (bf16 or fp16), staged as the values the cache will serve: per row,
// amax over D (one warp per row), scale = amax > 0 ? amax / qmax : 1,
// qf = clamp(rint(x / scale), +-qmax), and qf * scale rounded once to T
// into `dst` (T [ntok][D]). This is the reference's `_quantize_block`
// expression: it DIVIDES by the scale (IEEE division, since the kernels
// build without fast math) and rounds half to even (rintf), so payloads
// agree bit for bit with the plain version (x is exact in fp32 from
// either type). `src_of(t)` is the global address of fresh row t (T,
// 4-byte aligned); values move as pairs, one 4-byte word each. When `pay_of` is given,
// row t's payload (int8: D bytes; int4: D / 2, the even index in the low
// nibble) goes to `pay_of(t)` and its scale to `*scale_out_of(t)`.
template <typename T, typename SrcFn, typename PayFn, typename ScaleFn>
__device__ inline void quant_rows(T* dst, int ntok, int d, int bits, SrcFn src_of,
                                  PayFn pay_of, ScaleFn scale_out_of) {
  using E = hopper::Elem<T>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float qmax = bits == 4 ? 7.f : 127.f;
  for (int t = warp; t < ntok; t += NWARPS) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(src_of(t));
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + (size_t)t * d);
    float amax = 0.f;
    for (int p = lane; p < d / 2; p += 32) {
      const uint32_t w = src[p];
      amax = fmaxf(amax, fmaxf(fabsf(E::lo(w)), fabsf(E::hi(w))));
    }
    amax = warp_max(amax);
    const float s = amax > 0.f ? amax / qmax : 1.f;
    int8_t* pay = pay_of(t);
    for (int p = lane; p < d / 2; p += 32) {
      const uint32_t w = src[p];
      const float q0 = fminf(fmaxf(rintf(E::lo(w) / s), -qmax), qmax);
      const float q1 = fminf(fmaxf(rintf(E::hi(w) / s), -qmax), qmax);
      out[p] = E::pack(q0 * s, q1 * s);
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
