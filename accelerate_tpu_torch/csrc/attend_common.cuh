// Shared pieces of the dense decode kernels (bf16 and quantized), and
// the quantize-on-write step (quant_rows) of the quantized ragged
// prefill's quantize pass: one thread block stages a chunk of up to TOK
// kv tokens (K and V, bf16) in shared memory, scores its query rows against them in fp32, and folds
// the chunk into a per-row online softmax (running max m, running sum l,
// fp32 accumulator acc) kept in shared memory across chunks. The loop
// over chunks inside the block takes the place of the TPU grid's
// sequential kv axis, which carried m/l/acc in VMEM from step to step.
//
// Shared memory layout (dynamic, sized by attend_smem_bytes):
//   Ks [TOK][D] bf16 | Vs [TOK][D] bf16 | Qs [R][D] f32 | S [R][TOK] f32 |
//   Acc [R][D] f32 | M [R] f32 | L [R] f32 | Alpha [R] f32 | RowPos [R] i32
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attend {

constexpr int NT = 256;             // threads per block
constexpr int NWARPS = NT / 32;
constexpr int TOK = 64;             // kv tokens staged per chunk
constexpr float NEG_INF = -1e30f;   // the reference's masked score

struct Smem {
  __nv_bfloat16* ks;
  __nv_bfloat16* vs;
  float* qs;
  float* s;
  float* acc;
  float* m;
  float* l;
  float* alpha;
  int* rowpos;
};

__host__ __device__ inline size_t smem_bytes(int rows, int d) {
  return (size_t)2 * TOK * d * sizeof(__nv_bfloat16)
       + (size_t)rows * d * sizeof(float)          // Qs
       + (size_t)rows * TOK * sizeof(float)        // S
       + (size_t)rows * d * sizeof(float)          // Acc
       + (size_t)3 * rows * sizeof(float)          // M, L, Alpha
       + (size_t)rows * sizeof(int);               // RowPos
}

__device__ inline Smem carve(unsigned char* base, int rows, int d) {
  Smem sm;
  sm.ks = reinterpret_cast<__nv_bfloat16*>(base);
  sm.vs = sm.ks + TOK * d;
  sm.qs = reinterpret_cast<float*>(sm.vs + TOK * d);
  sm.s = sm.qs + rows * d;
  sm.acc = sm.s + rows * TOK;
  sm.m = sm.acc + rows * d;
  sm.l = sm.m + rows;
  sm.alpha = sm.l + rows;
  sm.rowpos = reinterpret_cast<int*>(sm.alpha + rows);
  return sm;
}

__device__ inline void init_state(const Smem& sm, int rows, int d) {
  for (int e = threadIdx.x; e < rows * d; e += NT) sm.acc[e] = 0.f;
  for (int r = threadIdx.x; r < rows; r += NT) {
    sm.m[r] = NEG_INF;
    sm.l[r] = 0.f;
  }
}

// Copy the chunk's token rows (D bf16 each, as 16-byte vectors) from
// global into shared. `src_of_k(t)` / `src_of_v(t)` return the global
// address of kv token t of the chunk.
template <typename KFn, typename VFn>
__device__ inline void load_chunk(const Smem& sm, int ntok, int d, KFn src_of_k,
                                  VFn src_of_v) {
  const int vecs = d / 8;  // uint4 = 8 bf16
  for (int idx = threadIdx.x; idx < ntok * vecs; idx += NT) {
    const int t = idx / vecs;
    const int c = idx - t * vecs;
    const uint4* ksrc = reinterpret_cast<const uint4*>(src_of_k(t)) + c;
    const uint4* vsrc = reinterpret_cast<const uint4*>(src_of_v(t)) + c;
    reinterpret_cast<uint4*>(sm.ks + t * d)[c] = *ksrc;
    reinterpret_cast<uint4*>(sm.vs + t * d)[c] = *vsrc;
  }
}

// Stage a chunk of quantized K (or V) token rows as bf16 in shared memory:
// each value is the int8 payload (int4: two values a byte, the even
// head_dim index in the low nibble) times its row's fp32 scale, computed
// in fp32 and rounded ONCE to bf16 with __float2bfloat16_rn. That is
// dequantize_kv's `(payload.float() * scale).to(bf16)`, so the kernel
// scores exactly the bf16 values the plain version scores. `payload_of(t)`
// is the global address of token t's payload row (d bytes for int8, d / 2
// for int4; 16-byte aligned), `scale_of(t)` its scale. Each thread turns
// one 16-byte load into 16 (int8) or 32 (int4) bf16 values.
template <typename PayFn, typename ScaleFn>
__device__ inline void dequant_rows(__nv_bfloat16* dst, int ntok, int d, int bits,
                                    PayFn payload_of, ScaleFn scale_of) {
  const int per_vec = bits == 4 ? 32 : 16;  // values one 16-byte load holds
  const int vecs = d / per_vec;
  for (int idx = threadIdx.x; idx < ntok * vecs; idx += NT) {
    const int t = idx / vecs;
    const int c = idx - t * vecs;
    const uint4 raw = reinterpret_cast<const uint4*>(payload_of(t))[c];
    const float s = scale_of(t);
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
    __align__(16) __nv_bfloat16 vals[32];
    if (bits == 4) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int lo = (int)(int8_t)((uint8_t)bytes[i] << 4) >> 4;  // sign-extend
        const int hi = (int)bytes[i] >> 4;                           // arithmetic
        vals[2 * i] = __float2bfloat16_rn((float)lo * s);
        vals[2 * i + 1] = __float2bfloat16_rn((float)hi * s);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) vals[i] = __float2bfloat16_rn((float)bytes[i] * s);
    }
    uint4* out = reinterpret_cast<uint4*>(dst + t * d + c * per_vec);
    const uint4* src = reinterpret_cast<const uint4*>(vals);
    for (int v = 0; v < per_vec / 8; ++v) out[v] = src[v];
  }
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Quantize-on-write of a chunk of fresh bf16 K (or V) token rows, staged
// as the values the cache will serve: per row, amax over D (one warp per
// row), scale = amax > 0 ? amax / qmax : 1, qf = clamp(rint(x / scale),
// +-qmax), and __float2bfloat16_rn(qf * scale) into `dst` (bf16 [ntok][D]
// in shared memory). This is the reference's `_quantize_block`
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

// S[r][t] = scale * (q_r . k_t) for valid (r, t), NEG_INF otherwise.
// One warp per kv token: each lane holds D/32 of the token's K values and
// reduces one partial per query row across the warp. `valid(r, t)` is the
// per-element mask of the caller's phase.
template <typename ValidFn>
__device__ inline void score_chunk(const Smem& sm, int rows, int ntok, int d,
                                   float scale, ValidFn valid) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = warp; t < ntok; t += NWARPS) {
    const __nv_bfloat16* krow = sm.ks + t * d;
    for (int r = 0; r < rows; ++r) {
      const float* qrow = sm.qs + r * d;
      float part = 0.f;
      for (int c = lane; c < d; c += 32) part += qrow[c] * __bfloat162float(krow[c]);
      part = warp_sum(part);
      if (lane == 0) sm.s[r * TOK + t] = valid(r, t) ? part * scale : NEG_INF;
    }
  }
}

// Online-softmax update for one chunk: per row, m_next = max(m, max_t s),
// alpha = exp(m - m_next), p = exp(s - m_next) with masked entries forced
// to exactly 0, l = l * alpha + sum(p). p overwrites S.
__device__ inline void softmax_chunk(const Smem& sm, int rows, int ntok) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += NWARPS) {
    float* srow = sm.s + r * TOK;
    float mx = NEG_INF;
    for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, srow[t]);
    mx = warp_max(mx);
    const float m_prev = sm.m[r];
    const float m_next = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < ntok; t += 32) {
      const float sv = srow[t];
      const float p = (sv == NEG_INF) ? 0.f : expf(sv - m_next);
      srow[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_next);
      sm.alpha[r] = alpha;
      sm.l[r] = sm.l[r] * alpha + sum;
      sm.m[r] = m_next;
    }
  }
}

// acc[r][:] = acc[r][:] * alpha[r] + sum_t bf16(p[r][t]) * v[t][:], with
// p rounded to bf16 before the product as the TPU kernel's p.astype(v)
// does, and the sum kept in fp32. Each thread owns whole acc elements.
__device__ inline void pv_chunk(const Smem& sm, int rows, int ntok, int d) {
  for (int e = threadIdx.x; e < rows * d; e += NT) {
    const int r = e / d;
    const int c = e - r * d;
    const float* prow = sm.s + r * TOK;
    float a = sm.acc[e] * sm.alpha[r];
    for (int t = 0; t < ntok; ++t) {
      const float p = __bfloat162float(__float2bfloat16(prow[t]));
      a += p * __bfloat162float(sm.vs[t * d + c]);
    }
    sm.acc[e] = a;
  }
}

// Fold one staged chunk (Ks/Vs filled, not yet synchronised) into the
// rows' online softmax: scores under `valid(r, t)`, the softmax update,
// the PV product. Ends synchronised, so the next chunk may be staged.
template <typename ValidFn>
__device__ inline void attend_staged_chunk(const Smem& sm, int rows, int ntok, int d,
                                           float scale, ValidFn valid) {
  __syncthreads();
  score_chunk(sm, rows, ntok, d, scale, valid);
  __syncthreads();
  softmax_chunk(sm, rows, ntok);
  __syncthreads();
  pv_chunk(sm, rows, ntok, d);
  __syncthreads();
}

// out row r = acc[r] / l[r] (l == 0 -> divide by 1: a fully masked row
// gives exactly 0), cast to bf16. `dst_of(r)` is row r's global address.
template <typename DstFn>
__device__ inline void write_rows(const Smem& sm, int rows, int d, DstFn dst_of) {
  for (int e = threadIdx.x; e < rows * d; e += NT) {
    const int r = e / d;
    const int c = e - r * d;
    const float l = sm.l[r];
    const float safe_l = (l == 0.f) ? 1.f : l;
    dst_of(r)[c] = __float2bfloat16(sm.acc[e] / safe_l);
  }
}

}  // namespace attend
