// Shared pieces of the flash-attention kernels: the masks and their
// semantics, NEG_INF and the shared-memory opt-in serve all three; the
// tiles and products below serve the two backward kernels (dQ, dK/dV).
// The forward runs on the tensor cores instead (flash_fwd.cu, hopper.cuh).
//
// Each backward kernel works on tiles staged in shared memory as fp32 and
// computes its products on the CUDA cores with fp32 FMAs: bf16 inputs convert
// exactly, so each product equals the TPU kernel's bf16-in, fp32-
// accumulate dot up to the order of summation. A block has NT = 256
// threads seen as a 16 x 16 grid (tx = tid % 16, ty = tid / 16); a thread
// owns a small register tile of every product it takes part in.
//
// Layouts. A product C[i][j] += sum_k A[i][k] B[k][j] reads both operands
// "k-major" from shared memory: At[k][i] and B[k][j], each row padded by
// PAD floats, so a thread reads its 4 (or 2) consecutive i's or j's as one
// float4 (float2) and neighbouring threads read neighbouring addresses.
// Tiles are loaded from global memory either row-major (X[r][d]) or
// transposed (Xt[d][r]), whichever the product needs.
//
// Masking follows the TPU kernel (accelerate_tpu/ops/attention.py
// _mask_block): causal is cols <= rows on global indices (top-left
// aligned), kv_mask [B, Skv] nonzero = may be attended, segment ids
// [B, S] attend iff equal. A masked score is NEG_INF = -1e30 and its
// probability is forced to exactly 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int NT = 256;           // threads per block
constexpr int TX = 16;            // threads along a tile's column axis
constexpr int PAD = 4;            // row padding (floats): keeps float4 alignment
constexpr float NEG_INF = -1e30f; // the reference's masked score

typedef __nv_bfloat16 bf16;

// The optional masks of a call; null pointers mean "absent".
struct Masks {
  const int* kv_mask;  // [B, Skv]
  const int* q_seg;    // [B, Sq]
  const int* kv_seg;   // [B, Skv]
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [0, R) of a row-major [R, D] bf16 block -> dst[R][D + PAD] fp32.
// Neighbouring threads read neighbouring 16-byte vectors of one row.
template <int R, int D>
__device__ __forceinline__ void load_rows(float* dst, const bf16* src) {
  constexpr int V = D / 8;
  for (int idx = threadIdx.x; idx < R * V; idx += NT) {
    const int r = idx / V;
    const int c = (idx - r * V) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
    float* o = dst + r * (D + PAD) + c;
    *reinterpret_cast<float4*>(o) = make_float4(
        __bfloat162float(h[0]), __bfloat162float(h[1]),
        __bfloat162float(h[2]), __bfloat162float(h[3]));
    *reinterpret_cast<float4*>(o + 4) = make_float4(
        __bfloat162float(h[4]), __bfloat162float(h[5]),
        __bfloat162float(h[6]), __bfloat162float(h[7]));
  }
}

// the same block transposed -> dst[D][R + PAD] fp32. Neighbouring threads
// take neighbouring rows, so the shared-memory stores do not conflict.
template <int R, int D>
__device__ __forceinline__ void load_rows_t(float* dst, const bf16* src) {
  constexpr int V = D / 8;
  for (int idx = threadIdx.x; idx < R * V; idx += NT) {
    const int r = idx % R;
    const int c = (idx / R) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * (R + PAD) + r] = __bfloat162float(h[j]);
  }
}

// n consecutive int32 values (a mask row segment) -> shared
__device__ __forceinline__ void load_ints(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

template <int N>
__device__ __forceinline__ void load_vec(float (&x)[N], const float* p);

template <>
__device__ __forceinline__ void load_vec<4>(float (&x)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

template <>
__device__ __forceinline__ void load_vec<2>(float (&x)[2], const float* p) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  x[0] = t.x; x[1] = t.y;
}

// acc[i][j] += sum_{k < K} At[k][i0 + i] * Bt[k][j0 + j]  (i < RM, j < RN)
template <int RM, int RN, int K>
__device__ __forceinline__ void mm(float (&acc)[RM][RN], const float* at, int lda,
                                   int i0, const float* bt, int ldb, int j0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM], b[RN];
    load_vec<RM>(a, at + k * lda + i0);
    load_vec<RN>(b, bt + k * ldb + j0);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The head-dim product: acc[i][4g + j] += sum_{k < K} At[k][i0 + i] *
// B[k][64g + j0 + j] for g < D/64, j < 4. Splitting a thread's 4 * D/64
// output columns into groups 64 apart keeps each float4 read of B
// contiguous across the 16 threads of a row (tx * 4 for tx < 16).
template <int D, int K>
__device__ __forceinline__ void mm_d(float (&acc)[4][D / 16], const float* at, int lda,
                                     int i0, const float* b, int j0) {
  constexpr int NG = D / 64;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4];
    load_vec<4>(a, at + k * lda + i0);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float x[4];
      load_vec<4>(x, b + k * (D + PAD) + 64 * g + j0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][4 * g + j] = fmaf(a[i], x[j], acc[i][4 * g + j]);
    }
  }
}

// store rows i0 + i (i < 4) of a [*, D] output tile, columns as mm_d
// lays them out, divided by div[i], as bf16
template <int D>
__device__ __forceinline__ void store_rows_d(bf16* dst, const float (&acc)[4][D / 16],
                                             int i0, int j0, const float (&div)[4]) {
  constexpr int NG = D / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      bf16* o = dst + (size_t)(i0 + i) * D + 64 * g + j0;
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][4 * g] / div[i],
                                                acc[i][4 * g + 1] / div[i]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][4 * g + 2] / div[i],
                                                acc[i][4 * g + 3] / div[i]);
      reinterpret_cast<__nv_bfloat162*>(o)[0] = lo;
      reinterpret_cast<__nv_bfloat162*>(o)[1] = hi;
    }
}

// Is (query row `row`, kv column `col`) attended? `qseg` is the query
// row's segment id (ignored without segments); `kvm` / `kvs` the column's
// kv_mask / segment id, staged by the caller.
__device__ __forceinline__ bool attended(bool causal, const Masks& mk, int row, int col,
                                         int qseg, int kvm, int kvs) {
  if (causal && col > row) return false;
  if (mk.kv_mask && kvm == 0) return false;
  if (mk.q_seg && qseg != kvs) return false;
  return true;
}

// Opt a kernel into more than 48 KB of dynamic shared memory, once.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace flash
