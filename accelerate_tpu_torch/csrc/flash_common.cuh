// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the masks and their semantics,
// NEG_INF, the load of one K/V ring tile, the store of a wgmma
// accumulator's rows and the shared-memory opt-in. The Hopper building
// blocks (TMA, mbarriers, wgmma) are in hopper.cuh.
//
// Masking follows the TPU kernel (accelerate_tpu/ops/attention.py
// _mask_block): causal is cols <= rows on global indices (top-left
// aligned), kv_mask [B, Skv] nonzero = may be attended, segment ids
// [B, S] attend iff equal. A masked score is NEG_INF = -1e30 in the
// reference and its probability is forced to exactly 0; the kernels make
// a masked score -inf, so its exp2 is exactly 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

constexpr float NEG_INF = -1e30f; // the reference's masked score
constexpr float LOG2E = 1.4426950408889634f;  // scores in log2 units: p = exp2

typedef __nv_bfloat16 bf16;

// The optional masks of a call; null pointers mean "absent".
struct Masks {
  const int* kv_mask;  // [B, Skv]
  const int* q_seg;    // [B, Sq]
  const int* kv_seg;   // [B, Skv]
};

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

// ---- dS rounded as the plain version rounds it ----------------------
//
// Both backward kernels round dS = p (dP - delta) scale to bf16 where the
// TPU kernel does (ds.astype(k.dtype)). Their S and dP come from wgmma,
// whose fp32 sums run in another order than the plain version's fp32
// matmul (a cuBLAS SGEMM: one FMA per d, in d order; a replay in that
// order matched it bit for bit on an H100), so the two fp32 dS differ by
// a few ulps (far more only where dP - delta cancels and dS is small).
// Where that straddles a bf16 rounding boundary the two round one bf16 ulp
// apart, and a large dS (a row or column with few attended keys, p near
// 1) carries that ulp into dQ or dK as an error the size of the whole
// tolerance. So an element with p >= REPLAY_MIN_P whose fp32 dS lies
// within REPLAY_WINDOW fp32 ulps of a boundary is computed again from the
// tiles in shared memory, in the plain version's order and rounding
// (ds_replay), and rounds as the plain version does. Below REPLAY_MIN_P a
// flipped dS moves dQ / dK by at most 2^-8 of a term that is itself under
// 2^-8 of its row's probability mass.
//
// The fp16 entries round dS to fp16, which drops 13 of fp32's mantissa
// bits where bf16 drops 16: the same window, as a share of the rounding
// step (1/256 of it), is REPLAY_WINDOW / 8 ulps of the low 13 bits (dS in
// fp16's normal range; a subnormal dS is too small to matter).
constexpr int REPLAY_WINDOW = 256;
constexpr float REPLAY_MIN_P = 1.f / 256;

template <typename T = bf16>
__device__ __forceinline__ bool replay_ds(float p, float ds) {
  if constexpr (hopper::is_f16<T>) {
    const int lo = (int)(__float_as_uint(ds) & 0x1FFFu);
    return p >= REPLAY_MIN_P && abs(lo - 0x1000) < REPLAY_WINDOW / 8;
  } else {
    const int lo = (int)(__float_as_uint(ds) & 0xFFFFu);
    return p >= REPLAY_MIN_P && abs(lo - 0x8000) < REPLAY_WINDOW;
  }
}

// 16-byte chunk c (16-bit elements 8 c .. 8 c + 7) of row r of a tile that
// TMA wrote in 64-column boxes of `box` bytes with the 128-byte swizzle
__device__ __forceinline__ uint4 swizzled_chunk(const uint8_t* tile, int box, int r, int c) {
  return *reinterpret_cast<const uint4*>(tile + (c / 8) * box + r * 128 + ((c % 8) ^ (r % 8)) * 16);
}

// acc + x.lo y.lo, then + x.hi y.hi: two fp32 FMAs over a pair of T
// (the low half of a word is the lower d)
template <typename T>
__device__ __forceinline__ float fma_x2(uint32_t x, uint32_t y, float acc) {
  using E = hopper::Elem<T>;
  acc = fmaf(E::lo(x), E::lo(y), acc);
  return fmaf(E::hi(x), E::hi(y), acc);
}

// dS of (query row qr of the Q / dO tiles, kv row kr of the K / V tiles)
// in the plain version's order and rounding: s = q . k and dP = dO . v,
// each one fp32 FMA per d in d order from 0 (the plain version's matmul,
// bit for bit), then p = exp(s * scale - lse) and dS = p (dP - delta)
// scale one rounded step at a time, as the plain version's elementwise
// ops take them (the _rn intrinsics keep the compiler from fusing two
// steps into one FMA). q_box / k_box are the box sizes of the query-side
// and kv-side tiles. The loop is not unrolled: its loads would otherwise
// be hoisted into registers the accumulators need.
template <int D, typename T = bf16>
__device__ __forceinline__ float ds_replay(const uint8_t* q, const uint8_t* dout, int q_box, int qr,
                                           const uint8_t* k, const uint8_t* v, int k_box, int kr,
                                           float lse, float delta, float scale) {
  float s = 0.f, dp = 0.f;
#pragma unroll 1
  for (int c = 0; c < D / 8; ++c) {
    const uint4 a = swizzled_chunk(q, q_box, qr, c), b = swizzled_chunk(k, k_box, kr, c);
    const uint4 x = swizzled_chunk(dout, q_box, qr, c), y = swizzled_chunk(v, k_box, kr, c);
    s = fma_x2<T>(a.x, b.x, s);
    dp = fma_x2<T>(x.x, y.x, dp);
    s = fma_x2<T>(a.y, b.y, s);
    dp = fma_x2<T>(x.y, y.y, dp);
    s = fma_x2<T>(a.z, b.z, s);
    dp = fma_x2<T>(x.z, y.z, dp);
    s = fma_x2<T>(a.w, b.w, s);
    dp = fma_x2<T>(x.w, y.w, dp);
  }
  const float p = expf(__fsub_rn(__fmul_rn(s, scale), lse));
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// Thread 0's load of one ring tile of the forward and dQ kernels: rows
// [k0, k0 + ROWS) of K and V of kv matrix `bkv`, BOXES boxes of 64
// columns each (K at `st`, V BOXES * ROWS * 128 bytes further), then the
// tile's kv_mask and kv_seg rows (ROWS ints each, when present), all
// counted on `bar`. Rows past Skv read as zeros.
template <int BOXES, int ROWS>
__device__ __forceinline__ void load_kv_tile(uint8_t* st, const CUtensorMap* tk,
                                             const CUtensorMap* tv, uint64_t* bar,
                                             const Masks& mk, int b, int bkv, int k0, int Skv) {
  constexpr int BOX = ROWS * 128;  // bytes of one box
  constexpr int BYTES = BOXES * BOX;
  const uint32_t mask_bytes = 4u * (uint32_t)min(ROWS, Skv - k0);
  uint32_t bytes = 2 * BYTES;
  if (mk.kv_mask) bytes += mask_bytes;
  if (mk.kv_seg) bytes += mask_bytes;
  hopper::mbar_expect_tx(bar, bytes);
#pragma unroll
  for (int c = 0; c < BOXES; ++c) {
    hopper::tma_load_3d(st + c * BOX, tk, bar, 64 * c, k0, bkv);
    hopper::tma_load_3d(st + BYTES + c * BOX, tv, bar, 64 * c, k0, bkv);
  }
  int* kvm = reinterpret_cast<int*>(st + 2 * BYTES);
  if (mk.kv_mask) hopper::bulk_load(kvm, mk.kv_mask + (size_t)b * Skv + k0, mask_bytes, bar);
  if (mk.kv_seg) hopper::bulk_load(kvm + ROWS, mk.kv_seg + (size_t)b * Skv + k0, mask_bytes, bar);
}

// A thread's share of a [64 x D] fp32 wgmma accumulator (register i: row
// (i / 2) % 2 of the thread's two, column 8 (i / 4) + 2 (lane % 4) + i % 2)
// -> T (bf16 or fp16) rows row[0] and row[1] of the row-major [rows, D]
// tensor at `out`; rows at or past `rows` are not stored.
template <int D, typename T = bf16>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[D / 2],
                                          const int (&row)[2], int rows, int lane) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (row[u] >= rows) continue;
    T* dst = out + (size_t)row[u] * D + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * u;
      *reinterpret_cast<uint32_t*>(dst + 8 * c) = hopper::pack<T>(acc[i], acc[i + 1]);
    }
  }
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
