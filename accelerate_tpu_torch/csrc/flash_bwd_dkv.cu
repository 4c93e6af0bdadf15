// Flash-attention backward, dK and dV, for Hopper (sm_90a) on the tensor
// cores, bf16 in and out (flash_bwd_dkv_launch) or fp16 in and out
// (flash_bwd_dkv_f16_launch: the same kernel with the element type T a
// template parameter, hopper.cuh Elem). In fp16 a dS past fp16's range
// rounds to +-inf and reaches dK, where a loss scale's finite check sees
// it. fp16 keeps 11 significant bits where bf16 keeps 8: one fp16 p in
// the dV product lands within a fifth of the flash tolerance of the fp32
// product (tests/test_torch_fp16_flash.py), so the fp16 entry takes p
// once, as the reference's p.astype(do.dtype) in fp16, and skips the lo
// product below: four products, not five.
//
// Replaces the TPU kernel `_dkv_kernel` (accelerate_tpu/ops/attention.py,
// launched by `_flash_bwd_call`): for each kv row t of kv head kvh,
// dV[t] = sum over the query heads of kvh's group and their query rows r
// of p[r][t] dO[r], and dK[t] = sum of dS[r][t] q[r], with p = exp(s - lse)
// (masked entries exactly 0), dP = dO V^T and dS = p (dP - delta) scale.
// The query-head group is summed in-kernel, as the TPU grid did with its
// (group member, query block) axis, so K/V are never expanded.
//
// Bound: operations. Four products per (query, key) pair (S, dP, dV, dK):
// ~2.7e11 flops at the training shape (B 8, S 2048, H 16, KVH 8, D 128,
// causal), far above the card's ridge; only wgmma reaches the tensor
// cores' rate.
//
// Design. The TPU kernel carried dk_acc / dv_acc across its sequential
// grid axis; here one block owns one (b, kv head, 128-row kv tile) as two
// warpgroups of 64 kv rows, keeps dK and dV in fp32 registers and walks
// every (group member, 64-row query tile) pair itself: no atomics,
// deterministic sums.
// - K and V are loaded once by TMA (64-column boxes, 128-byte swizzle,
//   see hopper.cuh). Q and dO go through a ring of two stages with "full"
//   and "empty" barriers, thread 0 issuing each load one tile ahead; the
//   tile's lse, delta and q_seg rows are bulk-copied on the same barrier.
// - The scores are computed transposed: S^T = K Q^T and dP^T = V dO^T,
//   m64n64k16 wgmmas with both operands K-major. Rows are kv positions,
//   columns query rows, so lse and delta are read by column. P^T and dS^T
//   then sit in the accumulator layout that is, pair by pair, the A
//   fragment of the next wgmma: dV += P^T dO and dK += dS^T Q are
//   m64nDk16 wgmmas with A from registers and dO / Q MN-major (the
//   transpose bit). The same swizzled Q and dO tiles serve both roles;
//   only the descriptor differs.
// - p = exp2(s scale log2(e) - lse log2(e)); a masked score is -inf, so
//   its p is exactly 0.
// - Rounding sites copy the TPU kernel's. dS is rounded to bf16 (q's
//   dtype) before the dK product; the rare elements with a large p whose
//   fp32 dS lies near a bf16 rounding boundary are first recomputed in the
//   plain version's summation order (ds_replay, flash_common.cuh), so that
//   wgmma's other order does not round them one bf16 ulp apart. p stays
//   fp32 in the dV product (the TPU kernel upcasts dO, so
//   p.astype(do.dtype) is fp32): p is split into hi = T(p) and lo =
//   T(p - hi), and dV takes both products, which carries p to ~16
//   significant bits (a bf16 p alone misses the fp32 sum where many large
//   p terms cancel in the early kv rows). Five products where the
//   function needs four.
// - Causal: query tiles wholly before the kv tile are not walked, a
//   warpgroup skips the products of a tile wholly before its own first
//   row, and kv tile 0 (the longest walk) is launched first.
// - Ragged edges: Sq and Skv are multiples of 64. The last kv tile may
//   hold 64 rows past Skv: TMA reads them as zeros, their warpgroup skips
//   its products and they are not stored. Query tiles are 64 rows, so
//   none is ragged.
//
// Shared memory (dynamic, 1024-byte aligned): K [D/64][128][64] | V
// [D/64][128][64] | STAGES x (Q [D/64][64][64] | dO [D/64][64][64] | lse
// [64] | delta [64] | q_seg [64], padded to 1 KB) | barriers. 130 KB at
// D 128, one block per SM.
#include <math_constants.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int BK = 128;      // kv rows per block
constexpr int BQ = 64;       // query rows per tile
constexpr int WG_ROWS = 64;  // kv rows per warpgroup
constexpr int THREADS = 256;
constexpr int STAGES = 2;
constexpr int CONSUMER_WARPS = THREADS / 32;

template <int D>
struct Layout {
  static constexpr int BOXES = D / 64;          // 64-column boxes per row
  static constexpr int KV_BOX = BK * 128;       // bytes of one K or V box
  static constexpr int KV_BYTES = BOXES * KV_BOX;
  static constexpr int Q_BOX = BQ * 128;        // bytes of one Q or dO box
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int STAGE_OFF = 2 * KV_BYTES;
  static constexpr int STAGE = 2 * Q_BYTES + 1024;  // Q, dO, then the row vectors
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;    // room to align the base
  static_assert(3 * BQ * 4 <= 1024, "row vectors of a stage");
  static_assert(STAGE % 1024 == 0 && STAGE_OFF % 1024 == 0, "swizzle atoms");
  static_assert(ALLOC <= 232448, "shared memory of one block");
};

// The walk of one block: tile j is query tile iq_first + j % n_iq of
// group member j / n_iq.
struct Walk {
  int group, iq_first, n_iq;
};

// thread 0: tile j's Q and dO (and its lse, delta and q_seg rows) into
// stage j % STAGES, all counted on that stage's full barrier
template <int D>
__device__ __forceinline__ void issue_q(uint8_t* smem, int j, const Walk& w,
                                        const CUtensorMap* tq, const CUtensorMap* tdo,
                                        uint64_t* full, const float* lse, const float* delta,
                                        const Masks& mk, int b, int kvh, int H, int Sq) {
  using L = Layout<D>;
  const int s = j % STAGES;
  uint8_t* st = smem + L::STAGE_OFF + s * L::STAGE;
  const int bh = b * H + kvh * w.group + j / w.n_iq;
  const int q0 = (w.iq_first + j % w.n_iq) * BQ;
  constexpr uint32_t ROW_BYTES = 4 * BQ;
  mbar_expect_tx(&full[s], 2 * L::Q_BYTES + (mk.q_seg ? 3 : 2) * ROW_BYTES);
#pragma unroll
  for (int c = 0; c < L::BOXES; ++c) {
    tma_load_3d(st + c * L::Q_BOX, tq, &full[s], 64 * c, q0, bh);
    tma_load_3d(st + L::Q_BYTES + c * L::Q_BOX, tdo, &full[s], 64 * c, q0, bh);
  }
  float* rows = reinterpret_cast<float*>(st + 2 * L::Q_BYTES);
  bulk_load(rows, lse + (size_t)bh * Sq + q0, ROW_BYTES, &full[s]);
  bulk_load(rows + BQ, delta + (size_t)bh * Sq + q0, ROW_BYTES, &full[s]);
  if (mk.q_seg) bulk_load(rows + 2 * BQ, mk.q_seg + (size_t)b * Sq + q0, ROW_BYTES, &full[s]);
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta, Masks mk,
    T* __restrict__ dk, T* __restrict__ dv, int H, int KVH, int Sq, int Skv,
    int causal, float scale) {
  using L = Layout<D>;
  constexpr int NA = D / 2;   // dK / dV accumulator floats a thread
  constexpr int NS = BQ / 2;  // S^T / dP^T accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ks = smem;
  uint8_t* vs = smem + L::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int ik = blockIdx.x;  // kv tile 0 walks the most query tiles: first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = ik * BK;
  const int bkv = b * KVH + kvh;
  const int nq = Sq / BQ;
  // causal: query tile iq has a row >= k0 iff (iq + 1) * BQ > k0
  const int iq_first = causal ? min(k0 / BQ, nq) : 0;
  const Walk w{H / KVH, iq_first, nq - iq_first};
  const int n_tiles = w.group * w.n_iq;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
#pragma unroll
    for (int c = 0; c < L::BOXES; ++c) {
      tma_load_3d(ks + c * L::KV_BOX, &tk, kv_full, 64 * c, k0, bkv);
      tma_load_3d(vs + c * L::KV_BOX, &tv, kv_full, 64 * c, k0, bkv);
    }
    if (n_tiles > 0) issue_q<D>(smem, 0, w, &tq, &tdo, full, lse, delta, mk, b, kvh, H, Sq);
  }

  // this thread's two kv rows of the accumulators: r and r + 8 of the
  // block, with their kv_mask and segment id
  const int r_lo = wg * WG_ROWS + warp * 16 + lane / 4;
  const int krow[2] = {k0 + r_lo, k0 + r_lo + 8};
  int kvm[2] = {1, 1}, kvs[2] = {0, 0};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (krow[u] >= Skv) continue;
    if (mk.kv_mask) kvm[u] = mk.kv_mask[(size_t)b * Skv + krow[u]];
    if (mk.kv_seg) kvs[u] = mk.kv_seg[(size_t)b * Skv + krow[u]];
  }
  const int wg_row0 = k0 + wg * WG_ROWS;  // the warpgroup's first kv row
  const float scale_log2 = scale * LOG2E;

  float dk_acc[NA], dv_acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const uint8_t* k_wg = ks + wg * WG_ROWS * 128;
  const uint8_t* v_wg = vs + wg * WG_ROWS * 128;
  mbar_wait(kv_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    if (tid == 0 && j + 1 < n_tiles) {
      const int j1 = j + 1;
      if (j1 >= STAGES) mbar_wait(&empty[j1 % STAGES], (j1 / STAGES - 1) & 1);
      issue_q<D>(smem, j1, w, &tq, &tdo, full, lse, delta, mk, b, kvh, H, Sq);
    }
    __syncwarp();
    mbar_wait(&full[s], (j / STAGES) & 1);
    const uint8_t* qst = smem + L::STAGE_OFF + s * L::STAGE;
    const uint8_t* dost = qst + L::Q_BYTES;
    const float* lse_s = reinterpret_cast<const float*>(qst + 2 * L::Q_BYTES);
    const float* delta_s = lse_s + BQ;
    const int* qseg_s = reinterpret_cast<const int*>(delta_s + BQ);
    const int q0 = (w.iq_first + j % w.n_iq) * BQ;

    // a warpgroup whose kv rows all lie past Skv, or (causal) all after
    // the tile's last query row, has nothing to add from this tile
    if (wg_row0 < Skv && !(causal && q0 + BQ - 1 < wg_row0)) {
      // S^T = K Q^T and dP^T = V dO^T over D in k16 steps: box kk / 4, 32
      // bytes a step inside it; the first step overwrites (scale_d 0, as
      // in flash_bwd_dq.cu)
      float st[NS], dpt[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int koff = (kk / 4) * L::KV_BOX + (kk % 4) * 32;
        const int off = (kk / 4) * L::Q_BOX + (kk % 4) * 32;
        wgmma_m64n64k16_ss<T>(st, sw128_desc(k_wg + koff, 16, 1024), sw128_desc(qst + off, 16, 1024),
                           kk > 0);
        wgmma_m64n64k16_ss<T>(dpt, sw128_desc(v_wg + koff, 16, 1024),
                           sw128_desc(dost + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // masks; register i is kv row r_lo + 8 ((i / 2) % 2), query column
      // 8 (i / 4) + 2 (lane % 4) + i % 2 of the tile
      if ((causal && wg_row0 + WG_ROWS - 1 > q0) || mk.kv_mask || mk.q_seg) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int u = (i / 2) % 2;
          const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (!attended(causal, mk, q0 + col, krow[u], mk.q_seg ? qseg_s[col] : 0, kvm[u],
                        kvs[u]))
            st[i] = -CUDART_INF_F;
        }
      }

      // P^T (as hi + lo) as T A fragments, and dS^T in fp32 in place of
      // dP^T: k16 step kk is registers 8 kk .. 8 kk + 7, register i holds
      // query column 8 (i / 4) + 2 (lane % 4) + i % 2. The large dS
      // elements near a bf16 rounding boundary are flagged and replayed in
      // the plain version's order (flash_common.cuh), one per lane per round
      uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4], near = 0;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = 8 * kk + 2 * t;
          const int col = 16 * kk + 8 * (t / 2) + 2 * (lane % 4);
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
          const float p0 = exp2f(fmaf(st[i], scale_log2, -l2.x * LOG2E));  // masked: 0
          const float p1 = exp2f(fmaf(st[i + 1], scale_log2, -l2.y * LOG2E));
          const uint32_t hi = pack<T>(p0, p1);
          p_hi[kk][t] = hi;
          if constexpr (!is_f16<T>)
            p_lo[kk][t] = pack<T>(p0 - Elem<T>::lo(hi), p1 - Elem<T>::hi(hi));
          dpt[i] = p0 * (dpt[i] - d2.x) * scale;
          dpt[i + 1] = p1 * (dpt[i + 1] - d2.y) * scale;
          if (replay_ds<T>(p0, dpt[i])) near |= 1u << i;
          if (replay_ds<T>(p1, dpt[i + 1])) near |= 2u << i;
        }
      while (__any_sync(0xffffffffu, near)) {
        const int i = __ffs(near) - 1;  // -1: nothing left on this lane
        float ds = 0.f;
        if (i >= 0) {
          near &= near - 1;
          const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          ds = ds_replay<D, T>(qst, dost, L::Q_BOX, col, ks, vs, L::KV_BOX, r_lo + 8 * ((i / 2) % 2),
                            lse_s[col], delta_s[col], scale);
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
          if (j == i) dpt[j] = ds;
      }
      uint32_t dsa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          dsa[kk][t] = pack<T>(dpt[8 * kk + 2 * t], dpt[8 * kk + 2 * t + 1]);

      // dV += P^T dO (hi, then lo; fp16: p once) and dK += dS^T Q over the tile's query
      // rows in k16 steps of 16 rows (2048 bytes); the next 64 columns of
      // dO / Q are one box (Q_BOX bytes) further
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t d_do = sw128_desc(dost + kk * 16 * 128, L::Q_BOX, 1024);
        wgmma_rs_tb<D, T>(dv_acc, p_hi[kk], d_do);
        if constexpr (!is_f16<T>) wgmma_rs_tb<D, T>(dv_acc, p_lo[kk], d_do);
        wgmma_rs_tb<D, T>(dk_acc, dsa[kk], sw128_desc(qst + kk * 16 * 128, L::Q_BOX, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  store_acc<D, T>(dk + (size_t)bkv * Skv * D, dk_acc, krow, Skv, lane);
  store_acc<D, T>(dv + (size_t)bkv * Skv * D, dv_acc, krow, Skv, lane);
}

template <int D, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                   const float* delta, Masks mk, T* dk, T* dv, int B, int H, int KVH, int Sq,
                   int Skv, int causal, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  static bool smem_ok = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D, T>, L::ALLOC, smem_ok);
  if (err != cudaSuccess) return err;
  // the bulk copies of the row vectors read 16-byte aligned runs
  if (reinterpret_cast<uintptr_t>(lse) % 16 || reinterpret_cast<uintptr_t>(delta) % 16 ||
      reinterpret_cast<uintptr_t>(mk.q_seg) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  if ((err = tile_map<T>(&tq, q, D, Sq, B * H, BQ)) != cudaSuccess) return err;
  if ((err = tile_map<T>(&tdo, dout, D, Sq, B * H, BQ)) != cudaSuccess) return err;
  if ((err = tile_map<T>(&tk, k, D, Skv, B * KVH, BK)) != cudaSuccess) return err;
  if ((err = tile_map<T>(&tv, v, D, Skv, B * KVH, BK)) != cudaSuccess) return err;
  const dim3 grid((Skv + BK - 1) / BK, KVH, B);
  flash_bwd_dkv_kernel<D, T><<<grid, THREADS, L::ALLOC, stream>>>(
      tq, tdo, tk, tv, lse, delta, mk, dk, dv, H, KVH, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* kv_mask, const void* q_seg,
                 const void* kv_seg, void* dk, void* dv, int B, int H, int KVH, int Sq,
                 int Skv, int D, int causal, float scale, void* stream) {
  const Masks mk{static_cast<const int*>(kv_mask), static_cast<const int*>(q_seg),
                 static_cast<const int*>(kv_seg)};
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128, T>(qp, kp, vp, dop, lp, dp, mk, dkp, dvp, B, H, KVH, Sq, Skv,
                               causal, scale, st);
  if (D == 64)
    return (int)launch<64, T>(qp, kp, vp, dop, lp, dp, mk, dkp, dvp, B, H, KVH, Sq, Skv,
                              causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/dout [B, H, Sq, D], k/v [B, KVH, Skv, D] bf16 contiguous; lse, delta
// [B, H, Sq] fp32; kv_mask [B, Skv], q_seg [B, Sq], kv_seg [B, Skv] int32
// or null; dk/dv [B, KVH, Skv, D] bf16 written. Sq, Skv multiples of 64,
// D 64 or 128, KVH dividing H (the wrapper checks all of it). Launches on
// `stream`, allocates nothing, returns cudaGetLastError() (or the error of
// the tensor-map encoding, or cudaErrorInvalidValue for a pointer the
// bulk copies cannot read: not 16-byte aligned).
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* kv_mask, const void* q_seg,
                                    const void* kv_seg, void* dk, void* dv, int B, int H,
                                    int KVH, int Sq, int Skv, int D, int causal,
                                    float scale, void* stream) {
  return launch_typed<bf16>(q, k, v, dout, lse, delta, kv_mask, q_seg, kv_seg, dk, dv, B, H,
                            KVH, Sq, Skv, D, causal, scale, stream);
}

// The same with q, k, v, dout, dk and dv fp16.
extern "C" int flash_bwd_dkv_f16_launch(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* kv_mask, const void* q_seg,
                                        const void* kv_seg, void* dk, void* dv, int B, int H,
                                        int KVH, int Sq, int Skv, int D, int causal,
                                        float scale, void* stream) {
  return launch_typed<__half>(q, k, v, dout, lse, delta, kv_mask, q_seg, kv_seg, dk, dv, B,
                              H, KVH, Sq, Skv, D, causal, scale, stream);
}
