// Flash-attention backward, dQ, for Hopper (sm_90a) on the tensor cores,
// bf16 in and out (flash_bwd_dq_launch) or fp16 in and out
// (flash_bwd_dq_f16_launch: the same kernel with the element type T a
// template parameter, hopper.cuh Elem). In fp16 a dS past fp16's range
// rounds to +-inf and reaches dQ, where a loss scale's finite check sees
// it.
//
// Replaces the TPU kernel `_dq_kernel` (accelerate_tpu/ops/attention.py,
// launched by `_flash_bwd_call`): for each query row, with p = exp(s - lse)
// (masked entries exactly 0, as `_p_from_lse` does, so a fully masked row
// with lse = NEG_INF contributes nothing), dP = dO V^T,
// dS = p (dP - delta) scale, and dQ = dS K. lse and delta = rowsum(dO * O)
// come in as [B, H, Sq] fp32; delta is computed by the caller.
//
// Bound: operations. Three products per (query, key) pair (S, dP, dQ):
// ~2.1e11 flops at the training shape (B 8, S 2048, H 16, D 128, causal),
// far above the card's ~295 flops/byte ridge, and only the warpgroup
// matrix multiply (wgmma) reaches the tensor cores' 989 TFLOP/s.
//
// Design: the forward's (flash_fwd.cu) with one more product. The TPU
// kernel carried dq_acc across its sequential kv grid axis; here one block
// owns one (b, h, 128-row query tile) as two warpgroups of 64 rows, keeps
// dQ in fp32 registers and walks the kv tiles itself (no atomics: the
// result is deterministic).
// - Q and dO are loaded once by TMA (64-column boxes, 128-byte swizzle,
//   see hopper.cuh). K and V go through a ring of two stages with "full"
//   (TMA bytes landed) and "empty" (all eight warps done) barriers; thread
//   0 issues each load one tile ahead. A stage also carries the tile's
//   kv_mask and kv_seg rows, bulk-copied on the same barrier.
// - S = Q K^T and dP = dO V^T are m64n64k16 wgmmas with both operands
//   K-major in shared memory: the forward's S product, twice.
// - p = exp2(s scale log2(e) - lse log2(e)), a masked score being -inf so
//   its p is exactly 0; dS = p (dP - delta) scale is rounded to bf16 in
//   registers, where the TPU kernel rounds it (ds.astype(k.dtype)). The
//   S accumulator layout is, pair by pair, the A fragment of the next
//   wgmma, so dS needs no shuffle: dQ += dS K is m64nDk16 wgmmas with dS
//   from registers and K MN-major (the transpose bit), as V is in the
//   forward's PV product. dO and V enter dP unrounded (the TPU kernel
//   upcasts both; bf16 converts exactly).
// - The rare elements with a large p whose fp32 dS lies near a bf16
//   rounding boundary are first recomputed in the plain version's
//   summation order (ds_replay, flash_common.cuh), so that wgmma's other
//   order does not round them one bf16 ulp apart.
// - Registers: the kv tile is 64 rows, so S, dP and dQ take 32 + 32 + D/2
//   floats a thread (128 at D 128; a 128-row tile would take 192).
// - Causal: kv tiles wholly past the block's last row are not walked, a
//   warpgroup skips the products of a tile wholly past its own last row,
//   and the heaviest query tiles are launched first.
// - Ragged edges: Sq and Skv are multiples of 64. The last query tile may
//   hold 64 rows past Sq: TMA reads them as zeros, their warpgroup skips
//   its products and they are not stored. kv tiles are 64 rows, so none
//   is ragged.
//
// Shared memory (dynamic, 1024-byte aligned): Q [D/64][128][64] | dO
// [D/64][128][64] | STAGES x (K [D/64][64][64] | V [D/64][64][64] |
// kv_mask [64] | kv_seg [64], padded to 1 KB) | barriers. 130 KB at D 128,
// one block per SM.
#include <math_constants.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int BQ = 128;      // query rows per block
constexpr int BK = 64;       // kv rows per tile
constexpr int WG_ROWS = 64;  // query rows per warpgroup
constexpr int THREADS = 256;
constexpr int STAGES = 2;
constexpr int CONSUMER_WARPS = THREADS / 32;

template <int D>
struct Layout {
  static constexpr int BOXES = D / 64;          // 64-column boxes per row
  static constexpr int Q_BOX = BQ * 128;        // bytes of one Q or dO box
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BOX = BK * 128;       // bytes of one K or V box
  static constexpr int KV_BYTES = BOXES * KV_BOX;
  static constexpr int STAGE_OFF = 2 * Q_BYTES;
  static constexpr int STAGE = 2 * KV_BYTES + 1024;  // K, V, then the mask rows
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;    // room to align the base
  static_assert(2 * BK * 4 <= 1024, "mask rows of a stage");
  static_assert(STAGE % 1024 == 0 && STAGE_OFF % 1024 == 0, "swizzle atoms");
  static_assert(ALLOC <= 232448, "shared memory of one block");
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta, Masks mk,
    T* __restrict__ dq, int H, int KVH, int Sq, int Skv, int causal, float scale) {
  using L = Layout<D>;
  constexpr int NQ = D / 2;   // dQ accumulator floats a thread
  constexpr int NS = BK / 2;  // S / dP accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;
  uint8_t* dos = smem + L::Q_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int nq = (Sq + BQ - 1) / BQ;
  const int iq = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = iq * BQ;
  const int bh = b * H + h;
  const int bkv = b * KVH + kvh;
  int nk = Skv / BK;
  if (causal) nk = min(nk, (min(q0 + BQ, Sq) - 1) / BK + 1);  // tiles with k0 <= last row

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_full, 2 * L::Q_BYTES);
#pragma unroll
    for (int c = 0; c < L::BOXES; ++c) {
      tma_load_3d(qs + c * L::Q_BOX, &tq, q_full, 64 * c, q0, bh);
      tma_load_3d(dos + c * L::Q_BOX, &tdo, q_full, 64 * c, q0, bh);
    }
    load_kv_tile<L::BOXES, BK>(smem + L::STAGE_OFF, &tk, &tv, &full[0], mk, b, bkv, 0, Skv);
  }

  // this thread's two rows of the accumulators: r and r + 8 of the block,
  // with their lse (as given, and in log2 units), delta and segment id
  const int r_lo = wg * WG_ROWS + warp * 16 + lane / 4;
  const int row[2] = {q0 + r_lo, q0 + r_lo + 8};
  float lse_r[2] = {0.f, 0.f}, lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  int qseg[2] = {0, 0};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (row[u] >= Sq) continue;
    const size_t at = (size_t)bh * Sq + row[u];
    lse_r[u] = lse[at];
    lse2[u] = lse_r[u] * LOG2E;
    dlt[u] = delta[at];
    if (mk.q_seg) qseg[u] = mk.q_seg[(size_t)b * Sq + row[u]];
  }
  const int wg_row0 = q0 + wg * WG_ROWS;  // the warpgroup's first row
  const float scale_log2 = scale * LOG2E;

  float acc[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) acc[i] = 0.f;

  const uint8_t* q_wg = qs + wg * WG_ROWS * 128;
  const uint8_t* do_wg = dos + wg * WG_ROWS * 128;
  mbar_wait(q_full, 0);

  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES;
    if (tid == 0 && j + 1 < nk) {
      const int j1 = j + 1;
      if (j1 >= STAGES) mbar_wait(&empty[j1 % STAGES], (j1 / STAGES - 1) & 1);
      load_kv_tile<L::BOXES, BK>(smem + L::STAGE_OFF + (j1 % STAGES) * L::STAGE, &tk, &tv,
                                 &full[j1 % STAGES], mk, b, bkv, j1 * BK, Skv);
    }
    __syncwarp();
    mbar_wait(&full[s], (j / STAGES) & 1);
    const uint8_t* kst = smem + L::STAGE_OFF + s * L::STAGE;
    const uint8_t* vst = kst + L::KV_BYTES;
    const int* kvm = reinterpret_cast<const int*>(kst + 2 * L::KV_BYTES);
    const int* kvs = kvm + BK;
    const int k0 = j * BK;

    // a warpgroup whose rows all lie past Sq, or (causal) all before k0,
    // has nothing to add from this tile
    if (wg_row0 < Sq && !(causal && k0 > wg_row0 + WG_ROWS - 1)) {
      // S = Q K^T and dP = dO V^T over D in k16 steps: box kk / 4, 32
      // bytes a step inside it. The first step overwrites (scale_d 0):
      // zeroing the accumulators beforehand would be register writes that
      // the compiler may place after the fence, where it then has to
      // serialise the wgmmas
      float sc[NS], dp[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * L::Q_BOX + (kk % 4) * 32;
        const int koff = (kk / 4) * L::KV_BOX + (kk % 4) * 32;
        wgmma_m64n64k16_ss<T>(sc, sw128_desc(q_wg + off, 16, 1024), sw128_desc(kst + koff, 16, 1024),
                           kk > 0);
        wgmma_m64n64k16_ss<T>(dp, sw128_desc(do_wg + off, 16, 1024),
                           sw128_desc(vst + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // masks; register i is row r_lo + 8 ((i / 2) % 2), column 8 (i / 4) +
      // 2 (lane % 4) + i % 2 of the tile
      if ((causal && k0 + BK - 1 > wg_row0) || mk.kv_mask || mk.q_seg) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int u = (i / 2) % 2;
          const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (!attended(causal, mk, row[u], k0 + col, qseg[u], mk.kv_mask ? kvm[col] : 1,
                        mk.kv_seg ? kvs[col] : 0))
            sc[i] = -CUDART_INF_F;
        }
      }

      // dS in fp32, in place of dP; the large ones near a bf16 rounding
      // boundary are flagged and replayed in the plain version's order
      // (flash_common.cuh), one per lane per round
      uint32_t near = 0;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int u = (i / 2) % 2;
        const float p = exp2f(fmaf(sc[i], scale_log2, -lse2[u]));  // masked: 0
        dp[i] = p * (dp[i] - dlt[u]) * scale;
        if (replay_ds<T>(p, dp[i])) near |= 1u << i;
      }
      while (__any_sync(0xffffffffu, near)) {
        const int i = __ffs(near) - 1;  // -1: nothing left on this lane
        float ds = 0.f;
        if (i >= 0) {
          near &= near - 1;
          const bool u = (i / 2) % 2;  // a select, not an index: i is not constant here
          ds = ds_replay<D, T>(qs, dos, L::Q_BOX, r_lo + 8 * u, kst, vst, L::KV_BOX,
                            8 * (i / 4) + 2 * (lane % 4) + i % 2, u ? lse_r[1] : lse_r[0],
                            u ? dlt[1] : dlt[0], scale);
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
          if (j == i) dp[j] = ds;
      }

      // dS as T A fragments: k16 step kk is registers 8 kk .. 8 kk + 7
      uint32_t dsa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) dsa[kk][t] = pack<T>(dp[8 * kk + 2 * t], dp[8 * kk + 2 * t + 1]);

      // dQ += dS K over the tile's rows in k16 steps of 16 rows (2048
      // bytes); the next 64 columns of K are one box (KV_BOX bytes) further
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_tb<D, T>(acc, dsa[kk], sw128_desc(kst + kk * 16 * 128, L::KV_BOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  store_acc<D, T>(dq + (size_t)bh * Sq * D, acc, row, Sq, lane);
}

template <int D, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                   const float* delta, Masks mk, T* dq, int B, int H, int KVH, int Sq,
                   int Skv, int causal, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  static bool smem_ok = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, T>, L::ALLOC, smem_ok);
  if (err != cudaSuccess) return err;
  // the bulk copies of the mask rows read 16-byte aligned runs
  if (reinterpret_cast<uintptr_t>(mk.kv_mask) % 16 || reinterpret_cast<uintptr_t>(mk.kv_seg) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  if ((err = tile_map<T>(&tq, q, D, Sq, B * H, BQ)) != cudaSuccess) return err;
  if ((err = tile_map<T>(&tdo, dout, D, Sq, B * H, BQ)) != cudaSuccess) return err;
  if ((err = tile_map<T>(&tk, k, D, Skv, B * KVH, BK)) != cudaSuccess) return err;
  if ((err = tile_map<T>(&tv, v, D, Skv, B * KVH, BK)) != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D, T><<<grid, THREADS, L::ALLOC, stream>>>(
      tq, tdo, tk, tv, lse, delta, mk, dq, H, KVH, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* kv_mask, const void* q_seg,
                 const void* kv_seg, void* dq, int B, int H, int KVH, int Sq, int Skv, int D,
                 int causal, float scale, void* stream) {
  const Masks mk{static_cast<const int*>(kv_mask), static_cast<const int*>(q_seg),
                 static_cast<const int*>(kv_seg)};
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  T* out = static_cast<T*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128, T>(qp, kp, vp, dop, lp, dp, mk, out, B, H, KVH, Sq, Skv, causal,
                               scale, st);
  if (D == 64)
    return (int)launch<64, T>(qp, kp, vp, dop, lp, dp, mk, out, B, H, KVH, Sq, Skv, causal,
                              scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/dout [B, H, Sq, D], k/v [B, KVH, Skv, D] bf16 contiguous; lse, delta
// [B, H, Sq] fp32; kv_mask [B, Skv], q_seg [B, Sq], kv_seg [B, Skv] int32
// or null; dq [B, H, Sq, D] bf16 written. Sq, Skv multiples of 64, D 64 or
// 128, KVH dividing H (the wrapper checks all of it). Launches on
// `stream`, allocates nothing, returns cudaGetLastError() (or the error of
// the tensor-map encoding, or cudaErrorInvalidValue for a pointer the TMA
// cannot read: not 16-byte aligned).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* kv_mask, const void* q_seg,
                                   const void* kv_seg, void* dq, int B, int H, int KVH,
                                   int Sq, int Skv, int D, int causal, float scale,
                                   void* stream) {
  return launch_typed<bf16>(q, k, v, dout, lse, delta, kv_mask, q_seg, kv_seg, dq, B, H, KVH,
                            Sq, Skv, D, causal, scale, stream);
}

// The same with q, k, v, dout and dq fp16.
extern "C" int flash_bwd_dq_f16_launch(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* kv_mask, const void* q_seg,
                                       const void* kv_seg, void* dq, int B, int H, int KVH,
                                       int Sq, int Skv, int D, int causal, float scale,
                                       void* stream) {
  return launch_typed<__half>(q, k, v, dout, lse, delta, kv_mask, q_seg, kv_seg, dq, B, H,
                              KVH, Sq, Skv, D, causal, scale, stream);
}
