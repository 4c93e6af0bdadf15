// Flash-attention forward for Hopper (sm_90a) on the tensor cores, bf16 in
// and out (flash_fwd_launch) or fp16 in and out (flash_fwd_f16_launch).
//
// Replaces the TPU kernel `_fwd_kernel` (accelerate_tpu/ops/attention.py,
// launched by `_flash_fwd_call`): online-softmax attention of q [B, H, Sq, D]
// over k/v [B, KVH, Skv, D], query head h reading kv head h / (H / KVH),
// with optional kv_mask and segment ids; writes out [B, H, Sq, D] and the
// per-row log-sum-exp lse [B, H, Sq] fp32 that the backward kernels read.
//
// Bound: operations. At the training shape (B 8, S 2048, H 16, KVH 8,
// D 128, causal) the two products are ~1.4e11 flops against ~100 MB of
// traffic, far above the card's ~295 flops/byte ridge, and only the
// warpgroup matrix multiply (wgmma) reaches the tensor cores' 989 TFLOP/s.
//
// Design. One block owns one (b, h, 128-row query tile) and is two
// warpgroups of 64 query rows each; both read every K/V tile of the walk.
// - Loads are TMA boxes of 64 columns with the 128-byte swizzle (see
//   hopper.cuh), so a D-128 tile is two boxes. Q is loaded once. K and V
//   go through a ring of two stages, each with a "full" barrier (TMA bytes
//   landed) and an "empty" one (all eight warps done reading). Thread 0
//   issues every load, one tile ahead of the one being computed; there is
//   no producer warp. A stage also carries the tile's kv_mask and kv_seg,
//   copied by the bulk (non-tensor) TMA on the same barrier.
// - S = Q K^T is m64n128k16 wgmmas with both operands in shared memory,
//   K-major. Scale, masks and the online softmax run on the accumulator
//   in registers; a row's max and sum reduce over the four threads of a
//   quad. The scores are kept in log2 units (scale * log2(e)), so each p
//   is one exp2.
// - O += P V is m64nDk16 wgmmas with P from registers: the fp32 S
//   accumulator of one wgmma is, pair by pair, the bf16 A fragment of the
//   next, so p is rounded in place with no shuffle. V [BK, D] is MN-major
//   for this product (the transpose bit). O is rescaled by alpha first.
// - Causal tiles wholly above the diagonal are skipped, as the TPU kernel
//   skips them, and the heaviest query tiles are launched first.
// - fp16 is the same kernel with the element type T a template parameter
//   (hopper.cuh Elem): fp16 tensor maps, `.f16` wgmmas, p packed to fp16.
// - Rounding sites copy the TPU kernel's: p is rounded to T before the
//   PV product, l sums the unrounded p, out = acc / l in fp32 then bf16. A
//   masked score is -inf inside the kernel, so its p = exp2(-inf) is
//   exactly 0; a row with no attended key (l == 0) gives out = 0 and lse =
//   NEG_INF exactly.
// - Ragged edges: Sq and Skv are multiples of 64, tiles are 128. Rows and
//   columns past the end read as zeros (TMA), columns past Skv are masked
//   and rows past Sq are not stored.
//
// Shared memory (dynamic, 1024-byte aligned): Q [D/64][128][64] | STAGES x
// (K [D/64][128][64] | V [D/64][128][64] | kv_mask [128] | kv_seg [128]) |
// barriers. 162 KB at D 128, one block per SM.
#include <math_constants.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int BQ = 128;      // query rows per block
constexpr int BK = 128;      // kv rows per tile
constexpr int WG_ROWS = 64;  // query rows per warpgroup
constexpr int THREADS = 256;
constexpr int STAGES = 2;
constexpr int CONSUMER_WARPS = THREADS / 32;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int BOXES = D / 64;          // 64-column boxes per row
  static constexpr int Q_BOX = BQ * 128;        // bytes of one Q box
  static constexpr int KV_BOX = BK * 128;       // bytes of one K or V box
  static constexpr int KV_BYTES = BOXES * KV_BOX;
  static constexpr int STAGE_OFF = BOXES * Q_BOX;
  static constexpr int STAGE = 2 * KV_BYTES + 2 * BK * 4;
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;    // room to align the base
  static_assert(STAGE % 1024 == 0 && STAGE_OFF % 1024 == 0, "swizzle atoms");
  static_assert(ALLOC <= 232448, "shared memory of one block");
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, Masks mk, T* __restrict__ out,
    float* __restrict__ lse, int H, int KVH, int Sq, int Skv, int causal, float scale_log2) {
  using L = Layout<D>;
  constexpr int NO = D / 2;  // O accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;
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
  int nk = (Skv + BK - 1) / BK;
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
    mbar_expect_tx(q_full, L::BOXES * L::Q_BOX);
#pragma unroll
    for (int c = 0; c < L::BOXES; ++c) tma_load_3d(qs + c * L::Q_BOX, &tq, q_full, 64 * c, q0, bh);
    load_kv_tile<L::BOXES, BK>(smem + L::STAGE_OFF, &tk, &tv, &full[0], mk, b, bkv, 0, Skv);
  }

  // this thread's two rows of the accumulators: r and r + 8 of the block
  const int r_lo = wg * WG_ROWS + warp * 16 + lane / 4;
  const int row[2] = {q0 + r_lo, q0 + r_lo + 8};
  int qseg[2] = {0, 0};
  if (mk.q_seg) {
#pragma unroll
    for (int u = 0; u < 2; ++u) qseg[u] = row[u] < Sq ? mk.q_seg[(size_t)b * Sq + row[u]] : 0;
  }
  const int wg_row0 = q0 + wg * WG_ROWS;  // the warpgroup's first row

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum

  const uint8_t* q_wg = qs + wg * WG_ROWS * 128;
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

    // S = Q K^T over D in k16 steps: box c = kk / 4, 32 bytes a step inside it
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk % 4) * 32;
      const uint64_t da = sw128_desc(q_wg + (kk / 4) * L::Q_BOX + off, 16, 1024);
      const uint64_t db = sw128_desc(kst + (kk / 4) * L::KV_BOX + off, 16, 1024);
      wgmma_m64n128k16_ss<T>(sc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // masks; register i is row r_lo + 8 ((i / 2) % 2), column 8 (i / 4) +
    // 2 (lane % 4) + i % 2 of the tile
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > wg_row0) || mk.kv_mask ||
                      mk.q_seg;
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int u = (i / 2) % 2;
        const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int kc = k0 + col;
        if (kc >= Skv || !attended(causal, mk, row[u], kc, qseg[u], mk.kv_mask ? kvm[col] : 1,
                                   mk.kv_seg ? kvs[col] : 0))
          sc[i] = -CUDART_INF_F;
      }
    }

    // online softmax, per row
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float alpha[2], m_next[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      m_next[u] = fmaxf(m[u], mx[u] * scale_log2);  // NEG_INF while nothing is attended
      alpha[u] = exp2f(m[u] - m_next[u]);
      m[u] = m_next[u];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int u = (i / 2) % 2;
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -m_next[u]));  // masked: exp2(-inf) = 0
      sum[u] += sc[i];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) l[u] = l[u] * alpha[u] + sum[u];

    // P as T A fragments: k16 step kk is S registers 8 kk .. 8 kk + 7
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t) pa[kk][t] = pack<T>(sc[8 * kk + 2 * t], sc[8 * kk + 2 * t + 1]);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];

    // O += P V over the tile's rows in k16 steps of 16 rows (2048 bytes);
    // the next 64 columns of V are one box (KV_BOX bytes) further
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs_tb<D, T>(o, pa[kk], sw128_desc(vst + kk * 16 * 128, L::KV_BOX, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: the quad's shares of l, then out = O / l and lse, from registers
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (row[u] >= Sq) continue;
    const float safe_l = l[u] == 0.f ? 1.f : l[u];
    T* dst = out + ((size_t)bh * Sq + row[u]) * D + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * u;
      *reinterpret_cast<uint32_t*>(dst + 8 * c) = pack<T>(o[i] / safe_l, o[i + 1] / safe_l);
    }
    if (lane % 4 == 0)
      lse[(size_t)bh * Sq + row[u]] = l[u] == 0.f ? NEG_INF : m[u] * LN2 + logf(safe_l);
  }
}

template <int D, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, Masks mk, T* out, float* lse, int B,
                   int H, int KVH, int Sq, int Skv, int causal, float scale,
                   cudaStream_t stream) {
  using L = Layout<D>;
  static bool smem_ok = false;
  cudaError_t err = allow_smem(flash_fwd_kernel<D, T>, L::ALLOC, smem_ok);
  if (err != cudaSuccess) return err;
  // the bulk copies of the mask rows read 16-byte aligned runs
  if (reinterpret_cast<uintptr_t>(mk.kv_mask) % 16 || reinterpret_cast<uintptr_t>(mk.kv_seg) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if ((err = tile_map<T>(&tq, q, D, Sq, B * H, BQ)) != cudaSuccess) return err;
  if ((err = tile_map<T>(&tk, k, D, Skv, B * KVH, BK)) != cudaSuccess) return err;
  if ((err = tile_map<T>(&tv, v, D, Skv, B * KVH, BK)) != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D, T><<<grid, THREADS, L::ALLOC, stream>>>(tq, tk, tv, mk, out, lse, H, KVH,
                                                             Sq, Skv, causal, scale * LOG2E);
  return cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* kv_mask,
                 const void* q_seg, const void* kv_seg, void* out, void* lse, int B, int H,
                 int KVH, int Sq, int Skv, int D, int causal, float scale, void* stream) {
  const Masks mk{static_cast<const int*>(kv_mask), static_cast<const int*>(q_seg),
                 static_cast<const int*>(kv_seg)};
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128, T>(qp, kp, vp, mk, op, lp, B, H, KVH, Sq, Skv, causal, scale, st);
  if (D == 64)
    return (int)launch<64, T>(qp, kp, vp, mk, op, lp, B, H, KVH, Sq, Skv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, Sq, D], k/v [B, KVH, Skv, D] bf16 contiguous; kv_mask [B, Skv],
// q_seg [B, Sq], kv_seg [B, Skv] int32 or null; out [B, H, Sq, D] bf16 and
// lse [B, H, Sq] fp32 written. Sq and Skv multiples of 64, D 64 or 128,
// KVH dividing H (the wrapper checks all of it). Launches on `stream`,
// allocates nothing, returns cudaGetLastError() (or the error of the
// tensor-map encoding, or cudaErrorInvalidValue for a pointer the TMA
// cannot read: not 16-byte aligned).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* kv_mask, const void* q_seg,
                                const void* kv_seg, void* out, void* lse, int B, int H,
                                int KVH, int Sq, int Skv, int D, int causal, float scale,
                                void* stream) {
  return launch_typed<bf16>(q, k, v, kv_mask, q_seg, kv_seg, out, lse, B, H, KVH, Sq, Skv, D,
                            causal, scale, stream);
}

// The same with q, k, v and out fp16.
extern "C" int flash_fwd_f16_launch(const void* q, const void* k, const void* v,
                                    const void* kv_mask, const void* q_seg,
                                    const void* kv_seg, void* out, void* lse, int B, int H,
                                    int KVH, int Sq, int Skv, int D, int causal, float scale,
                                    void* stream) {
  return launch_typed<__half>(q, k, v, kv_mask, q_seg, kv_seg, out, lse, B, H, KVH, Sq, Skv,
                              D, causal, scale, stream);
}
