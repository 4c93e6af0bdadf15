// Flash-attention backward, dK and dV, for Hopper (sm_90a), bf16 in and out.
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
// causal). The products are fp32 FMAs on the CUDA cores in this first
// version.
//
// Design. The TPU kernel carried dk_acc/dv_acc across its sequential
// grid axis. Here one block owns one (b, kv head, 64-row kv tile), keeps
// dK and dV in registers, and loops over every (group member, 32-row query
// tile) itself: no atomics, deterministic sums. K and V stay in shared
// memory for the whole loop; each query tile's q and dO are staged twice
// (transposed for S and dP, row-major for the dV and dK products). Causal
// query tiles wholly before the kv tile are skipped, and kv tile 0 (the
// longest walk) is launched first. Rounding sites copy the TPU kernel's:
// p stays fp32 in the dV product (the kernel upcasts dO, so
// p.astype(do.dtype) is fp32), dS is rounded to bf16 (q's dtype) before the
// dK product, dK and dV are accumulated in fp32 and written as bf16.
//
// Shared memory (dynamic): Kt, Vt [D][BK+PAD] | Qt, dOt [D][BQ+PAD] |
// Q, dO [BQ][D+PAD] | P, dS [BQ][BK+PAD] | lse, delta [BQ] (fp32) |
// kv_mask, kv_seg [BK] | q_seg [BQ] (int32).
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BK = 64;  // kv rows per block
constexpr int BQ = 32;  // query rows per inner tile

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * (size_t)D * (BK + PAD) + 2 * (size_t)D * (BQ + PAD) +
                          2 * (size_t)BQ * (D + PAD) + 2 * (size_t)BQ * (BK + PAD) +
                          2 * BQ) +
         sizeof(int) * (2 * BK + BQ);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, Masks mk, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int KVH, int Sq, int Skv, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);
  float* vt = kt + D * (BK + PAD);
  float* qt = vt + D * (BK + PAD);
  float* dot = qt + D * (BQ + PAD);
  float* qs = dot + D * (BQ + PAD);
  float* dos = qs + BQ * (D + PAD);
  float* ps = dos + BQ * (D + PAD);
  float* dss = ps + BQ * (BK + PAD);
  float* lse_s = dss + BQ * (BK + PAD);
  float* delta_s = lse_s + BQ;
  int* kvm = reinterpret_cast<int*>(delta_s + BQ);
  int* kvs = kvm + BK;
  int* qsg = kvs + BK;

  const int ik = blockIdx.x;  // kv tile 0 walks the most query tiles: first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KVH;
  const int k0 = ik * BK;
  const int nq = Sq / BQ;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  const size_t bkv = (size_t)b * KVH + kvh;
  load_rows_t<BK, D>(kt, k + (bkv * Skv + k0) * D);
  load_rows_t<BK, D>(vt, v + (bkv * Skv + k0) * D);
  if (mk.kv_mask) load_ints(kvm, mk.kv_mask + (size_t)b * Skv + k0, BK);
  if (mk.kv_seg) load_ints(kvs, mk.kv_seg + (size_t)b * Skv + k0, BK);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  // causal: query tile iq has a row >= k0 iff (iq + 1) * BQ > k0
  const int iq_first = causal ? k0 / BQ : 0;
  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)b * H + (size_t)kvh * group + g;
    for (int iq = iq_first; iq < nq; ++iq) {
      const int q0 = iq * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_rows_t<BQ, D>(qt, q + (bh * Sq + q0) * D);
      load_rows_t<BQ, D>(dot, dout + (bh * Sq + q0) * D);
      load_rows<BQ, D>(qs, q + (bh * Sq + q0) * D);
      load_rows<BQ, D>(dos, dout + (bh * Sq + q0) * D);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        lse_s[r] = lse[bh * Sq + q0 + r];
        delta_s[r] = delta[bh * Sq + q0 + r];
      }
      if (mk.q_seg) load_ints(qsg, mk.q_seg + (size_t)b * Sq + q0, BQ);
      __syncthreads();

      // transposed scores: rows are kv positions t, columns query rows r
      float st[4][2] = {};
      float dpt[4][2] = {};
      mm<4, 2, D>(st, kt, BK + PAD, ty * 4, qt, BQ + PAD, tx * 2);
      mm<4, 2, D>(dpt, vt, BK + PAD, ty * 4, dot, BQ + PAD, tx * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = tx * 2 + j;
          const bool ok = attended(causal, mk, q0 + r, k0 + t, mk.q_seg ? qsg[r] : 0,
                                   mk.kv_mask ? kvm[t] : 1, mk.kv_seg ? kvs[t] : 0);
          const float p = ok ? expf(st[i][j] * scale - lse_s[r]) : 0.f;
          const float ds = p * (dpt[i][j] - delta_s[r]) * scale;
          ps[r * (BK + PAD) + t] = p;
          dss[r * (BK + PAD) + t] = round_bf16(ds);
        }
      }
      __syncthreads();
      mm_d<D, BQ>(dv_acc, ps, BK + PAD, ty * 4, dos, tx * 4);
      mm_d<D, BQ>(dk_acc, dss, BK + PAD, ty * 4, qs, tx * 4);
    }
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows_d<D>(dk + (bkv * Skv + k0) * D, dk_acc, ty * 4, tx * 4, one);
  store_rows_d<D>(dv + (bkv * Skv + k0) * D, dv_acc, ty * 4, tx * 4, one);
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* delta, Masks mk, bf16* dk, bf16* dv,
                   int B, int H, int KVH, int Sq, int Skv, int causal, float scale,
                   cudaStream_t stream) {
  static bool smem_ok = false;
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, smem, smem_ok);
  if (err != cudaSuccess) return err;
  const dim3 grid(Skv / BK, KVH, B);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(q, k, v, dout, lse, delta, mk, dk,
                                                       dv, H, KVH, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q/dout [B, H, Sq, D], k/v [B, KVH, Skv, D] bf16 contiguous; lse, delta
// [B, H, Sq] fp32; kv_mask [B, Skv], q_seg [B, Sq], kv_seg [B, Skv] int32
// or null; dk/dv [B, KVH, Skv, D] bf16 written. Sq, Skv multiples of 64,
// D 64 or 128 (the wrapper checks). Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* kv_mask, const void* q_seg,
                                    const void* kv_seg, void* dk, void* dv, int B, int H,
                                    int KVH, int Sq, int Skv, int D, int causal,
                                    float scale, void* stream) {
  const Masks mk{static_cast<const int*>(kv_mask), static_cast<const int*>(q_seg),
                 static_cast<const int*>(kv_seg)};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128>(qp, kp, vp, dop, lp, dp, mk, dkp, dvp, B, H, KVH, Sq, Skv,
                            causal, scale, st);
  if (D == 64)
    return (int)launch<64>(qp, kp, vp, dop, lp, dp, mk, dkp, dvp, B, H, KVH, Sq, Skv,
                           causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
