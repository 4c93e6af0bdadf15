// Flash-attention backward, dQ, for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernel `_dq_kernel` (accelerate_tpu/ops/attention.py,
// launched by `_flash_bwd_call`): for each query row, with p = exp(s - lse)
// (masked entries forced to exactly 0, as `_p_from_lse` does, so a fully
// masked row with lse = NEG_INF contributes nothing), dP = dO V^T,
// dS = p (dP - delta) scale, and dQ = dS K. lse and delta = rowsum(dO * O)
// come in as [B, H, Sq] fp32; delta is computed by the caller.
//
// Bound: operations. Three products per (query, key) pair (S, dP, dQ):
// ~2.1e11 flops at the training shape (B 8, S 2048, H 16, D 128, causal),
// again far above the card's ridge. As in the forward, the products are
// fp32 FMAs on the CUDA cores in this first version.
//
// Design. The TPU kernel carried dq_acc across its sequential kv grid
// axis. Here one block owns one (b, h, 64-row query tile), keeps dQ in
// registers and loops over the kv tiles itself (no atomics: the result is
// deterministic). Q and dO stay in shared memory for the whole loop; each
// kv tile is staged twice, K transposed for S and row-major for dS K.
// Rounding sites copy the TPU kernel's: dO and V enter dP unrounded (the
// kernel upcasts both to fp32), dS is rounded to bf16 (k's dtype) before
// the dS K product, dQ is accumulated in fp32 and written as bf16.
//
// Shared memory (dynamic): Qt, dOt [D][BQ+PAD] | Kt, Vt [D][BK+PAD] |
// K [BK][D+PAD] | dSt [BK][BQ+PAD] | lse, delta [BQ] (fp32) |
// kv_mask, kv_seg [BK] | q_seg [BQ] (int32).
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;
constexpr int BK = 64;

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * (size_t)D * (BQ + PAD) + 2 * (size_t)D * (BK + PAD) +
                          (size_t)BK * (D + PAD) + (size_t)BK * (BQ + PAD) + 2 * BQ) +
         sizeof(int) * (2 * BK + BQ);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, Masks mk, bf16* __restrict__ dq, int H, int KVH,
    int Sq, int Skv, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* dot = qt + D * (BQ + PAD);
  float* kt = dot + D * (BQ + PAD);
  float* vt = kt + D * (BK + PAD);
  float* ks = vt + D * (BK + PAD);
  float* dst = ks + BK * (D + PAD);
  float* lse_s = dst + BK * (BQ + PAD);
  float* delta_s = lse_s + BQ;
  int* kvm = reinterpret_cast<int*>(delta_s + BQ);
  int* kvs = kvm + BK;
  int* qsg = kvs + BK;

  const int nq = Sq / BQ;
  const int iq = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = iq * BQ;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  const size_t bh = (size_t)b * H + h;
  const bf16* kb = k + ((size_t)b * KVH + kvh) * Skv * D;
  const bf16* vb = v + ((size_t)b * KVH + kvh) * Skv * D;
  load_rows_t<BQ, D>(qt, q + (bh * Sq + q0) * D);
  load_rows_t<BQ, D>(dot, dout + (bh * Sq + q0) * D);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    lse_s[r] = lse[bh * Sq + q0 + r];
    delta_s[r] = delta[bh * Sq + q0 + r];
  }
  if (mk.q_seg) load_ints(qsg, mk.q_seg + (size_t)b * Sq + q0, BQ);

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  int nk = Skv / BK;
  if (causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();
    load_rows_t<BK, D>(kt, kb + (size_t)k0 * D);
    load_rows_t<BK, D>(vt, vb + (size_t)k0 * D);
    load_rows<BK, D>(ks, kb + (size_t)k0 * D);
    if (mk.kv_mask) load_ints(kvm, mk.kv_mask + (size_t)b * Skv + k0, BK);
    if (mk.kv_seg) load_ints(kvs, mk.kv_seg + (size_t)b * Skv + k0, BK);
    __syncthreads();

    float s[4][4] = {};
    float dp[4][4] = {};
    mm<4, 4, D>(s, qt, BQ + PAD, ty * 4, kt, BK + PAD, tx * 4);
    mm<4, 4, D>(dp, dot, BQ + PAD, ty * 4, vt, BK + PAD, tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qs = mk.q_seg ? qsg[r] : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tx * 4 + j;
        const bool ok = attended(causal, mk, q0 + r, k0 + t, qs,
                                 mk.kv_mask ? kvm[t] : 1, mk.kv_seg ? kvs[t] : 0);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[r]) * scale;
        dst[t * (BQ + PAD) + r] = round_bf16(ds);
      }
    }
    __syncthreads();
    mm_d<D, BK>(acc, dst, BQ + PAD, ty * 4, ks, tx * 4);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows_d<D>(dq + (bh * Sq + q0) * D, acc, ty * 4, tx * 4, one);
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* delta, Masks mk, bf16* dq, int B, int H,
                   int KVH, int Sq, int Skv, int causal, float scale, cudaStream_t stream) {
  static bool smem_ok = false;
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem, smem_ok);
  if (err != cudaSuccess) return err;
  const dim3 grid(Sq / BQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(q, k, v, dout, lse, delta, mk, dq,
                                                      H, KVH, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q/dout [B, H, Sq, D], k/v [B, KVH, Skv, D] bf16 contiguous; lse, delta
// [B, H, Sq] fp32; kv_mask [B, Skv], q_seg [B, Sq], kv_seg [B, Skv] int32
// or null; dq [B, H, Sq, D] bf16 written. Sq, Skv multiples of 64, D 64 or
// 128 (the wrapper checks). Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* kv_mask, const void* q_seg,
                                   const void* kv_seg, void* dq, int B, int H, int KVH,
                                   int Sq, int Skv, int D, int causal, float scale,
                                   void* stream) {
  const Masks mk{static_cast<const int*>(kv_mask), static_cast<const int*>(q_seg),
                 static_cast<const int*>(kv_seg)};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  bf16* out = static_cast<bf16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128>(qp, kp, vp, dop, lp, dp, mk, out, B, H, KVH, Sq, Skv, causal,
                            scale, st);
  if (D == 64)
    return (int)launch<64>(qp, kp, vp, dop, lp, dp, mk, out, B, H, KVH, Sq, Skv, causal,
                           scale, st);
  return (int)cudaErrorInvalidValue;
}
