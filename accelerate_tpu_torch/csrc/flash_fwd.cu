// Flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernel `_fwd_kernel` (accelerate_tpu/ops/attention.py,
// launched by `_flash_fwd_call`): online-softmax attention of q [B, H, Sq, D]
// over k/v [B, KVH, Skv, D], query head h reading kv head h / (H / KVH),
// with optional kv_mask and segment ids; writes out [B, H, Sq, D] and the
// per-row log-sum-exp lse [B, H, Sq] fp32 that the backward kernels read.
//
// Bound: operations. At the training shape (B 8, S 2048, H 16, D 128,
// causal) the two products are ~1.4e11 flops against ~100 MB of traffic,
// far above the card's ~295 flops/byte ridge. This first version runs the
// products as fp32 FMAs on the CUDA cores (67 TFLOP/s peak, not the tensor
// cores' 989): simple and exact to the TPU kernel's arithmetic; wgmma tiles
// are a later step.
//
// Design. The TPU grid carried acc/m/l across its sequential kv axis in
// VMEM. Here one block owns one (b, h, 64-row query tile) and loops over
// the 64-row kv tiles itself, keeping m and l in registers (every thread
// of a tile row holds its row's copy) and acc in registers. Causal tiles
// wholly above the diagonal are skipped, as the TPU kernel skips them, and
// the heaviest query tiles are launched first. Rounding sites copy the TPU
// kernel's: p is rounded to bf16 before the PV product (p.astype(v.dtype)),
// l sums the unrounded p, out = acc / l in fp32 then bf16. A row with no
// attended key (l == 0) gives out = 0 and lse = NEG_INF.
//
// Shared memory (dynamic): Qt [D][BQ+PAD] | Kt [D][BK+PAD] | V [BK][D+PAD] |
// Pt [BK][BQ+PAD] (fp32) | kv_mask [BK] | kv_seg [BK] | q_seg [BQ] (int32).
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;
constexpr int BK = 64;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * ((size_t)D * (BQ + PAD) + (size_t)D * (BK + PAD) +
                          (size_t)BK * (D + PAD) + (size_t)BK * (BQ + PAD)) +
         sizeof(int) * (2 * BK + BQ);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    Masks mk, bf16* __restrict__ out, float* __restrict__ lse, int H, int KVH,
    int Sq, int Skv, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + D * (BQ + PAD);
  float* vs = kt + D * (BK + PAD);
  float* pt = vs + BK * (D + PAD);
  int* kvm = reinterpret_cast<int*>(pt + BK * (BQ + PAD));
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
  if (mk.q_seg) load_ints(qsg, mk.q_seg + (size_t)b * Sq + q0, BQ);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  int nk = Skv / BK;
  if (causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);  // tiles with k0 < q0 + BQ
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // the previous tile's readers are done
    load_rows_t<BK, D>(kt, kb + (size_t)k0 * D);
    load_rows<BK, D>(vs, vb + (size_t)k0 * D);
    if (mk.kv_mask) load_ints(kvm, mk.kv_mask + (size_t)b * Skv + k0, BK);
    if (mk.kv_seg) load_ints(kvs, mk.kv_seg + (size_t)b * Skv + k0, BK);
    __syncthreads();

    float s[4][4] = {};
    mm<4, 4, D>(s, qt, BQ + PAD, ty * 4, kt, BK + PAD, tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qs = mk.q_seg ? qsg[r] : 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tx * 4 + j;
        const bool ok = attended(causal, mk, q0 + r, k0 + t, qs,
                                 mk.kv_mask ? kvm[t] : 1, mk.kv_seg ? kvs[t] : 0);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_next = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == NEG_INF) ? 0.f : expf(s[i][j] - m_next);
        sum += p;
        pt[(tx * 4 + j) * (BQ + PAD) + r] = round_bf16(p);
      }
      sum = row_sum(sum);
      const float alpha = expf(m[i] - m_next);
      l[i] = l[i] * alpha + sum;
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mm_d<D, BK>(acc, pt, BQ + PAD, ty * 4, vs, tx * 4);
  }

  float safe_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) safe_l[i] = (l[i] == 0.f) ? 1.f : l[i];
  store_rows_d<D>(out + (bh * Sq + q0) * D, acc, ty * 4, tx * 4, safe_l);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lse[bh * Sq + q0 + ty * 4 + i] = (l[i] == 0.f) ? NEG_INF : m[i] + logf(safe_l[i]);
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, Masks mk, bf16* out,
                   float* lse, int B, int H, int KVH, int Sq, int Skv, int causal,
                   float scale, cudaStream_t stream) {
  static bool smem_ok = false;
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem, smem_ok);
  if (err != cudaSuccess) return err;
  const dim3 grid(Sq / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(q, k, v, mk, out, lse, H, KVH, Sq,
                                                   Skv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, Sq, D], k/v [B, KVH, Skv, D] bf16 contiguous; kv_mask [B, Skv],
// q_seg [B, Sq], kv_seg [B, Skv] int32 or null; out [B, H, Sq, D] bf16 and
// lse [B, H, Sq] fp32 written. Sq and Skv multiples of 64, D 64 or 128,
// KVH dividing H (the wrapper checks all of it). Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* kv_mask, const void* q_seg,
                                const void* kv_seg, void* out, void* lse, int B, int H,
                                int KVH, int Sq, int Skv, int D, int causal, float scale,
                                void* stream) {
  const Masks mk{static_cast<const int*>(kv_mask), static_cast<const int*>(q_seg),
                 static_cast<const int*>(kv_seg)};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128>(qp, kp, vp, mk, op, lp, B, H, KVH, Sq, Skv, causal, scale, st);
  if (D == 64)
    return (int)launch<64>(qp, kp, vp, mk, op, lp, B, H, KVH, Sq, Skv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
