// Dense-arena decode attention for Hopper (sm_90a), int8 / int4 KV.
//
// Replaces the TPU kernel `_dense_decode_kernel_call` via
// `_dense_quant_kernel_entry` (accelerate_tpu/ops/attention.py), the
// quantized entry: decode attention over a dense quantized cache, K and V
// each an int8 payload [B, KVH, L, D] (int4: [B, KVH, L, D / 2], two values
// a byte) plus fp32 scales [B, KVH, L, 1], dequantized on the way into
// shared memory, walking kv positions 0 .. max(pos[b]) with the mask kv
// position <= the query row's position.
//
// Bound: bandwidth. Each call reads every live token's payload and scale
// once: per token and kv head, D bytes (int8) or D / 2 bytes (int4) plus
// 4 bytes of scale, for K and for V, so 1.9x (int8) or 3.8x (int4) fewer
// bytes than the bf16 kernel at D = 128; the arithmetic stays ~4 flops per
// bf16-equivalent value, far below the tensor cores' ridge.
//
// Design: dense_decode.cu's walk (one block per (b, kv head), the query
// group x Sq folded into rows, 64-token chunks) with its own staging step:
// each chunk's payload rows are read with 16-byte loads (an int8 row of
// D = 128 is 8 of them, an int4 row 4), multiplied by the row's scale in
// fp32 and rounded once to bf16 into the same shared K/V tiles the bf16
// kernel fills (attend::dequant_rows). That is dequantize_kv's rounding
// site, so kernel and plain version score the same bf16 values; the rest
// of the chunk (scores, online softmax, PV) is shared with the bf16 kernel.
#include "attend_common.cuh"

using attend::NT;
using attend::TOK;

__global__ void __launch_bounds__(NT)
dense_decode_quant_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H, Sq, D]
                          const int8_t* __restrict__ k,         // [B, KVH, L, D or D/2]
                          const int8_t* __restrict__ v,
                          const float* __restrict__ k_scale,    // [B, KVH, L, 1]
                          const float* __restrict__ v_scale,
                          const int* __restrict__ pos,          // [B, Sq]
                          __nv_bfloat16* __restrict__ out,      // [B, H, Sq, D]
                          int kvh, int group, int sq, int length, int d, int bits,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int rows = group * sq;
  const int pd = bits == 4 ? d / 2 : d;  // payload bytes per token row
  const attend::Smem sm = attend::carve(smem_raw, rows, d);

  const size_t q_base = ((size_t)b * kvh + h) * rows * d;
  for (int e = threadIdx.x; e < rows * d; e += NT)
    sm.qs[e] = __bfloat162float(q[q_base + e]);
  int maxpos = 0;
  for (int t = 0; t < sq; ++t) maxpos = max(maxpos, pos[b * sq + t]);
  for (int r = threadIdx.x; r < rows; r += NT) sm.rowpos[r] = pos[b * sq + r % sq];
  attend::init_state(sm, rows, d);

  const size_t row0 = ((size_t)b * kvh + h) * length;  // token 0 of (b, h)
  const int n_live = min(maxpos + 1, length);
  __syncthreads();
  for (int base = 0; base < n_live; base += TOK) {
    const int ntok = min(TOK, n_live - base);
    const size_t tok0 = row0 + base;
    attend::dequant_rows(
        sm.ks, ntok, d, bits, [&](int t) { return k + (tok0 + t) * pd; },
        [&](int t) { return k_scale[tok0 + t]; });
    attend::dequant_rows(
        sm.vs, ntok, d, bits, [&](int t) { return v + (tok0 + t) * pd; },
        [&](int t) { return v_scale[tok0 + t]; });
    attend::attend_staged_chunk(sm, rows, ntok, d, scale,
                                [&](int r, int t) { return base + t <= sm.rowpos[r]; });
  }
  attend::write_rows(sm, rows, d, [&](int r) { return out + q_base + (size_t)r * d; });
}

extern "C" int dense_decode_quant_launch(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* pos, void* out, int b, int kvh,
                                         int group, int sq, int length, int d, int bits,
                                         float scale, void* stream) {
  const size_t smem = attend::smem_bytes(group * sq, d);
  cudaError_t err = cudaFuncSetAttribute(
      dense_decode_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, kvh);
  dense_decode_quant_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k, (const int8_t*)v,
      (const float*)k_scale, (const float*)v_scale, (const int*)pos,
      (__nv_bfloat16*)out, kvh, group, sq, length, d, bits, scale);
  return (int)cudaGetLastError();
}
