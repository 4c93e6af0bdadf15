// Paged decode attention for Hopper (sm_90a), int8 / int4 KV.
//
// Replaces the TPU kernel `_paged_decode_kernel_call` via
// `_paged_quant_kernel_entry` (accelerate_tpu/ops/attention.py), the
// quantized entry: decode attention read straight from a quantized page
// arena through each slot's page table, K and V each int8 payload pages
// [NP, KVH, ps, D] (int4: [NP, KVH, ps, D / 2], two values a byte) beside
// fp32 scale pages [NP, KVH, ps, 1], dequantized on the way into shared
// memory, walking the slot's live positions 0 .. max(pos[b]) with the
// mask kv position <= the query row's position. Sq is 1 for a decode
// step and K + 1 for a speculative verify step.
//
// Bound: bandwidth. Each call reads every live token's payload and scale
// once: per token and kv head (pd + 4) bytes for K and again for V (pd = D
// for int8, D / 2 for int4), 1.9x (int8) or 3.8x (int4) fewer bytes than
// the bf16 kernel at D = 128; the work is ~4 flops per attended
// bf16-equivalent value, far below the tensor cores' ridge.
//
// Design: paged_decode.cu's walk (one block per (slot b, kv head h), the
// query group x Sq folded into R = group * Sq rows, the slot's live
// tokens in 64-token chunks whose page ids come from the page table) with
// dense_decode_quant.cu's staging: each token's payload row, at
// ((page * KVH + h) * ps + off) * pd, is read with 16-byte loads,
// multiplied by its scale, at (page * KVH + h) * ps + off, in fp32 and
// rounded once to bf16 into the shared K/V tiles (attend::dequant_rows),
// dequantize_kv's rounding site. Scores, online softmax and PV are the
// bf16 kernel's. Parked slots (position 2047 on the parking page) still
// walk their whole row; skipping them is later work.
#include "attend_common.cuh"

using attend::NT;
using attend::TOK;

__global__ void __launch_bounds__(NT)
paged_decode_quant_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H, Sq, D]
                          const int8_t* __restrict__ k_pages,   // [NP, KVH, ps, pd]
                          const int8_t* __restrict__ v_pages,
                          const float* __restrict__ k_scale,    // [NP, KVH, ps, 1]
                          const float* __restrict__ v_scale,
                          const int* __restrict__ page_table,   // [B, P]
                          const int* __restrict__ pos,          // [B, Sq]
                          __nv_bfloat16* __restrict__ out,      // [B, H, Sq, D]
                          int kvh, int group, int sq, int d, int ps, int p_per_slot,
                          int bits, float scale) {
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
  __syncthreads();

  const int* table = page_table + (size_t)b * p_per_slot;
  const int n_live = maxpos + 1;  // kv positions 0 .. max(pos[b])
  for (int base = 0; base < n_live; base += TOK) {
    const int ntok = min(TOK, n_live - base);
    // (page, kv head, offset) row index of chunk token t: the scale's
    // index, and the payload's in units of pd bytes
    auto row_of = [&](int t) {
      const int kvpos = base + t;
      return ((size_t)table[kvpos / ps] * kvh + h) * ps + kvpos % ps;
    };
    attend::dequant_rows(
        sm.ks, ntok, d, bits, [&](int t) { return k_pages + row_of(t) * pd; },
        [&](int t) { return k_scale[row_of(t)]; });
    attend::dequant_rows(
        sm.vs, ntok, d, bits, [&](int t) { return v_pages + row_of(t) * pd; },
        [&](int t) { return v_scale[row_of(t)]; });
    attend::attend_staged_chunk(sm, rows, ntok, d, scale,
                                [&](int r, int t) { return base + t <= sm.rowpos[r]; });
  }
  attend::write_rows(sm, rows, d, [&](int r) { return out + q_base + (size_t)r * d; });
}

extern "C" int paged_decode_quant_launch(const void* q, const void* k_pages,
                                         const void* v_pages, const void* k_scale,
                                         const void* v_scale, const void* page_table,
                                         const void* pos, void* out, int b, int kvh,
                                         int group, int sq, int d, int ps, int p_per_slot,
                                         int bits, float scale, void* stream) {
  const size_t smem = attend::smem_bytes(group * sq, d);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, kvh);
  paged_decode_quant_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_pages, (const int8_t*)v_pages,
      (const float*)k_scale, (const float*)v_scale, (const int*)page_table,
      (const int*)pos, (__nv_bfloat16*)out, kvh, group, sq, d, ps, p_per_slot, bits,
      scale);
  return (int)cudaGetLastError();
}
