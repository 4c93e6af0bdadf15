// Packed ragged prefill attention over a quantized paged KV arena for
// Hopper (sm_90a), int8 / int4 KV, with quantize-on-write fused.
//
// Replaces the TPU kernel `_ragged_prefill_kernel_call` via
// `_prefill_quant_kernel_entry` and its `_quantize_block`
// (accelerate_tpu/ops/attention.py), the quantized entry. As in the bf16
// kernel (ragged_prefill.cu), each token block of the packed tails
// attends (1) its slot's live arena prefix [0, hist), here int8 payload
// pages [NP, KVH, ps, pd] (pd = D, or D / 2 for int4) with fp32 scale
// pages [NP, KVH, ps, 1], dequantized in-register, then (2) the packed
// fresh rows of the same slot at or below its position, which are
// quantized and attended as the DEQUANTIZED values the cache serves later.
// The kernel also emits every packed row's payload [CAP, KVH, pd] int8 and
// scale [CAP, KVH, 1] fp32 for the caller's one arena scatter.
//
// Bound: the larger of the bytes (q, fresh bf16 K/V in, payload and scale
// out, the quantized prefix read once, out) over 3.35 TB/s and 4 * H * D
// flops per attended query/key pair over 989 TF/s. Short packs are bound
// by bytes, long prefixes with deep causal tails by the operations.
//
// Design: ragged_prefill.cu's structure, one block per (token block i, kv
// head h) covering R = bt * group query rows, both phases in 64-token
// chunks with fp32 scores, online softmax and PV from shared memory.
// - Arena phase: chunks staged through attend::dequant_rows (16-byte
//   payload loads, payload * scale in fp32 rounded once to bf16).
// - Fresh phase: chunks staged through attend::quant_rows, the
//   `_quantize_block` expression (IEEE division by the scale, rintf, the
//   clamp), so the tail attends qf * scale rounded to bf16, never the raw
//   k_new as the bf16 kernel does.
// - Payload and scale output: block (i, h) alone writes its own bt rows of
//   kv head h, in a first pass that every block runs, pad blocks (slot -1)
//   included: the reference quantizes every packed row and the caller
//   scatters pad rows to the parking page, so no output byte is left
//   uninitialised. Blocks that stage a fresh chunk of earlier rows
//   re-quantize it and get the same values deterministically; nothing is
//   revisited, so token blocks stay parallel (the TPU grid had to run its
//   token-block axis in order because its output windows were revisited).
// The build has no fast math: the quantize step needs div.rn and rintf,
// or payloads stop being bit-exact against the plain version.
#include "attend_common.cuh"

using attend::NT;
using attend::TOK;

__global__ void __launch_bounds__(NT)
ragged_prefill_quant_kernel(const __nv_bfloat16* __restrict__ q,      // [1, H, CAP, D]
                            const __nv_bfloat16* __restrict__ k_new,  // [1, KVH, CAP, D]
                            const __nv_bfloat16* __restrict__ v_new,
                            const int8_t* __restrict__ k_pages,       // [NP, KVH, ps, pd]
                            const int8_t* __restrict__ v_pages,
                            const float* __restrict__ k_scale,        // [NP, KVH, ps, 1]
                            const float* __restrict__ v_scale,
                            const int* __restrict__ page_table,       // [S, P]
                            const int* __restrict__ row_slot,         // [CAP]
                            const int* __restrict__ row_pos,          // [CAP]
                            const int* __restrict__ slot_hist,        // [S]
                            __nv_bfloat16* __restrict__ out,          // [1, H, CAP, D]
                            int8_t* __restrict__ k_pay,               // [CAP, KVH, pd]
                            float* __restrict__ k_scl,                // [CAP, KVH, 1]
                            int8_t* __restrict__ v_pay,
                            float* __restrict__ v_scl,
                            int kvh, int group, int cap, int d, int ps, int p_per_slot,
                            int bt, int bits, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int i = blockIdx.x;
  const int h = blockIdx.y;
  const int rows = bt * group;
  const int pd = bits == 4 ? d / 2 : d;
  const attend::Smem sm = attend::carve(smem_raw, rows, d);
  const int row0 = i * bt;
  auto row_addr = [&](auto* base, int r) {
    const int head = h * group + r % group;
    return base + ((size_t)head * cap + row0 + r / group) * d;
  };
  auto fresh_k = [&](int tok) { return k_new + ((size_t)h * cap + tok) * d; };
  auto fresh_v = [&](int tok) { return v_new + ((size_t)h * cap + tok) * d; };
  auto no_payload = [](int) -> int8_t* { return nullptr; };
  auto no_scale = [](int) -> float* { return nullptr; };

  // quantize-on-write of this block's own rows: payload + scale out
  attend::quant_rows(
      sm.ks, bt, d, bits, [&](int t) { return fresh_k(row0 + t); },
      [&](int t) { return k_pay + ((size_t)(row0 + t) * kvh + h) * pd; },
      [&](int t) { return k_scl + (size_t)(row0 + t) * kvh + h; });
  attend::quant_rows(
      sm.vs, bt, d, bits, [&](int t) { return fresh_v(row0 + t); },
      [&](int t) { return v_pay + ((size_t)(row0 + t) * kvh + h) * pd; },
      [&](int t) { return v_scl + (size_t)(row0 + t) * kvh + h; });

  const int slot = row_slot[row0];
  if (slot < 0) {
    // a whole pad block: both phases are skipped, l stays 0, output 0
    for (int e = threadIdx.x; e < rows * d; e += NT) {
      const int r = e / d;
      row_addr(out, r)[e - r * d] = __float2bfloat16(0.f);
    }
    return;
  }
  const int hist = slot_hist[slot];

  for (int e = threadIdx.x; e < rows * d; e += NT) {
    const int r = e / d;
    sm.qs[e] = __bfloat162float(row_addr(q, r)[e - r * d]);
  }
  for (int r = threadIdx.x; r < rows; r += NT) sm.rowpos[r] = row_pos[row0 + r / group];
  attend::init_state(sm, rows, d);
  __syncthreads();  // the first pass's use of the K/V tiles is over

  // arena phase: the slot's live prefix [0, hist), dequantized
  const int* table = page_table + (size_t)slot * p_per_slot;
  for (int base = 0; base < hist; base += TOK) {
    const int ntok = min(TOK, hist - base);
    auto row_of = [&](int t) {
      const int kvp = base + t;
      return ((size_t)table[kvp / ps] * kvh + h) * ps + kvp % ps;
    };
    attend::dequant_rows(
        sm.ks, ntok, d, bits, [&](int t) { return k_pages + row_of(t) * pd; },
        [&](int t) { return k_scale[row_of(t)]; });
    attend::dequant_rows(
        sm.vs, ntok, d, bits, [&](int t) { return v_pages + row_of(t) * pd; },
        [&](int t) { return v_scale[row_of(t)]; });
    attend::attend_staged_chunk(sm, rows, ntok, d, scale, [&](int r, int t) {
      const int kvp = base + t;
      return kvp < hist && kvp <= sm.rowpos[r];
    });
  }

  // fresh phase: packed blocks jf <= i of the same slot, causal by
  // position, staged quantized-then-dequantized
  const int blocks_per_chunk = TOK / bt;
  for (int jf0 = 0; jf0 <= i; jf0 += blocks_per_chunk) {
    const int nb = min(blocks_per_chunk, i + 1 - jf0);
    bool any = false;
    for (int jb = 0; jb < nb; ++jb) any |= row_slot[(jf0 + jb) * bt] == slot;
    if (!any) continue;  // uniform across the block: no divergent barrier
    const int ntok = nb * bt;
    const int tok0 = jf0 * bt;
    attend::quant_rows(sm.ks, ntok, d, bits, [&](int t) { return fresh_k(tok0 + t); },
                       no_payload, no_scale);
    attend::quant_rows(sm.vs, ntok, d, bits, [&](int t) { return fresh_v(tok0 + t); },
                       no_payload, no_scale);
    attend::attend_staged_chunk(sm, rows, ntok, d, scale, [&](int r, int t) {
      const int kvq = row_pos[tok0 + t];
      return row_slot[(tok0 + t) / bt * bt] == slot && kvq >= 0 && kvq <= sm.rowpos[r];
    });
  }
  attend::write_rows(sm, rows, d, [&](int r) { return row_addr(out, r); });
}

extern "C" int ragged_prefill_quant_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale, const void* page_table,
    const void* row_slot, const void* row_pos, const void* slot_hist, void* out,
    void* k_pay, void* k_scl, void* v_pay, void* v_scl, int kvh, int group, int cap,
    int d, int ps, int p_per_slot, int bt, int bits, float scale, void* stream) {
  const size_t smem = attend::smem_bytes(bt * group, d);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_prefill_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cap / bt, kvh);
  ragged_prefill_quant_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
      (const int8_t*)k_pages, (const int8_t*)v_pages, (const float*)k_scale,
      (const float*)v_scale, (const int*)page_table, (const int*)row_slot,
      (const int*)row_pos, (const int*)slot_hist, (__nv_bfloat16*)out, (int8_t*)k_pay,
      (float*)k_scl, (int8_t*)v_pay, (float*)v_scl, kvh, group, cap, d, ps, p_per_slot,
      bt, bits, scale);
  return (int)cudaGetLastError();
}
