// Paged decode attention for Hopper (sm_90a), int8 / int4 KV, with q and
// out bf16 (paged_decode_quant_launch) or fp16
// (paged_decode_quant_f16_launch).
//
// Replaces the TPU kernel `_paged_decode_kernel_call`
// (accelerate_tpu/ops/attention.py:926) through its quantized entry
// `_paged_quant_kernel_entry` (:889): decode attention read straight from
// a quantized page arena through each slot's page table, K and V each int8
// payload pages [NP, KVH, ps, D] (int4: [NP, KVH, ps, D / 2], two values a
// byte) beside fp32 scale pages [NP, KVH, ps, 1], dequantized on chip,
// walking the slot's live positions 0 .. max(pos[b]) with the mask kv
// position <= the query row's position.
//
// Bound: bytes. Each call reads every live token's payload and scale once:
// per token and kv head (pd + 4) bytes for K and again for V (pd = D for
// int8, D / 2 for int4), 1.9x (int8) or 3.8x (int4) fewer than the bf16
// entry at D = 128; the work is ~4 flops per bf16-equivalent value read.
//
// Design: decode_common.cuh's split kv walk and mma.sync products (see
// paged_decode.cu, and why not wgmma there), with each ring stage holding
// the tile's raw payload rows and scales (16-byte cp.async copies); each
// warp then dequantizes the rows its products read into the swizzled K/V
// tiles of q's type, payload * scale rounded once to it, which is
// dequantize_kv's rounding site (`dequantize_kv(..., q.dtype)`), so the
// kernel attends exactly the values the plain version attends.
#include "decode_common.cuh"

namespace {

template <typename T>
int launch_paged_quant(const void* q, const void* k_pages, const void* v_pages,
                       const void* k_scale, const void* v_scale, const void* page_table,
                       const void* pos, void* out, void* workspace, int b, int kvh, int group,
                       int sq, int d, int ps, int p_per_slot, int bits, int tiles_per_split,
                       int n_splits, float scale, void* stream) {
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  const decode::PagedRows rows{static_cast<const int*>(page_table), kvh, ps, p_per_slot,
                               nullptr, 0};
  const decode::KvRows kv{k_pages, v_pages, static_cast<const float*>(k_scale),
                          static_cast<const float*>(v_scale), bits};
  return (int)decode::launch<true>(
      static_cast<const T*>(q), kv, rows, static_cast<const int*>(pos),
      static_cast<float*>(workspace), static_cast<T*>(out), b, kvh, group, sq, d,
      tiles_per_split, n_splits, scale, static_cast<cudaStream_t>(stream));
}

}  // namespace

// As paged_decode_launch, with int8 payload pages and fp32 scale pages
// [NP, KVH, ps, 1] (16-byte aligned) and `bits` 8 or 4.
extern "C" int paged_decode_quant_launch(const void* q, const void* k_pages,
                                         const void* v_pages, const void* k_scale,
                                         const void* v_scale, const void* page_table,
                                         const void* pos, void* out, void* workspace, int b,
                                         int kvh, int group, int sq, int d, int ps,
                                         int p_per_slot, int bits, int tiles_per_split,
                                         int n_splits, float scale, void* stream) {
  return launch_paged_quant<decode::bf16>(q, k_pages, v_pages, k_scale, v_scale, page_table,
                                          pos, out, workspace, b, kvh, group, sq, d, ps,
                                          p_per_slot, bits, tiles_per_split, n_splits, scale,
                                          stream);
}

// The same with q and out fp16 (the pages dequantized to fp16).
extern "C" int paged_decode_quant_f16_launch(const void* q, const void* k_pages,
                                             const void* v_pages, const void* k_scale,
                                             const void* v_scale, const void* page_table,
                                             const void* pos, void* out, void* workspace, int b,
                                             int kvh, int group, int sq, int d, int ps,
                                             int p_per_slot, int bits, int tiles_per_split,
                                             int n_splits, float scale, void* stream) {
  return launch_paged_quant<__half>(q, k_pages, v_pages, k_scale, v_scale, page_table, pos,
                                    out, workspace, b, kvh, group, sq, d, ps, p_per_slot, bits,
                                    tiles_per_split, n_splits, scale, stream);
}
