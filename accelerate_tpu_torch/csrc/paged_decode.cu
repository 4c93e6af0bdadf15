// Paged decode attention for Hopper (sm_90a), bf16 KV (paged_decode_launch)
// or fp16 KV (paged_decode_f16_launch).
//
// Replaces the TPU kernel `_paged_decode_kernel_call`
// (accelerate_tpu/ops/attention.py:926) through its 16-bit entry
// `_paged_kernel_entry` (:882), in the model's dtype (bf16 or fp16; the
// output is q's dtype, :971): decode attention read straight from the
// page arena through each slot's page table, walking only the slot's live
// positions 0 .. max(pos[b]) and masking kv position <= the query row's
// position. Sq is 1 for a decode step and K + 1 for a speculative verify
// step.
//
// Bound: bytes. Each call reads every live K/V row once (2 D bytes each
// for K and V per token and kv head) and does about 4 flops per byte of
// it, far below the ~295 flops a byte at which Hopper's tensor cores
// become the limit.
//
// Design: decode_common.cuh's split kv walk (grid slot x kv head x split,
// a 3-tile cp.async ring of swizzled 64-token tiles, S = QK^T and PV on
// mma.sync.m16n8k16 with ldmatrix fragments, per-split partials merged by
// a second launch), here with the 16-bit pages copied straight into the
// ring; decode_common.cuh says why no fp16 value overflows. mma.sync and not wgmma: a wgmma takes 64 rows, and R = group x Sq
// is 2-10 rows on the serving paths, so it would waste most of each
// product in a kernel that is bound by bytes.
#include "decode_common.cuh"

namespace {

template <typename T>
int launch_paged(const void* q, const void* k_pages, const void* v_pages,
                 const void* page_table, const void* pos, void* out, void* workspace, int b,
                 int kvh, int group, int sq, int d, int ps, int p_per_slot,
                 int tiles_per_split, int n_splits, float scale, void* stream) {
  const decode::PagedRows rows{static_cast<const int*>(page_table), kvh, ps, p_per_slot,
                               nullptr, 0};
  const decode::KvRows kv{k_pages, v_pages, nullptr, nullptr, 0};
  return (int)decode::launch<false>(
      static_cast<const T*>(q), kv, rows, static_cast<const int*>(pos),
      static_cast<float*>(workspace), static_cast<T*>(out), b, kvh, group, sq, d,
      tiles_per_split, n_splits, scale, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q [B, H, Sq, D], k_pages / v_pages [NP, KVH, ps, D] (bf16, contiguous,
// 16-byte aligned); page_table [B, P], pos [B, Sq] int32; out [B, H, Sq, D]
// written; workspace B * KVH * n_splits * R * (D + 2) floats. D 64 or 128,
// R = group * Sq <= 64, ps a multiple of 8, tiles_per_split <= 32 (the
// wrapper checks all of it and picks the split plan). Launches the split
// kernel and the merge pass on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int paged_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const void* page_table, const void* pos, void* out,
                                   void* workspace, int b, int kvh, int group, int sq, int d,
                                   int ps, int p_per_slot, int tiles_per_split, int n_splits,
                                   float scale, void* stream) {
  return launch_paged<decode::bf16>(q, k_pages, v_pages, page_table, pos, out, workspace, b,
                                    kvh, group, sq, d, ps, p_per_slot, tiles_per_split,
                                    n_splits, scale, stream);
}

// The same with q, the pages and out fp16.
extern "C" int paged_decode_f16_launch(const void* q, const void* k_pages, const void* v_pages,
                                       const void* page_table, const void* pos, void* out,
                                       void* workspace, int b, int kvh, int group, int sq,
                                       int d, int ps, int p_per_slot, int tiles_per_split,
                                       int n_splits, float scale, void* stream) {
  return launch_paged<__half>(q, k_pages, v_pages, page_table, pos, out, workspace, b, kvh,
                              group, sq, d, ps, p_per_slot, tiles_per_split, n_splits, scale,
                              stream);
}
