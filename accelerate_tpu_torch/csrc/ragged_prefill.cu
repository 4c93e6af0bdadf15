// Packed ragged prefill attention over the paged KV arena for Hopper
// (sm_90a) on the tensor cores, bf16 KV (ragged_prefill_launch) or fp16 KV
// (ragged_prefill_f16_launch).
//
// Replaces the TPU kernel `_ragged_prefill_kernel_call` /
// `_prefill_kernel_body` (accelerate_tpu/ops/attention.py), the 16-bit
// entry, in the model's dtype (bf16 or fp16; the output is q's dtype,
// :1540; prefill_common.cuh says why no fp16 value overflows):
// the fresh tails of several admissions are packed into one CAP-row set;
// each row attends its slot's live arena prefix [0, hist) through the
// slot's page table and the packed fresh rows of its slot at or below its
// position. Pad rows and pad blocks output exactly 0. The fresh K/V pass
// through to the caller's arena scatter untouched.
//
// Bound: bytes at the serving path's packs. A 512-row pack (small_1b: H
// 16, KVH 8, D 128) moves q, out and the fresh K/V once (6.3 MB) plus the
// arena prefix's pages once, ~2.3 us at 3.35 TB/s, against ~1 us of
// tensor-core work; a long arena prefix (1536 positions under a 512-row
// tail) turns it to operations (~7.6 us against ~3.8 us of bytes).
//
// Design (prefill_common.cuh): one block per (64-row tile of the pack, kv
// head), one consumer warpgroup per query head of the GQA group, so the
// group's heads share every K/V tile and a 512-row pack reads each kv
// head's K/V about 8 times (the CUDA-core kernel this replaces read it ~64
// times, once per 8-row token block). A producer warp keeps up to four K/V
// tiles in flight; the arena tiles come by TMA, one 128-byte-swizzled box
// per page-row run; the products are wgmma. What still bounds it above its
// bytes: 64 blocks on 132 SMs at a 512-row pack, and each block's serial
// walk of up to ~9 kv tiles (its slot's prefix, then its fresh tiles) at
// ~1.5-2 us a tile on an H100 SXM.
#include "prefill_common.cuh"

namespace {

template <typename T>
int launch_ragged(const void* q, const void* k_new, const void* v_new, const void* k_pages,
                  const void* v_pages, const void* page_table, const void* row_slot,
                  const void* row_pos, const void* slot_hist, void* out, int kvh, int group,
                  int cap, int d, int ps, int p_per_slot, float scale, void* stream) {
  if (!prefill::page_size_ok(ps)) return (int)cudaErrorInvalidValue;
  const prefill::Pack pk{static_cast<const int*>(page_table), static_cast<const int*>(row_slot),
                         static_cast<const int*>(row_pos), static_cast<const int*>(slot_hist),
                         cap, kvh, ps, p_per_slot};
  const prefill::QuantPages none{nullptr, nullptr, nullptr, nullptr, 0};
  const T* qp = static_cast<const T*>(q);
  const T* kn = static_cast<const T*>(k_new);
  const T* vn = static_cast<const T*>(v_new);
  const T* kp = static_cast<const T*>(k_pages);
  const T* vp = static_cast<const T*>(v_pages);
  T* op = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int h = kvh * group;
  if (d == 128)
    return (int)prefill::launch<128, false, T>(qp, kn, vn, kp, vp, none, pk, op, h, group,
                                               scale, st);
  if (d == 64)
    return (int)prefill::launch<64, false, T>(qp, kn, vn, kp, vp, none, pk, op, h, group,
                                              scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [1, H, CAP, D], k_new / v_new [1, KVH, CAP, D], k_pages / v_pages
// [NP, KVH, ps, D] (bf16, contiguous, 16-byte aligned); page_table [S, P],
// row_slot / row_pos [CAP], slot_hist [S] int32; out [1, H, CAP, D]
// written. D 64 or 128, ps a multiple of 8 that divides 64 or is a multiple
// of 64 (the wrapper checks all of it; `bt`, the packer's token block, is
// not needed by the kernel). Launches on `stream`, allocates nothing,
// returns cudaGetLastError() or the tensor-map encoder's error.
extern "C" int ragged_prefill_launch(const void* q, const void* k_new, const void* v_new,
                                     const void* k_pages, const void* v_pages,
                                     const void* page_table, const void* row_slot,
                                     const void* row_pos, const void* slot_hist, void* out,
                                     int kvh, int group, int cap, int d, int ps,
                                     int p_per_slot, int bt, float scale, void* stream) {
  (void)bt;
  return launch_ragged<prefill::bf16>(q, k_new, v_new, k_pages, v_pages, page_table, row_slot,
                                      row_pos, slot_hist, out, kvh, group, cap, d, ps,
                                      p_per_slot, scale, stream);
}

// The same with q, the fresh K/V, the pages and out fp16.
extern "C" int ragged_prefill_f16_launch(const void* q, const void* k_new, const void* v_new,
                                         const void* k_pages, const void* v_pages,
                                         const void* page_table, const void* row_slot,
                                         const void* row_pos, const void* slot_hist, void* out,
                                         int kvh, int group, int cap, int d, int ps,
                                         int p_per_slot, int bt, float scale, void* stream) {
  (void)bt;
  return launch_ragged<__half>(q, k_new, v_new, k_pages, v_pages, page_table, row_slot,
                               row_pos, slot_hist, out, kvh, group, cap, d, ps, p_per_slot,
                               scale, stream);
}
