// Dense-arena decode attention for Hopper (sm_90a), bf16 KV
// (dense_decode_launch) or fp16 KV (dense_decode_f16_launch).
//
// Replaces the TPU kernel `_dense_decode_kernel_call`
// (accelerate_tpu/ops/attention.py:977) through its 16-bit body
// `_decode_kernel_body` (:804), in the model's dtype (bf16 or fp16; the
// output is q's dtype, :1016): decode attention over a dense
// [B, KVH, L, D] cache (generate()'s single-stream cache, the flat serving
// engine's slot arena), walking each batch row's live positions
// 0 .. max(pos[b]) and masking kv position <= the query row's position.
//
// Bound: bytes. Each call reads every live K/V row once (2 D bytes each
// for K and V per token and kv head) and does about 4 flops per byte of
// it, far below the ~295 flops a byte at which Hopper's tensor cores
// become the limit.
//
// Design: decode_common.cuh's split kv walk (grid batch row x kv head x
// split, a 3-tile cp.async ring of swizzled 64-token tiles, S = QK^T and
// PV on mma.sync.m16n8k16, per-split partials merged by a second launch)
// through `DenseRows`: row (b * KVH + h) * L + p, the address clamped
// inside the (b, h) row block and every position bounded to L - 1, so a
// tile past L is masked and a row at or past L attends all L positions.
// The long rows of a batch (a parked slot at L - 1) spread over as many
// blocks as the short ones have splits, instead of one block walking the
// whole row.
#include "decode_common.cuh"

namespace {

template <typename T>
int launch_dense(const void* q, const void* k, const void* v, const void* pos, void* out,
                 void* workspace, int b, int kvh, int group, int sq, int length, int d,
                 int tiles_per_split, int n_splits, float scale, void* stream) {
  if (length < 1) return (int)cudaErrorInvalidValue;
  const decode::DenseRows rows{kvh, length, 0};
  const decode::KvRows kv{k, v, nullptr, nullptr, 0};
  return (int)decode::launch<false>(
      static_cast<const T*>(q), kv, rows, static_cast<const int*>(pos),
      static_cast<float*>(workspace), static_cast<T*>(out), b, kvh, group, sq, d,
      tiles_per_split, n_splits, scale, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q [B, H, Sq, D], k / v [B, KVH, L, D] (bf16, contiguous, 16-byte
// aligned); pos [B, Sq] int32; out [B, H, Sq, D] written; workspace
// B * KVH * n_splits * R * (D + 2) floats. D 64 or 128, R = group * Sq <=
// 64, L >= 1 (the wrapper checks all of it and picks the split plan).
// Launches the split kernel and the merge pass on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int dense_decode_launch(const void* q, const void* k, const void* v, const void* pos,
                                   void* out, void* workspace, int b, int kvh, int group, int sq,
                                   int length, int d, int tiles_per_split, int n_splits,
                                   float scale, void* stream) {
  return launch_dense<decode::bf16>(q, k, v, pos, out, workspace, b, kvh, group, sq, length, d,
                                    tiles_per_split, n_splits, scale, stream);
}

// The same with q, k, v and out fp16.
extern "C" int dense_decode_f16_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* workspace, int b,
                                       int kvh, int group, int sq, int length, int d,
                                       int tiles_per_split, int n_splits, float scale,
                                       void* stream) {
  return launch_dense<__half>(q, k, v, pos, out, workspace, b, kvh, group, sq, length, d,
                              tiles_per_split, n_splits, scale, stream);
}
