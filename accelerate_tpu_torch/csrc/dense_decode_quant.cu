// Dense-arena decode attention for Hopper (sm_90a), int8 / int4 KV, with q
// and out bf16 (dense_decode_quant_launch) or fp16
// (dense_decode_quant_f16_launch).
//
// Replaces the TPU kernel `_dense_decode_kernel_call`
// (accelerate_tpu/ops/attention.py:977) through its quantized entry
// `_dense_quant_kernel_entry` (:898): decode attention over a dense
// quantized cache, K and V each an int8 payload [B, KVH, L, D] (int4:
// [B, KVH, L, D / 2], two values a byte) beside fp32 scales
// [B, KVH, L, 1], dequantized on chip, walking each batch row's live
// positions 0 .. max(pos[b]) with the mask kv position <= the query row's
// position.
//
// Bound: bytes. Each call reads every live token's payload and scale once:
// per token and kv head (pd + 4) bytes for K and again for V (pd = D for
// int8, D / 2 for int4), 1.9x (int8) or 3.8x (int4) fewer than the bf16
// entry at D = 128; the work is ~4 flops per bf16-equivalent value read.
//
// Design: decode_common.cuh's split kv walk and mma.sync products through
// `DenseRows` (see dense_decode.cu), with each ring stage holding the
// tile's raw payload rows (16-byte cp.async copies) and scales (4-byte
// copies, one a position: L need not be a multiple of 4); each warp then
// dequantizes the rows its products read into the swizzled K/V tiles of
// q's type, payload * scale rounded once to it, which is dequantize_kv's
// rounding site, so the kernel attends exactly the values the plain
// version attends.
#include "decode_common.cuh"

namespace {

template <typename T>
int launch_dense_quant(const void* q, const void* k, const void* v, const void* k_scale,
                       const void* v_scale, const void* pos, void* out, void* workspace, int b,
                       int kvh, int group, int sq, int length, int d, int bits,
                       int tiles_per_split, int n_splits, float scale, void* stream) {
  if (length < 1 || (bits != 8 && bits != 4)) return (int)cudaErrorInvalidValue;
  const decode::DenseRows rows{kvh, length, 0};
  const decode::KvRows kv{k, v, static_cast<const float*>(k_scale),
                          static_cast<const float*>(v_scale), bits};
  return (int)decode::launch<true>(
      static_cast<const T*>(q), kv, rows, static_cast<const int*>(pos),
      static_cast<float*>(workspace), static_cast<T*>(out), b, kvh, group, sq, d,
      tiles_per_split, n_splits, scale, static_cast<cudaStream_t>(stream));
}

}  // namespace

// As dense_decode_launch, with int8 payloads [B, KVH, L, D or D / 2]
// (16-byte aligned), fp32 scales [B, KVH, L, 1] and `bits` 8 or 4.
extern "C" int dense_decode_quant_launch(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* pos, void* out, void* workspace, int b,
                                         int kvh, int group, int sq, int length, int d, int bits,
                                         int tiles_per_split, int n_splits, float scale,
                                         void* stream) {
  return launch_dense_quant<decode::bf16>(q, k, v, k_scale, v_scale, pos, out, workspace, b,
                                          kvh, group, sq, length, d, bits, tiles_per_split,
                                          n_splits, scale, stream);
}

// The same with q and out fp16 (the payloads dequantized to fp16).
extern "C" int dense_decode_quant_f16_launch(const void* q, const void* k, const void* v,
                                             const void* k_scale, const void* v_scale,
                                             const void* pos, void* out, void* workspace, int b,
                                             int kvh, int group, int sq, int length, int d,
                                             int bits, int tiles_per_split, int n_splits,
                                             float scale, void* stream) {
  return launch_dense_quant<__half>(q, k, v, k_scale, v_scale, pos, out, workspace, b, kvh,
                                    group, sq, length, d, bits, tiles_per_split, n_splits,
                                    scale, stream);
}
