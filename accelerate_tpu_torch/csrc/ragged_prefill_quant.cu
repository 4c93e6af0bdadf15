// Packed ragged prefill attention over a quantized paged KV arena for
// Hopper (sm_90a) on the tensor cores, int8 / int4 KV, with
// quantize-on-write; q, the fresh K/V and out bf16
// (ragged_prefill_quant_launch) or fp16 (ragged_prefill_quant_f16_launch).
//
// Replaces the TPU kernel `_ragged_prefill_kernel_call` via
// `_prefill_quant_kernel_entry` and its `_quantize_block`
// (accelerate_tpu/ops/attention.py), the quantized entry: as the bf16
// entry (ragged_prefill.cu), each packed row attends its slot's arena
// prefix, here int8 payload pages [NP, KVH, ps, pd] (pd = D, or D / 2 for
// int4) with fp32 scale pages [NP, KVH, ps, 1] read dequantized, and the
// packed fresh rows of its slot at or below its position, attended as the
// DEQUANTIZED values the cache serves later. Every packed row's payload
// [CAP, KVH, pd] int8 and scale [CAP, KVH, 1] fp32 (pads included) go to
// the caller's one arena scatter.
//
// Bound: bytes at the serving path's packs (q, the fresh bf16 K/V, out,
// payload and scale out, the quantized prefix read once: ~2.1-2.4 us at
// 3.35 TB/s for a 512-row pack on small_1b), operations under a long
// arena prefix.
//
// Design: two kernels in order on the caller's stream.
// - The quantize pass quantizes each packed row of each kv head once:
//   one warp per row (attend::quant_rows, the `_quantize_block`
//   expression: IEEE division by the scale, rintf, the clamp), writing
//   the payload and scale the caller scatters and the dequantized rows
//   (qf * scale rounded once to q's type) into a [2, KVH, CAP, D]
//   workspace of that type. The
//   build has no fast math: the quantize step needs div.rn and rintf, or
//   payloads stop being bit-exact against the plain version. (The
//   CUDA-core kernel this replaces re-quantized every earlier fresh chunk
//   in every block: O(CAP^2 / 8) quantize work where O(CAP) is enough.)
// - The attention kernel (prefill_common.cuh) reads the workspace as its
//   fresh K/V by TMA; its arena tiles are staged as payload and scale
//   rows and dequantized by the block's threads into the swizzled tile of
//   q's type that the tensor cores read.
#include "attend_common.cuh"
#include "prefill_common.cuh"

namespace {

constexpr int QUANT_ROWS = attend::NWARPS;  // packed rows a quantize block takes

// Grid (ceil(CAP / QUANT_ROWS), KVH): K then V of QUANT_ROWS packed rows
// of one kv head, one warp a row; T bf16 or fp16.
template <typename T>
__global__ void __launch_bounds__(attend::NT)
quantize_pass(const T* __restrict__ k_new,  // [1, KVH, CAP, D]
              const T* __restrict__ v_new,
              int8_t* __restrict__ k_pay, float* __restrict__ k_scl,  // [CAP, KVH, pd|1]
              int8_t* __restrict__ v_pay, float* __restrict__ v_scl,
              T* __restrict__ ws,  // [2, KVH, CAP, D]: dequantized K, V
              int kvh, int cap, int d, int bits) {
  const int row0 = blockIdx.x * QUANT_ROWS;
  const int h = blockIdx.y;
  const int ntok = min(QUANT_ROWS, cap - row0);
  const int pd = bits == 4 ? d / 2 : d;
  const size_t first = (size_t)h * cap + row0;  // [KVH, CAP] row of the block's first
  const size_t plane = (size_t)kvh * cap * d;
  attend::quant_rows(
      ws + first * d, ntok, d, bits, [&](int t) { return k_new + (first + t) * d; },
      [&](int t) { return k_pay + ((size_t)(row0 + t) * kvh + h) * pd; },
      [&](int t) { return k_scl + (size_t)(row0 + t) * kvh + h; });
  attend::quant_rows(
      ws + plane + first * d, ntok, d, bits, [&](int t) { return v_new + (first + t) * d; },
      [&](int t) { return v_pay + ((size_t)(row0 + t) * kvh + h) * pd; },
      [&](int t) { return v_scl + (size_t)(row0 + t) * kvh + h; });
}

template <typename T>
int launch_ragged_quant(const void* q, const void* k_new, const void* v_new,
                        const void* k_pages, const void* v_pages, const void* k_scale,
                        const void* v_scale, const void* page_table, const void* row_slot,
                        const void* row_pos, const void* slot_hist, void* out, void* k_pay,
                        void* k_scl, void* v_pay, void* v_scl, void* ws, int kvh, int group,
                        int cap, int d, int ps, int p_per_slot, int bits, float scale,
                        void* stream) {
  if (!prefill::page_size_ok(ps) || (bits != 8 && bits != 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* wk = static_cast<T*>(ws);
  T* wv = wk + (size_t)kvh * cap * d;
  const dim3 qgrid((cap + QUANT_ROWS - 1) / QUANT_ROWS, kvh);
  quantize_pass<T><<<qgrid, attend::NT, 0, st>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<int8_t*>(k_pay), static_cast<float*>(k_scl), static_cast<int8_t*>(v_pay),
      static_cast<float*>(v_scl), wk, kvh, cap, d, bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const prefill::Pack pk{static_cast<const int*>(page_table), static_cast<const int*>(row_slot),
                         static_cast<const int*>(row_pos), static_cast<const int*>(slot_hist),
                         cap, kvh, ps, p_per_slot};
  const prefill::QuantPages qp{static_cast<const int8_t*>(k_pages),
                               static_cast<const int8_t*>(v_pages),
                               static_cast<const float*>(k_scale),
                               static_cast<const float*>(v_scale), bits};
  const T* q_ = static_cast<const T*>(q);
  T* op = static_cast<T*>(out);
  const int h = kvh * group;
  if (d == 128)
    return (int)prefill::launch<128, true, T>(q_, wk, wv, nullptr, nullptr, qp, pk, op, h,
                                              group, scale, st);
  if (d == 64)
    return (int)prefill::launch<64, true, T>(q_, wk, wv, nullptr, nullptr, qp, pk, op, h,
                                             group, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [1, H, CAP, D], k_new / v_new [1, KVH, CAP, D] bf16; payload pages
// [NP, KVH, ps, pd] int8, scale pages [NP, KVH, ps, 1] fp32; page_table
// [S, P], row_slot / row_pos [CAP], slot_hist [S] int32; out [1, H, CAP,
// D] bf16, k_pay / v_pay [CAP, KVH, pd] int8, k_scl / v_scl [CAP, KVH, 1]
// fp32 written; ws a bf16 [2, KVH, CAP, D] workspace. All contiguous and
// 16-byte aligned; D 64 or 128, ps as the bf16 entry's (the wrapper checks
// it). Launches the quantize pass and the attention kernel on `stream`,
// allocates nothing, returns the first error.
extern "C" int ragged_prefill_quant_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale, const void* page_table,
    const void* row_slot, const void* row_pos, const void* slot_hist, void* out,
    void* k_pay, void* k_scl, void* v_pay, void* v_scl, void* ws, int kvh, int group,
    int cap, int d, int ps, int p_per_slot, int bt, int bits, float scale, void* stream) {
  (void)bt;
  return launch_ragged_quant<prefill::bf16>(q, k_new, v_new, k_pages, v_pages, k_scale, v_scale,
                                            page_table, row_slot, row_pos, slot_hist, out, k_pay,
                                            k_scl, v_pay, v_scl, ws, kvh, group, cap, d, ps,
                                            p_per_slot, bits, scale, stream);
}

// The same with q, k_new, v_new, out and the workspace fp16.
extern "C" int ragged_prefill_quant_f16_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale, const void* page_table,
    const void* row_slot, const void* row_pos, const void* slot_hist, void* out,
    void* k_pay, void* k_scl, void* v_pay, void* v_scl, void* ws, int kvh, int group,
    int cap, int d, int ps, int p_per_slot, int bt, int bits, float scale, void* stream) {
  (void)bt;
  return launch_ragged_quant<__half>(q, k_new, v_new, k_pages, v_pages, k_scale, v_scale,
                                     page_table, row_slot, row_pos, slot_hist, out, k_pay, k_scl,
                                     v_pay, v_scl, ws, kvh, group, cap, d, ps, p_per_slot, bits,
                                     scale, stream);
}
