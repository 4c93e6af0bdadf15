// Dense-arena decode attention for Hopper (sm_90a), bf16 KV.
//
// Replaces the TPU kernel `_dense_decode_kernel_call` / `_decode_kernel_body`
// (accelerate_tpu/ops/attention.py), the bf16 entry: decode attention over
// a dense [B, KVH, L, D] cache (generate()'s single-stream cache, the flat
// serving engine's slot arena), walking each batch row's kv positions
// 0 .. max(pos[b]) and masking kv position <= the query row's position.
//
// Bound: bandwidth. Each call reads every live K/V token once (live tokens
// x KVH x D x 2 bytes x 2 tensors per layer) and does ~4 flops per byte of
// it, far below the ~295 flops/byte at which Hopper's tensor cores become
// the limit.
//
// Design (simple first): the paged decode kernel's structure with an
// address function in place of the page-table walk. One block per (batch
// row b, kv head h) folds the head's query group and the Sq query rows
// into R = group * Sq rows (row r is query head h * group + r / Sq, query
// token r % Sq, as `_fold_q_heads` lays them out) and loops over kv
// positions 0 .. max(pos[b]) in chunks of 64 tokens, token t's row at
// ((b * KVH + h) * L + t) * D. Each chunk is staged in shared memory with
// 16-byte loads; scores, online softmax and the PV product run from shared
// memory in fp32 (attend_common.cuh). Only live positions are read, so
// traffic scales with live tokens, not with L. A parked slot (position
// L - 1) walks its whole row. The grid is B x KVH blocks; splitting the kv
// walk across blocks, TMA and wgmma are later work.
#include "attend_common.cuh"

using attend::NT;
using attend::TOK;

__global__ void __launch_bounds__(NT)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H, Sq, D]
                    const __nv_bfloat16* __restrict__ k,  // [B, KVH, L, D]
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ pos,          // [B, Sq]
                    __nv_bfloat16* __restrict__ out,      // [B, H, Sq, D]
                    int kvh, int group, int sq, int length, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int rows = group * sq;
  const attend::Smem sm = attend::carve(smem_raw, rows, d);

  // query rows of this kv head: contiguous in [B, H, Sq, D]
  const size_t q_base = ((size_t)b * kvh + h) * rows * d;
  for (int e = threadIdx.x; e < rows * d; e += NT)
    sm.qs[e] = __bfloat162float(q[q_base + e]);
  int maxpos = 0;
  for (int t = 0; t < sq; ++t) maxpos = max(maxpos, pos[b * sq + t]);
  for (int r = threadIdx.x; r < rows; r += NT) sm.rowpos[r] = pos[b * sq + r % sq];
  attend::init_state(sm, rows, d);

  const size_t row0 = ((size_t)b * kvh + h) * length;  // token 0 of (b, h)
  const int n_live = min(maxpos + 1, length);          // kv positions 0 .. max(pos[b])
  __syncthreads();
  for (int base = 0; base < n_live; base += TOK) {
    const int ntok = min(TOK, n_live - base);
    attend::load_chunk(
        sm, ntok, d, [&](int t) { return k + (row0 + base + t) * d; },
        [&](int t) { return v + (row0 + base + t) * d; });
    attend::attend_staged_chunk(sm, rows, ntok, d, scale,
                                [&](int r, int t) { return base + t <= sm.rowpos[r]; });
  }
  attend::write_rows(sm, rows, d, [&](int r) { return out + q_base + (size_t)r * d; });
}

extern "C" int dense_decode_launch(const void* q, const void* k, const void* v,
                                   const void* pos, void* out, int b, int kvh, int group,
                                   int sq, int length, int d, float scale, void* stream) {
  const size_t smem = attend::smem_bytes(group * sq, d);
  cudaError_t err = cudaFuncSetAttribute(
      dense_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, kvh);
  dense_decode_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int*)pos, (__nv_bfloat16*)out, kvh, group, sq, length, d, scale);
  return (int)cudaGetLastError();
}
