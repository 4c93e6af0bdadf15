// Paged decode attention for Hopper (sm_90a), bf16 KV.
//
// Replaces the TPU kernel `_paged_decode_kernel_call` / `_decode_kernel_body`
// via `_paged_kernel_entry` (accelerate_tpu/ops/attention.py), the bf16
// entry: decode attention read straight from the page arena through each
// slot's page table, walking only the slot's live pages and masking
// kv position <= the query row's position.
//
// Bound: bandwidth. Each step reads every live K/V token once (2 bytes x D
// x KVH x 2 per token per layer) and does ~4 flops per byte of it, far
// below the ~295 flops/byte at which Hopper's tensor cores become the limit.
//
// Design (simple first): one block per (slot b, kv head h). The block
// folds the head's query group and the Sq query rows into R = group * Sq
// rows (row r is query head h * group + r / Sq, query token r % Sq, as
// `_fold_q_heads` lays them out) and loops over the slot's live tokens
// 0 .. max(pos[b]) in chunks of 64: each chunk's page ids come from the
// page table, its K/V rows are staged in shared memory with 16-byte loads
// (so one block keeps 32 KB in flight at D = 128), and scores, online
// softmax and the PV product run from shared memory in fp32. Only live
// pages are read, so traffic scales with live tokens, not the arena. The
// grid is B x KVH blocks; splitting the kv walk across blocks, TMA and
// wgmma are later work.
#include "attend_common.cuh"

using attend::NT;
using attend::TOK;

__global__ void __launch_bounds__(NT)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,       // [B, H, Sq, D]
                    const __nv_bfloat16* __restrict__ k_pages, // [NP, KVH, ps, D]
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ page_table,         // [B, P]
                    const int* __restrict__ pos,                // [B, Sq]
                    __nv_bfloat16* __restrict__ out,            // [B, H, Sq, D]
                    int kvh, int group, int sq, int d, int ps, int p_per_slot,
                    float scale) {
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
  __syncthreads();

  const int* table = page_table + (size_t)b * p_per_slot;
  const int n_live = maxpos + 1;  // kv positions 0 .. max(pos[b])
  for (int base = 0; base < n_live; base += TOK) {
    const int ntok = min(TOK, n_live - base);
    auto kv_addr = [&](const __nv_bfloat16* pages, int t) {
      const int kvpos = base + t;
      const int page = table[kvpos / ps];
      return pages + (((size_t)page * kvh + h) * ps + kvpos % ps) * d;
    };
    attend::load_chunk(
        sm, ntok, d, [&](int t) { return kv_addr(k_pages, t); },
        [&](int t) { return kv_addr(v_pages, t); });
    __syncthreads();
    attend::score_chunk(sm, rows, ntok, d, scale,
                        [&](int r, int t) { return base + t <= sm.rowpos[r]; });
    __syncthreads();
    attend::softmax_chunk(sm, rows, ntok);
    __syncthreads();
    attend::pv_chunk(sm, rows, ntok, d);
    __syncthreads();
  }
  attend::write_rows(sm, rows, d, [&](int r) { return out + q_base + (size_t)r * d; });
}

extern "C" int paged_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const void* page_table, const void* pos, void* out,
                                   int b, int kvh, int group, int sq, int d, int ps,
                                   int p_per_slot, float scale, void* stream) {
  const size_t smem = attend::smem_bytes(group * sq, d);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, kvh);
  paged_decode_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)page_table, (const int*)pos,
      (__nv_bfloat16*)out, kvh, group, sq, d, ps, p_per_slot, scale);
  return (int)cudaGetLastError();
}
