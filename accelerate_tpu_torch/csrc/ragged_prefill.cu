// Packed ragged prefill attention over the paged KV arena for Hopper
// (sm_90a), bf16 KV.
//
// Replaces the TPU kernel `_ragged_prefill_kernel_call` /
// `_prefill_kernel_body` (accelerate_tpu/ops/attention.py), the bf16 entry:
// the fresh tails of several admissions are packed into one CAP-row set in
// token blocks of bt rows; each token block attends (1) its slot's live
// arena prefix, pages 0 .. ceil(hist/ps)-1 under kvp < hist && kvp <= row
// position, then (2) the packed fresh blocks jf <= its own block that
// belong to the same slot, under kvq >= 0 && kvq <= row position. Masked
// probabilities are zeroed explicitly, so pad rows (position -1) and whole
// pad blocks (slot -1) output exactly 0.
//
// Bound: whichever is larger of the tensor-core work (4 * H * D flops per
// attended query/key pair) and the bytes of q, fresh K/V, the arena prefix
// read and out. For short packs the bytes set it, for long prefixes with
// deep causal tails the operations do.
//
// Design (simple first): one block per (token block i, kv head h),
// covering R = bt * group query rows (row r is packed token r / group of
// the block, query head h * group + r % group). Both phases walk their kv
// tokens in chunks of 64, staged in shared memory with 16-byte loads, with
// fp32 scores, online softmax and PV from shared memory. On the TPU the
// token-block axis had to run in order because quantize-on-write revisits
// output windows; at bf16 nothing is revisited, so all token blocks run in
// parallel. Fresh chunks with no block of the row's slot are skipped
// without loading. The fresh K/V passes through to the caller's arena
// scatter untouched. Tensor-core products (wgmma), TMA and a causal-aware
// schedule are later work.
#include "attend_common.cuh"

using attend::NT;
using attend::TOK;

__global__ void __launch_bounds__(NT)
ragged_prefill_kernel(const __nv_bfloat16* __restrict__ q,       // [1, H, CAP, D]
                      const __nv_bfloat16* __restrict__ k_new,   // [1, KVH, CAP, D]
                      const __nv_bfloat16* __restrict__ v_new,
                      const __nv_bfloat16* __restrict__ k_pages, // [NP, KVH, ps, D]
                      const __nv_bfloat16* __restrict__ v_pages,
                      const int* __restrict__ page_table,         // [S, P]
                      const int* __restrict__ row_slot,           // [CAP]
                      const int* __restrict__ row_pos,            // [CAP]
                      const int* __restrict__ slot_hist,          // [S]
                      __nv_bfloat16* __restrict__ out,            // [1, H, CAP, D]
                      int kvh, int group, int cap, int d, int ps, int p_per_slot,
                      int bt, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int i = blockIdx.x;
  const int h = blockIdx.y;
  const int rows = bt * group;
  const attend::Smem sm = attend::carve(smem_raw, rows, d);
  const int row0 = i * bt;
  auto row_addr = [&](auto* base, int r) {
    const int head = h * group + r % group;
    return base + ((size_t)head * cap + row0 + r / group) * d;
  };

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
  __syncthreads();

  // arena phase: the slot's live prefix [0, hist), through its page table
  const int* table = page_table + (size_t)slot * p_per_slot;
  for (int base = 0; base < hist; base += TOK) {
    const int ntok = min(TOK, hist - base);
    auto kv_addr = [&](const __nv_bfloat16* pages, int t) {
      const int kvp = base + t;
      const int page = table[kvp / ps];
      return pages + (((size_t)page * kvh + h) * ps + kvp % ps) * d;
    };
    attend::load_chunk(
        sm, ntok, d, [&](int t) { return kv_addr(k_pages, t); },
        [&](int t) { return kv_addr(v_pages, t); });
    __syncthreads();
    attend::score_chunk(sm, rows, ntok, d, scale, [&](int r, int t) {
      const int kvp = base + t;
      return kvp < hist && kvp <= sm.rowpos[r];
    });
    __syncthreads();
    attend::softmax_chunk(sm, rows, ntok);
    __syncthreads();
    attend::pv_chunk(sm, rows, ntok, d);
    __syncthreads();
  }

  // fresh phase: packed blocks jf <= i of the same slot, causal by position
  const int blocks_per_chunk = TOK / bt;
  for (int jf0 = 0; jf0 <= i; jf0 += blocks_per_chunk) {
    const int nb = min(blocks_per_chunk, i + 1 - jf0);
    bool any = false;
    for (int jb = 0; jb < nb; ++jb) any |= row_slot[(jf0 + jb) * bt] == slot;
    if (!any) continue;  // uniform across the block: no divergent barrier
    const int ntok = nb * bt;
    const int tok0 = jf0 * bt;
    attend::load_chunk(
        sm, ntok, d,
        [&](int t) { return k_new + ((size_t)h * cap + tok0 + t) * d; },
        [&](int t) { return v_new + ((size_t)h * cap + tok0 + t) * d; });
    __syncthreads();
    attend::score_chunk(sm, rows, ntok, d, scale, [&](int r, int t) {
      const int kvq = row_pos[tok0 + t];
      return row_slot[(tok0 + t) / bt * bt] == slot && kvq >= 0 && kvq <= sm.rowpos[r];
    });
    __syncthreads();
    attend::softmax_chunk(sm, rows, ntok);
    __syncthreads();
    attend::pv_chunk(sm, rows, ntok, d);
    __syncthreads();
  }
  attend::write_rows(sm, rows, d, [&](int r) { return row_addr(out, r); });
}

extern "C" int ragged_prefill_launch(const void* q, const void* k_new, const void* v_new,
                                     const void* k_pages, const void* v_pages,
                                     const void* page_table, const void* row_slot,
                                     const void* row_pos, const void* slot_hist, void* out,
                                     int kvh, int group, int cap, int d, int ps,
                                     int p_per_slot, int bt, float scale, void* stream) {
  const size_t smem = attend::smem_bytes(bt * group, d);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cap / bt, kvh);
  ragged_prefill_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
      (const __nv_bfloat16*)k_pages, (const __nv_bfloat16*)v_pages,
      (const int*)page_table, (const int*)row_slot, (const int*)row_pos,
      (const int*)slot_hist, (__nv_bfloat16*)out, kvh, group, cap, d, ps, p_per_slot,
      bt, scale);
  return (int)cudaGetLastError();
}
