// The packed ragged prefill attention kernel for Hopper (sm_90a) on the
// tensor cores, shared by the 16-bit entry (ragged_prefill.cu) and the
// int8 / int4 entry (ragged_prefill_quant.cu), which differ only in how
// an arena kv tile reaches shared memory. Each is instantiated for bf16
// and for fp16 (the element type T of q, the fresh K/V, the 16-bit pages
// and out: hopper.cuh Elem<T>, its TMA type and its .bf16 / .f16
// wgmmas), as the reference's kernel keeps the model's dtype (`out_shape`
// q.dtype); scores and sums are fp32 in both. Where fp16 rounds a value
// it cannot overflow its 65504: P lies in [0, 1]; a dequantized arena or
// fresh value is payload * scale with scale = amax / qmax of a row whose
// amax is an fp16 value, so it rounds to at most amax's neighbourhood
// (fp16 turns to inf only at 65520); out is a convex combination of V
// rows.
//
// Semantics (the TPU kernel's `_prefill_kernel_body`,
// accelerate_tpu/ops/attention.py): packed row r of slot s = row_slot[r]
// at position p = row_pos[r] attends (1) its slot's live arena prefix,
// positions kvp < hist(s) with kvp <= p, through the slot's page table,
// and (2) the packed fresh rows c of the same slot with 0 <= row_pos[c] <=
// p. Pad rows (position -1) and pad blocks (slot -1) attend nothing and
// output exactly 0. The packer's contract: rows of one slot contiguous and
// position-ordered, so every fresh row a row attends lies at or before it.
//
// Design. One block owns one 64-row tile of the pack and one kv head; each
// consumer warpgroup owns one query head of the head's GQA group (64
// rows): two warpgroups for a group of 2 or more (blockIdx.z walks the
// group's pairs of heads; a warpgroup past the group's end computes on and
// stores nothing), one for a group of 1. Both warpgroups share every K/V
// tile. One more warp, the producer, issues every load.
// - A tile may hold rows of several slots (up to 8 token blocks of 8). The
//   block lists the distinct slots of its rows (segments) and walks, for
//   each, the slot's arena prefix in 64-row kv tiles and then the packed
//   fresh tiles from the slot's first row to this tile. Rows of other
//   segments are masked in those tiles: their scores are -inf, so their
//   running max, sum and accumulator do not move.
// - Loads: the producer warp runs up to STAGES jobs ahead through a ring
//   ("full": bytes and column keys landed; "empty": all consumer warps
//   done). With each job it writes the tile's column keys (the position a
//   row must reach to attend each column) into the stage, and its lanes
//   read the page table and issue the copies in parallel, one page-row run
//   a lane, so no consumer waits on a global load. Q once, by TMA
//   with the 128-byte swizzle in 64-column boxes (hopper.cuh); fresh K/V
//   tiles by TMA from the packed [KVH, CAP, D] tensors (rows past CAP read
//   as zeros). A 16-bit arena tile is one TMA box per page-row run: pages of
//   ps rows (ps a multiple of 8 dividing 64, or a multiple of 64) stack
//   into the layout one 64-row box would give, since every box starts on a
//   1024-byte swizzle atom. A quantized arena tile is staged unswizzled
//   (bulk copies of each page run's payload rows and fp32 scales), then
//   every consumer thread dequantizes its share into the swizzled T tile and
//   fences the stores for the async proxy before the tensor cores read it.
// - Products: S = Q K^T as m64n64k16 wgmmas from shared memory (K-major),
//   masks and online softmax in registers in log2 units, then O += P V with
//   P rounded to T in registers as the A operand and V MN-major (as in
//   flash_fwd.cu). Masked scores are -inf, so their p is exactly 0; a row
//   that attended nothing (l == 0) writes exactly 0.
#pragma once

#include <climits>
#include <cstring>

#include <math_constants.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace prefill {

using flash::bf16;
using flash::NEG_INF;

constexpr int TILE = 64;    // packed rows a block owns; kv rows a tile
constexpr int BOX = TILE * 128;  // bytes of one 64-column box of a tile

// How the arena's K/V reach shared memory: 16-bit pages through their TMA
// maps, or int8 payload pages [NP, KVH, ps, pd] with fp32 scale pages
// [NP, KVH, ps, 1] (bits 8: pd = D; bits 4: pd = D / 2, two values a
// byte, the even index in the low nibble).
struct QuantPages {
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  int bits;
};

// The row maps and the arena's page tables of one call.
struct Pack {
  const int* page_table;  // [S, P]
  const int* row_slot;    // [CAP]
  const int* row_pos;     // [CAP]
  const int* slot_hist;   // [S]
  int cap, kvh, ps, p_per_slot;
};

template <int D, bool QUANT>
struct Layout {
  // ring stages: as many as fit beside Q (a quantized stage also holds
  // its staged payload rows)
  static constexpr int STAGES = QUANT ? 3 : 4;
  static constexpr int BOXES = D / 64;
  static constexpr int KV_BYTES = BOXES * BOX;  // one [64, D] 16-bit tile
  static constexpr int Q_BYTES = 2 * KV_BYTES;  // two warpgroups' heads
  // quantized: K and V payload rows (at most D bytes each), then scales
  static constexpr int RAW_BYTES = QUANT ? 2 * TILE * D + 2 * TILE * 4 : 0;
  static constexpr int KEY_OFF = 2 * KV_BYTES + RAW_BYTES;  // the tile's column keys
  static constexpr int STAGE = (KEY_OFF + TILE * 4 + 1023) / 1024 * 1024;
  static constexpr int STAGE_OFF = Q_BYTES;
  static constexpr int META_OFF = STAGE_OFF + STAGES * STAGE;
  // row_slot, row_pos of the tile; seg_slot, seg_hist, seg_f0; seg_job0
  // [TILE + 1]; the segment count
  static constexpr int META_INTS = 5 * TILE + TILE + 2;
  static constexpr int BAR_OFF = (META_OFF + META_INTS * 4 + 7) / 8 * 8;
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
  static_assert(ALLOC <= 232448, "shared memory of one block");
};

// One kv tile of the walk: segment `seg`'s arena tile t (positions
// [64 t, 64 t + 64)) or its fresh packed tile t (rows [64 t, 64 t + 64)).
struct Job {
  int seg, fresh, t;
};

__device__ __forceinline__ Job job_at(int j, int nseg, const int* seg_job0,
                                      const int* seg_hist, const int* seg_f0) {
  int k = 0;
  while (k + 1 < nseg && seg_job0[k + 1] <= j) ++k;
  const int local = j - seg_job0[k];
  const int n_arena = (seg_hist[k] + TILE - 1) / TILE;
  if (local < n_arena) return {k, 0, local};
  return {k, 1, seg_f0[k] + local - n_arena};
}

// The producer warp's load of job `jb` into stage `st`, counted on `bar`
// (32 arrivals, one a lane): each lane first writes the key of columns
// lane and lane + 32 (the position a row must reach to attend the column,
// INT_MAX for a column no row of the segment attends) into the stage,
// then lane 0 announces the bytes, then the lanes issue the copies, one
// page-row run a lane, and every lane arrives, which releases its keys.
template <int D, bool QUANT>
__device__ __forceinline__ void produce(uint8_t* st, uint64_t* bar, const Job& jb, int slot,
                                        int hist, int h, int lane, const CUtensorMap* tkn,
                                        const CUtensorMap* tvn, const CUtensorMap* tkp,
                                        const CUtensorMap* tvp, const QuantPages& qp,
                                        const Pack& pk) {
  using L = Layout<D, QUANT>;
  int* keys = reinterpret_cast<int*>(st + L::KEY_OFF);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int col = lane + 32 * u;
    const int g = jb.t * TILE + col;
    int key;
    if (!jb.fresh) {
      key = g < hist ? g : INT_MAX;
    } else {
      const bool in = g < pk.cap && pk.row_slot[g] == slot;
      const int p = in ? pk.row_pos[g] : -1;
      key = p >= 0 ? p : INT_MAX;
    }
    keys[col] = key;
  }
  const int box_rows = min(pk.ps, TILE);
  const int runs = jb.fresh ? 1 : TILE / box_rows;  // copies of K (and of V), one a lane
  int page = 0, in_page = 0;
  if (!jb.fresh && lane < runs) {
    const int kvp = jb.t * TILE + lane * box_rows;
    // positions past the table (a last tile beyond the slot's capacity)
    // read its last page: they lie past hist, so they are masked
    page = pk.page_table[(size_t)slot * pk.p_per_slot + min(kvp / pk.ps, pk.p_per_slot - 1)];
    in_page = kvp % pk.ps;
  }
  const int pd = QUANT && qp.bits == 4 ? D / 2 : D;
  if (lane == 0)
    hopper::mbar_expect_tx(bar, (QUANT && !jb.fresh) ? 2 * TILE * pd + 2 * TILE * 4
                                                       : 2 * L::KV_BYTES);
  __syncwarp();
  if (lane < runs) {
    if (jb.fresh) {
#pragma unroll
      for (int c = 0; c < L::BOXES; ++c) {
        hopper::tma_load_3d(st + c * BOX, tkn, bar, 64 * c, jb.t * TILE, h);
        hopper::tma_load_3d(st + L::KV_BYTES + c * BOX, tvn, bar, 64 * c, jb.t * TILE, h);
      }
    } else if constexpr (!QUANT) {
#pragma unroll
      for (int c = 0; c < L::BOXES; ++c) {
        uint8_t* dst = st + c * BOX + lane * box_rows * 128;
        hopper::tma_load_3d(dst, tkp, bar, 64 * c, in_page, page * pk.kvh + h);
        hopper::tma_load_3d(dst + L::KV_BYTES, tvp, bar, 64 * c, in_page, page * pk.kvh + h);
      }
    } else {
      const size_t row = ((size_t)page * pk.kvh + h) * pk.ps + in_page;
      uint8_t* raw = st + 2 * L::KV_BYTES;
      float* scl = reinterpret_cast<float*>(raw + 2 * TILE * D);
      const int at = lane * box_rows;
      hopper::bulk_load(raw + at * pd, qp.k + row * pd, box_rows * pd, bar);
      hopper::bulk_load(raw + TILE * D + at * pd, qp.v + row * pd, box_rows * pd, bar);
      hopper::bulk_load(scl + at, qp.k_scale + row, box_rows * 4, bar);
      hopper::bulk_load(scl + TILE + at, qp.v_scale + row, box_rows * 4, bar);
    }
  }
  if (lane != 0) hopper::mbar_arrive(bar);
}

// Each of `threads` consumer threads' share of dequantizing a staged arena tile into the
// swizzled T K and V tiles: payload * scale in fp32, rounded once to T
// (dequantize_kv's expression, as decode::dequant_rows), 16 bytes of T a
// step; then the fence that hands the stores to the async proxy.
template <int D, typename T>
__device__ __forceinline__ void dequant_tile(uint8_t* kst, int bits, int threads) {
  constexpr int KV_BYTES = (D / 64) * BOX;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks of a 16-bit row
  const int pd = bits == 4 ? D / 2 : D;
  const uint8_t* raw = kst + 2 * KV_BYTES;
  const float* scl = reinterpret_cast<const float*>(raw + 2 * TILE * D);
  for (int e = threadIdx.x; e < 2 * TILE * CHUNKS; e += threads) {
    const int kv = e / (TILE * CHUNKS);
    const int r = (e / CHUNKS) % TILE;
    const int c = e % CHUNKS;
    const uint8_t* row = raw + kv * TILE * D + r * pd;
    const float s = scl[kv * TILE + r];
    uint32_t w[4];
    if (bits == 4) {
      const uint32_t b4 = *reinterpret_cast<const uint32_t*>(row + 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int byte = (int)((b4 >> (8 * i)) & 0xFFu);
        const int lo = (int)(int8_t)(uint8_t)(byte << 4) >> 4;  // sign-extend
        const int hi = (int)(int8_t)(uint8_t)byte >> 4;          // arithmetic
        w[i] = hopper::pack<T>((float)lo * s, (float)hi * s);
      }
    } else {
      const uint2 b8 = *reinterpret_cast<const uint2*>(row + 8 * c);
      const int8_t* v = reinterpret_cast<const int8_t*>(&b8);
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = hopper::pack<T>((float)v[2 * i] * s,
                                                         (float)v[2 * i + 1] * s);
    }
    uint8_t* dst = kst + kv * KV_BYTES + (c / 8) * BOX + r * 128 + ((c % 8) ^ (r % 8)) * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int D, bool QUANT, typename T>
__global__ void __launch_bounds__(2 * 128 + 32, 1) prefill_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tkn,
    const __grid_constant__ CUtensorMap tvn, const __grid_constant__ CUtensorMap tkp,
    const __grid_constant__ CUtensorMap tvp, QuantPages qp, Pack pk, T* __restrict__ out,
    int H, int group, float scale_log2) {
  using L = Layout<D, QUANT>;
  constexpr int STAGES = L::STAGES;
  constexpr int NO = D / 2;  // O accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  int* m_slot = reinterpret_cast<int*>(smem + L::META_OFF);
  int* m_pos = m_slot + TILE;
  int* seg_slot = m_pos + TILE;
  int* seg_hist = seg_slot + TILE;
  int* seg_f0 = seg_hist + TILE;  // the slot's first packed row, then its tile
  int* seg_job0 = seg_f0 + TILE;  // [TILE + 1]: first job of each segment
  int* n_seg = seg_job0 + TILE + 1;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int tid = threadIdx.x;
  const int consumers = blockDim.x - 32;  // the last warp is the producer
  const int nwg = consumers / 128;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int it = blockIdx.x;
  const int h = blockIdx.y;
  const int r0 = it * TILE;

  for (int r = tid; r < TILE; r += blockDim.x) {
    const int g = r0 + r;
    m_slot[r] = g < pk.cap ? pk.row_slot[g] : -1;
    m_pos[r] = g < pk.cap ? pk.row_pos[g] : -1;
  }
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], consumers / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // the tile's segments, found by warp 0: its distinct slots, each at the
  // first row of its run (rows of one slot are contiguous)
  if (tid < 32) {
    const int s_lo = m_slot[lane], s_hi = m_slot[lane + 32];
    const bool st_lo = s_lo >= 0 && (lane == 0 || m_slot[lane - 1] != s_lo);
    const bool st_hi = s_hi >= 0 && m_slot[lane + 31] != s_hi;
    const uint32_t lo = __ballot_sync(0xffffffffu, st_lo);
    const uint32_t hi = __ballot_sync(0xffffffffu, st_hi);
    const uint64_t starts = (uint64_t)hi << 32 | lo;
    const int n = __popcll(starts);
    if (lane < n) {
      // the lane-th set bit of `starts`: the first row of segment `lane`
      uint64_t rest = starts;
      for (int k = 0; k < lane; ++k) rest &= rest - 1;
      const int r = __ffsll((long long)rest) - 1;
      seg_slot[lane] = m_slot[r];
      seg_hist[lane] = pk.slot_hist[m_slot[r]];
      seg_f0[lane] = r0 + r;
    }
    if (lane == 0) *n_seg = n;
  }
  __syncthreads();
  const int nseg = *n_seg;
  // a slot's rows may begin in an earlier tile: its fresh walk starts at
  // its first row (the start of its run)
  for (int g = tid; g < r0; g += blockDim.x) {
    const int s = pk.row_slot[g];
    if (s < 0 || (g > 0 && pk.row_slot[g - 1] == s)) continue;
    for (int k = 0; k < nseg; ++k)
      if (seg_slot[k] == s) atomicMin(&seg_f0[k], g);
  }
  __syncthreads();
  if (tid == 0) {
    int j = 0;
    for (int k = 0; k < nseg; ++k) {
      seg_job0[k] = j;
      seg_f0[k] /= TILE;
      j += (seg_hist[k] + TILE - 1) / TILE + it - seg_f0[k] + 1;
    }
    seg_job0[nseg] = j;
  }
  __syncthreads();
  const int njobs = seg_job0[nseg];

  if (tid >= consumers) {
    // the producer warp: Q once, then every job's K/V through the ring
    if (njobs == 0) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(q_full, nwg * L::KV_BYTES);
      for (int w = 0; w < nwg; ++w) {
        // a head past the group's end loads a real head and stores nothing
        const int head = min(h * group + blockIdx.z * nwg + w, H - 1);
#pragma unroll
        for (int c = 0; c < L::BOXES; ++c)
          hopper::tma_load_3d(smem + w * L::KV_BYTES + c * BOX, &tq, q_full, 64 * c, r0, head);
      }
    }
    for (int j = 0; j < njobs; ++j) {
      const int s = j % STAGES;
      // the stage last held job j - STAGES: wait until every consumer warp is done with it
      if (j >= STAGES) hopper::mbar_wait(&empty[s], (j / STAGES - 1) & 1);
      const Job jb = job_at(j, nseg, seg_job0, seg_hist, seg_f0);
      produce<D, QUANT>(smem + L::STAGE_OFF + s * L::STAGE, &full[s], jb, seg_slot[jb.seg],
                        seg_hist[jb.seg], h, lane, &tkn, &tvn, &tkp, &tvp, qp, pk);
    }
    return;
  }

  // consumers: this thread's two rows of the accumulators, r and r + 8 of the tile
  const int member = blockIdx.z * nwg + wg;  // this warpgroup's head in the group
  const int rl[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};
  const int rslot[2] = {m_slot[rl[0]], m_slot[rl[1]]};
  const int rpos[2] = {m_pos[rl[0]], m_pos[rl[1]]};

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum
  const uint8_t* q_wg = smem + wg * L::KV_BYTES;
  if (njobs > 0) hopper::mbar_wait(q_full, 0);

  for (int j = 0; j < njobs; ++j) {
    const int s = j % STAGES;
    const Job jb = job_at(j, nseg, seg_job0, seg_hist, seg_f0);
    const int slot = seg_slot[jb.seg];
    uint8_t* kst = smem + L::STAGE_OFF + s * L::STAGE;
    const uint8_t* vst = kst + L::KV_BYTES;
    const int* keys = reinterpret_cast<const int*>(kst + L::KEY_OFF);
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);
    if constexpr (QUANT) {
      if (!jb.fresh) {  // uniform across the consumers
        dequant_tile<D, T>(kst, qp.bits, consumers);
        asm volatile("bar.sync 1, %0;\n" ::"r"(consumers) : "memory");
      }
    }

    // S = Q K^T over D in k16 steps: box c = kk / 4, 32 bytes a step inside it
    float sc[TILE / 2];
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) sc[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk % 4) * 32;
      const uint64_t da = hopper::sw128_desc(q_wg + (kk / 4) * BOX + off, 16, 1024);
      const uint64_t db = hopper::sw128_desc(kst + (kk / 4) * BOX + off, 16, 1024);
      hopper::wgmma_m64n64k16_ss<T>(sc, da, db, 1);
    }
    hopper::wgmma_commit();
    // while the product runs: the keys of this thread's 16 columns (column
    // q: 8 (q / 2) + 2 (lane % 4) + q % 2, register i's is q = 2 (i / 4) + i % 2)
    int key[TILE / 4];
#pragma unroll
    for (int q = 0; q < TILE / 4; ++q) key[q] = keys[8 * (q / 2) + 2 * (lane % 4) + q % 2];
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // masks: a row attends a column of this segment at or below its
    // position; rows of other segments attend nothing here
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      const int u = (i / 2) % 2;
      if (rslot[u] != slot || key[2 * (i / 4) + i % 2] > rpos[u]) sc[i] = -CUDART_INF_F;
    }

    // online softmax, per row
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float alpha[2], m_next[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      m_next[u] = fmaxf(m[u], mx[u] * scale_log2);  // NEG_INF while nothing is attended
      alpha[u] = exp2f(m[u] - m_next[u]);
      m[u] = m_next[u];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      const int u = (i / 2) % 2;
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -m_next[u]));  // masked: exp2(-inf) = 0
      sum[u] += sc[i];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) l[u] = l[u] * alpha[u] + sum[u];

    // P as T A fragments: k16 step kk is S registers 8 kk .. 8 kk + 7
    uint32_t pa[TILE / 16][4];
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        pa[kk][t] = hopper::pack<T>(sc[8 * kk + 2 * t], sc[8 * kk + 2 * t + 1]);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];

    // O += P V over the tile's rows in k16 steps of 16 rows (2048 bytes);
    // the next 64 columns of V are one box further
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      hopper::wgmma_rs_tb<D, T>(o, pa[kk],
                                hopper::sw128_desc(vst + kk * 16 * 128, BOX, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // epilogue: the quad's shares of l, then out = O / l (0 where l == 0)
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
  }
  if (member >= group) return;
  const int head = h * group + member;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = r0 + rl[u];
    if (row >= pk.cap) continue;
    const float safe_l = l[u] == 0.f ? 1.f : l[u];
    T* dst = out + ((size_t)head * pk.cap + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * u;
      *reinterpret_cast<uint32_t*>(dst + 8 * c) =
          hopper::pack<T>(o[i] / safe_l, o[i + 1] / safe_l);
    }
  }
}

// The tensor maps of q [H, CAP, D] and the fresh K/V [KVH, CAP, D], 64-row
// boxes. Page ids come from the tables; the page maps' outer extent is not
// bounded by the arena's page count (the C entry points do not take it).
constexpr int PAGE_MATS_BOUND = 1 << 24;

// Launch the attention kernel: maps built, shared memory opted into, grid
// (CAP tiles, KVH, pairs of the group's heads), one warpgroup per head.
template <int D, bool QUANT, typename T>
cudaError_t launch(const T* q, const T* k_fresh, const T* v_fresh, const T* k_pages,
                   const T* v_pages, const QuantPages& qp, const Pack& pk, T* out, int H,
                   int group, float scale, cudaStream_t stream) {
  using L = Layout<D, QUANT>;
  static bool smem_ok = false;
  cudaError_t err = flash::allow_smem(prefill_kernel<D, QUANT, T>, L::ALLOC, smem_ok);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tkn, tvn, tkp, tvp;
  memset(&tkp, 0, sizeof(tkp));
  memset(&tvp, 0, sizeof(tvp));
  if ((err = hopper::tile_map<T>(&tq, q, D, pk.cap, H, TILE)) != cudaSuccess) return err;
  if ((err = hopper::tile_map<T>(&tkn, k_fresh, D, pk.cap, pk.kvh, TILE)) != cudaSuccess)
    return err;
  if ((err = hopper::tile_map<T>(&tvn, v_fresh, D, pk.cap, pk.kvh, TILE)) != cudaSuccess)
    return err;
  if constexpr (!QUANT) {
    const int box_rows = pk.ps < TILE ? pk.ps : TILE;
    if ((err = hopper::tile_map<T>(&tkp, k_pages, D, pk.ps, PAGE_MATS_BOUND, box_rows)) !=
        cudaSuccess)
      return err;
    if ((err = hopper::tile_map<T>(&tvp, v_pages, D, pk.ps, PAGE_MATS_BOUND, box_rows)) !=
        cudaSuccess)
      return err;
  }
  const int nwg = group == 1 ? 1 : 2;
  const dim3 grid((pk.cap + TILE - 1) / TILE, pk.kvh, (group + nwg - 1) / nwg);
  prefill_kernel<D, QUANT, T><<<grid, 128 * nwg + 32, L::ALLOC, stream>>>(
      tq, tkn, tvn, tkp, tvp, qp, pk, out, H, group, scale * flash::LOG2E);
  return cudaGetLastError();
}

// The page sizes the arena walk takes: runs of 8k rows that tile 64.
inline bool page_size_ok(int ps) { return ps % 8 == 0 && (TILE % ps == 0 || ps % TILE == 0); }

}  // namespace prefill
