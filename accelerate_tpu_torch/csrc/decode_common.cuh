// The decode attention kernel for Hopper (sm_90a): a split kv walk with a
// merge pass, shared by the paged decode kernel's bf16 entry
// (paged_decode.cu) and its int8 / int4 entry (paged_decode_quant.cu), and
// by the dense decode kernel's two entries (dense_decode.cu,
// dense_decode_quant.cu). They replace the TPU kernels
// `_paged_decode_kernel_call` (accelerate_tpu/ops/attention.py:926)
// through `_paged_kernel_entry` (:882) and `_paged_quant_kernel_entry`
// (:889), and `_dense_decode_kernel_call` (:977) through
// `_dense_quant_kernel_entry` (:898); the body of all four is
// `_decode_kernel_body` (:804).
//
// Semantics. Slot b's query rows attend its kv positions kvp <= the row's
// position; q [B, H, Sq, D] folds each kv head's query group and the Sq
// rows into R = group * Sq rows (row r: query head h * group + r / Sq,
// query token r % Sq, as the reference's `_fold_q_heads`). The output is
// sum_kvp p v / sum_kvp p with p = exp(s - max s) rounded to the element
// type before the PV product, as the reference's `p.astype(v.dtype)`.
//
// Element types. q, the K/V rows (or the dequantized tiles) and out are
// bf16 or fp16, a template parameter T of every kernel below (hopper.cuh
// Elem<T>): each entry point has a bf16 and an fp16 instantiation, as the
// reference's kernels keep the model's dtype (`out_shape` q.dtype). Both
// types are 2 bytes, so the ring, the swizzle and the ldmatrix fragments
// are the same; the products are mma.sync's .bf16 or .f16 form, scores,
// sums and the merge are fp32 in both. Where fp16 rounds a value, it
// cannot overflow its 65504: p = 2^(s - m) with m the running max lies in
// [0, 1]; a dequantized K/V value is payload * scale with |payload| <=
// qmax and scale = amax / qmax of a row whose amax was an fp16 value, so
// it is at most amax to a rounding and rounds to at most 65504 (fp16
// turns to inf only at 65520); the output is a convex combination of V
// rows, at most max |v|.
//
// Bound: bytes. A call reads every live K/V row once (bf16: 2 D bytes a
// row; int8: D + 4; int4: D / 2 + 4, payload and scale) and does 4 D flops
// per (query row, kv row) pair: about 4 flops per byte read at Sq 1 with a
// GQA group of 2, against the ~295 at which Hopper's tensor cores become
// the limit. What matters is how many bytes are in flight at once.
//
// Design.
// - Split kv walk (flash-decoding). The grid is (slot, kv head, split); a
//   split is a run of `tiles_per_split` whole 64-token tiles, which the
//   wrapper picks from the shapes and the SM count so that the live
//   blocks fill the card several times over. A split past the slot's
//   max(pos) returns at once. Each live split writes its partial to an
//   fp32 workspace the wrapper allocates: per row the running max m (in
//   log2 units, -inf where the row attended nothing in the split), the
//   sum l and the unnormalised accumulator [R, D]. A second launch, the
//   merge pass, combines them: out = sum_i acc_i 2^(m_i - M) / sum_i l_i
//   2^(m_i - M), M = max_i m_i, rounded once to T. A partial with m_i =
//   -inf weighs exactly 0; every row attends position 0, so M is finite.
// - Loads in flight. A ring of STAGES 64-token tiles per block, filled by
//   16-byte cp.async copies (commit / wait groups): while the warps work
//   on tile j, tiles j + 1 and j + 2 are on their way. The split's page
//   ids are staged once at the block's start (`Rows::begin`, one 4-byte
//   cp.async a lane, in parallel), so no copy waits on a page-table read.
//   Rows are XOR-swizzled at 16-byte granularity (chunk c of row t at
//   chunk c ^ (t % 8)), so ldmatrix reads them without bank conflicts.
//   The quantized entry stages payload rows and scales raw; each warp then
//   dequantizes the rows its products read into the swizzled T tile,
//   payload * scale rounded once to T (dequantize_kv's rounding site, to
//   q's dtype), and syncs with itself (__syncwarp) before its products.
// - Products on the tensor cores with mma.sync.m16n8k16 (bf16 or fp16
//   in, fp32 sums). The R rows, padded to 16 a row tile (RT tiles, 1, 2 or 4), are
//   the A operand of S = Q K^T (Q fragments held in registers), K
//   fragments come through ldmatrix, V fragments through ldmatrix.trans.
//   The block's 4 warps split each tile: warp w takes row tile w / TS and
//   the w % TS-th of the tile's TS = 4 / RT token slices, and keeps its
//   own online softmax (masks kvp > row position as -inf, quad shuffles
//   for the row max and sum) over its slices of every tile of the split;
//   at the end the block merges its warps' states in shared memory and
//   writes the split's partial.
// - Why not wgmma. A wgmma takes 64 rows; at R = 2 (Sq 1) or 10 (Sq 5) it
//   would waste 84-97% of each product. The kernel is bound by bytes, and
//   mma.sync at 16 rows does a tile's products in a small fraction of the
//   tile's load time, which is all it needs from the tensor cores.
//
// Addressing. Where kv row (slot b, kv head h, position p) lives is a
// template parameter `Rows`: `begin` stages what a split needs, `row`
// gives the row's index into the [rows, width] payload (and the [rows]
// scales), `pos_limit` the last position the arena holds (a row whose
// position lies past it attends every position up to it), and SCALE_RUN
// how many consecutive positions' scales one copy moves. `PagedRows`
// reads the slot's page table; `DenseRows` addresses a [B, KVH, L] arena.
#pragma once

#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace decode {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;     // kv tokens a tile
constexpr int NT = 128;      // threads a block: 4 warps
constexpr int STAGES = 3;    // ring depth, in tiles
constexpr int MAX_IDS = 264; // page ids a split stages: tiles_per_split * 64 / ps + 2
constexpr int MAX_ROWS = 64; // R = group * Sq, four 16-row tiles
constexpr float LOG2E = 1.4426950408889634f;

// ---- PTX --------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p))
               : "memory");
}

// D[16 x 8] += A[16 x 16] B[16 x 8], T (bf16 or fp16) in, fp32 sums.
// Thread t (g = t / 4, c = t % 4) holds A rows g and g + 8 at k 2c, 2c + 1
// (a0, a1) and 2c + 8, 2c + 9 (a2, a3); B at k 2c.. (b0) and 2c + 8..
// (b1), column g; D rows g (d0, d1) and g + 8 (d2, d3) at columns 2c,
// 2c + 1.
#define DECODE_MMA_M16N8K16(TY)                                                    \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "           \
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n" \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))

template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (hopper::is_f16<T>) {
    DECODE_MMA_M16N8K16("f16");
  } else {
    DECODE_MMA_M16N8K16("bf16");
  }
}

// one float rounded to T (to nearest even)
template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (hopper::is_f16<T>) {
    return __float2half_rn(x);
  } else {
    return __float2bfloat16_rn(x);
  }
}

// byte offset of 16-byte chunk c of row t in a swizzled tile of D 16-bit columns
template <int D>
__device__ __forceinline__ int swz(int t, int c) {
  return t * (D * 2) + ((c ^ (t & 7)) << 4);
}

// ---- addressing ---------------------------------------------------------

// The paged arena: position p of slot b is row ((page * KVH + h) * ps + p %
// ps) with page = table[b][p / ps]. `begin` stages the page ids of the
// split's positions [pos0, pos0 + npos) into `ids` (4-byte cp.async, one a
// thread, in the caller's commit group). Positions past the table (a last
// tile beyond the slot's reservation) read its last page: they lie past
// every row's position, so they are masked.
struct PagedRows {
  // scales of 4 positions per 16-byte copy: they lie on one page (ps is a
  // multiple of 8) and 16-byte aligned
  static constexpr int SCALE_RUN = 4;
  const int* table;  // [B, P]
  int kvh, ps, p_per_slot;
  const int* ids;
  int first;

  __device__ __forceinline__ void begin(int* smem_ids, int b, int pos0, int npos) {
    first = min(pos0 / ps, p_per_slot - 1);
    const int last = min((pos0 + npos - 1) / ps, p_per_slot - 1);
    const int* src = table + (size_t)b * p_per_slot;
    for (int i = threadIdx.x; i <= last - first; i += NT) cp_async4(smem_ids + i, src + first + i);
    ids = smem_ids;
  }

  __device__ __forceinline__ size_t row(int h, int p) const {
    const int page = ids[min(p / ps, p_per_slot - 1) - first];
    return ((size_t)page * kvh + h) * ps + p % ps;
  }

  // positions are not bounded: a slot's reservation covers its positions
  __host__ __device__ __forceinline__ int pos_limit() const { return INT_MAX; }
};

// The dense arena [B, KVH, L, width]: position p of batch row b is row
// (b * KVH + h) * L + p. A tile that runs past L reads row L - 1 again
// (the address is clamped inside the (b, h) row block), and `pos_limit`
// bounds every row's position to L - 1, so those positions are masked: a
// row whose position is L or more attends positions 0 .. L - 1 once each,
// as the plain version does. Scales are copied one position at a time (4
// bytes): a 16-byte run of 4 is aligned and inside the row block only
// when L is a multiple of 4.
struct DenseRows {
  static constexpr int SCALE_RUN = 1;
  int kvh, length;
  int b;

  __device__ __forceinline__ void begin(int*, int slot, int, int) { b = slot; }

  __device__ __forceinline__ size_t row(int h, int p) const {
    return ((size_t)b * kvh + h) * length + min(p, length - 1);
  }

  __host__ __device__ __forceinline__ int pos_limit() const { return length - 1; }
};

// What the kv rows hold: T (bf16 or fp16) K/V rows [rows, D] (bits 0), or int8
// payload rows [rows, D] (bits 8) / [rows, D / 2] (bits 4, two values a
// byte, the even head_dim index in the low nibble) beside fp32 scales
// [rows].
struct KvRows {
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  int bits;
};

// ---- shared memory ------------------------------------------------------

template <int D, int RT, bool QUANT>
struct Layout {
  static constexpr int ROW = D * 2;             // bytes of a 16-bit row
  static constexpr int KV_TILE = TILE * ROW;    // one 16-bit K (or V) tile
  // one ring stage: the 16-bit K and V tiles, or (quantized) the raw K and V
  // payload rows (room for int8's D bytes a row) and their scales
  static constexpr int STAGE = QUANT ? 2 * TILE * D + 2 * TILE * 4 : 2 * KV_TILE;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int DEQ_OFF = RING;          // quantized: the dequantized K, V tiles
  static constexpr int Q_OFF = DEQ_OFF + (QUANT ? 2 * KV_TILE : 0);
  static constexpr int IDS_OFF = Q_OFF + RT * 16 * ROW;
  static constexpr int POS_OFF = IDS_OFF + MAX_IDS * 4;
  static constexpr int BYTES = POS_OFF + RT * 16 * 4;
  // the end-of-split merge of the 4 warps' states reuses the ring
  static constexpr int MERGE_BYTES = 4 * 16 * (D + 2) * 4;
  static_assert(MERGE_BYTES <= RING, "merge scratch fits the ring");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// stage kv tile (positions p0 .. p0 + 63) into ring stage `st`
template <int D, bool QUANT, class Rows>
__device__ __forceinline__ void issue_tile(uint8_t* st, const KvRows& kv, const Rows& rw, int h,
                                           int p0) {
  const int tid = threadIdx.x;
  if constexpr (!QUANT) {
    constexpr int CH = D / 8;  // 16-byte chunks of a row (of 16-bit values)
    const uint16_t* kp = static_cast<const uint16_t*>(kv.k);
    const uint16_t* vp = static_cast<const uint16_t*>(kv.v);
    for (int e = tid; e < TILE * CH; e += NT) {
      const int t = e / CH, c = e % CH;
      const size_t row = rw.row(h, p0 + t);
      const int off = swz<D>(t, c);
      cp_async16(st + off, kp + row * D + c * 8);
      cp_async16(st + TILE * D * 2 + off, vp + row * D + c * 8);
    }
  } else {
    const int pd = kv.bits == 4 ? D / 2 : D;  // payload bytes a row
    const int pch = pd / 16;
    const int8_t* kp = static_cast<const int8_t*>(kv.k);
    const int8_t* vp = static_cast<const int8_t*>(kv.v);
    for (int e = tid; e < TILE * pch; e += NT) {
      const int t = e / pch, c = e % pch;
      const size_t row = rw.row(h, p0 + t);
      cp_async16(st + t * pd + c * 16, kp + row * pd + c * 16);
      cp_async16(st + TILE * D + t * pd + c * 16, vp + row * pd + c * 16);
    }
    // scales: Rows::SCALE_RUN positions a copy (16 bytes, or 4)
    constexpr int RUN = Rows::SCALE_RUN;
    float* scl = reinterpret_cast<float*>(st + 2 * TILE * D);
    if (tid < 2 * TILE / RUN) {
      const int kvsel = tid / (TILE / RUN);
      const int t = RUN * (tid % (TILE / RUN));
      const float* src = (kvsel ? kv.v_scale : kv.k_scale) + rw.row(h, p0 + t);
      if constexpr (RUN == 4)
        cp_async16(scl + kvsel * TILE + t, src);
      else
        cp_async4(scl + kvsel * TILE + t, src);
    }
  }
}

// unsigned byte i of `word` minus `bias`, as an exact float: the byte
// placed under 2^23's exponent (a byte permute) and 2^23 + bias taken
// away, which spares the integer-to-float conversions (a quarter of the
// full instruction rate)
__device__ __forceinline__ float byte_value(uint32_t word, int i, float bias) {
  return __int_as_float(__byte_perm(word, 0x4B000000u, 0x7540 + i)) - (8388608.f + bias);
}

// a warp's dequantize of rows [t0, t0 + n) of a staged raw tile into the
// swizzled T K and V tiles: payload * scale in fp32, rounded once to T
// (the rows its products read; warps that share rows write the same
// values)
template <int D, typename T>
__device__ __forceinline__ void dequant_rows(const uint8_t* raw, uint8_t* deq, int bits, int t0,
                                             int n, int lane) {
  constexpr int CH = D / 8;
  const int pd = bits == 4 ? D / 2 : D;
  const float* scl = reinterpret_cast<const float*>(raw + 2 * TILE * D);
  for (int e = lane; e < 2 * n * CH; e += 32) {
    const int kv = e / (n * CH);
    const int r = t0 + (e / CH) % n;
    const int c = e % CH;
    const uint8_t* row = raw + kv * TILE * D + r * pd;
    const float s = scl[kv * TILE + r];
    uint32_t w[4];
    if (bits == 4) {
      // nibble x ^ 8 is x + 8 as an unsigned nibble
      const uint32_t b4 = *reinterpret_cast<const uint32_t*>(row + 4 * c) ^ 0x88888888u;
      const uint32_t lo = b4 & 0x0F0F0F0Fu, hi = (b4 >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int i = 0; i < 4; ++i)  // byte i: values 2i (low nibble), 2i + 1
        w[i] = hopper::pack<T>(byte_value(lo, i, 8.f) * s, byte_value(hi, i, 8.f) * s);
    } else {
      // byte x ^ 0x80 is x + 128 as an unsigned byte
      const uint2 b8 = *reinterpret_cast<const uint2*>(row + 8 * c);
      const uint32_t x[2] = {b8.x ^ 0x80808080u, b8.y ^ 0x80808080u};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = hopper::pack<T>(byte_value(x[i / 2], 2 * (i % 2), 128.f) * s,
                               byte_value(x[i / 2], 2 * (i % 2) + 1, 128.f) * s);
    }
    *reinterpret_cast<uint4*>(deq + kv * TILE * D * 2 + swz<D>(r, c)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---- the split kernel ---------------------------------------------------

// Workspace of a call, fp32: m [B, KVH, NS, R] (log2 units), l [B, KVH, NS,
// R], then acc [B, KVH, NS, R, D].
template <int D, int RT, bool QUANT, class Rows, typename T>
__global__ void __launch_bounds__(NT) split_kernel(const T* __restrict__ q, KvRows kv,
                                                   Rows rw, const int* __restrict__ pos,
                                                   float* __restrict__ ws, int kvh, int group,
                                                   int sq, int tiles_per_split, int n_splits,
                                                   float scale_log2) {
  using L = Layout<D, RT, QUANT>;
  constexpr int TS = 4 / RT;      // token slices of a tile
  constexpr int W = TILE / TS;    // tokens of a slice: 16, 32 or 64
  constexpr int NJ = W / 8;       // n8 tiles of a slice's S
  constexpr int KD = D / 16;      // k16 steps of S
  constexpr int NO = D / 8;       // n8 tiles of O
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* qs = smem + L::Q_OFF;
  int* ids = reinterpret_cast<int*>(smem + L::IDS_OFF);
  int* rowpos = reinterpret_cast<int*>(smem + L::POS_OFF);

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int rows = group * sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = split * tiles_per_split;

  // the split's page ids and the kv head's query rows, in flight while
  // the slot's positions are read
  rw.begin(ids, b, t0 * TILE, tiles_per_split * TILE);
  const T* qsrc = q + ((size_t)b * kvh + h) * rows * D;
  for (int e = tid; e < RT * 16 * (D / 8); e += NT) {
    const int r = e / (D / 8), c = e % (D / 8);
    if (r < rows)
      cp_async16(qs + swz<D>(r, c), qsrc + r * D + c * 8);
    else
      *reinterpret_cast<uint4*>(qs + swz<D>(r, c)) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  const int limit = rw.pos_limit();
  int maxpos = 0;
  for (int t = 0; t < sq; ++t) maxpos = max(maxpos, pos[b * sq + t]);
  maxpos = min(maxpos, limit);
  const int ntiles = maxpos / TILE + 1;  // the slot's live tiles
  if (t0 >= ntiles) {  // a split past the slot's live range
    cp_async_wait<0>();
    return;
  }
  const int nt = min(tiles_per_split, ntiles - t0);
  for (int r = tid; r < RT * 16; r += NT)
    rowpos[r] = r < rows ? min(pos[b * sq + r % sq], limit) : -1;
  cp_async_wait<0>();
  __syncthreads();

  uint8_t* ring = smem;
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nt) issue_tile<D, QUANT>(ring + j * L::STAGE, kv, rw, h, (t0 + j) * TILE);
    cp_async_commit();
  }

  // this warp: row tile rt, token slice sl of every tile
  const int rt = warp / TS, sl = warp % TS;
  const int g = lane / 4, cq = lane % 4;
  const int rp[2] = {rowpos[rt * 16 + g], rowpos[rt * 16 + g + 8]};
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int r = rt * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
    ldmatrix_x4(qf[kk], qs + swz<D>(r, 2 * kk + lane / 16));
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 units
  float l[2] = {0.f, 0.f};                      // this thread's share of the sum

  for (int j = 0; j < nt; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j has landed (this thread's copies)
    __syncthreads();              // ... everyone's; tile j - 1 is done with
    if (j + STAGES - 1 < nt)
      issue_tile<D, QUANT>(ring + ((j + STAGES - 1) % STAGES) * L::STAGE, kv, rw, h,
                           (t0 + j + STAGES - 1) * TILE);
    cp_async_commit();
    const int tok0 = sl * W;  // the slice's first token in the tile
    const uint8_t* kt = ring + (j % STAGES) * L::STAGE;
    if constexpr (QUANT) {
      dequant_rows<D, T>(kt, smem + L::DEQ_OFF, kv.bits, tok0, W, lane);
      __syncwarp();
      kt = smem + L::DEQ_OFF;
    }
    const uint8_t* vt = kt + TILE * D * 2;

    // S = Q K^T over the slice's W tokens
    float s[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t kb[4];
        const int t = tok0 + 16 * jp + (lane / 16) * 8 + lane % 8;
        ldmatrix_x4(kb, kt + swz<D>(t, 2 * kk + (lane / 8) % 2));
        mma<T>(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma<T>(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // mask kvp > row position, online softmax in log2 units
    const int kv0 = (t0 + j) * TILE + tok0 + 2 * cq;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e / 2;
        const float x = kv0 + 8 * jj + (e & 1) <= rp[u] ? s[jj][e] * scale_log2 : -CUDART_INF_F;
        s[jj][e] = x;
        mx[u] = fmaxf(mx[u], x);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      const float m_new = fmaxf(m[u], mx[u]);
      // a row that has attended nothing yet keeps m = -inf: subtract 0
      // instead, so no exp2(-inf - -inf) is formed (its p are all 0)
      m_use[u] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[u] = exp2f(m[u] - m_use[u]);
      m[u] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[jj][e] = exp2f(s[jj][e] - m_use[e / 2]);  // masked: exp2(-inf) = 0
        sum[e / 2] += s[jj][e];
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) l[u] = l[u] * alpha[u] + sum[u];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P rounded to T as the A operand, k16 step kt2 is S's n8
    // tiles 2 kt2 and 2 kt2 + 1
#pragma unroll
    for (int kt2 = 0; kt2 < W / 16; ++kt2) {
      uint32_t pa[4];
      pa[0] = hopper::pack<T>(s[2 * kt2][0], s[2 * kt2][1]);
      pa[1] = hopper::pack<T>(s[2 * kt2][2], s[2 * kt2][3]);
      pa[2] = hopper::pack<T>(s[2 * kt2 + 1][0], s[2 * kt2 + 1][1]);
      pa[3] = hopper::pack<T>(s[2 * kt2 + 1][2], s[2 * kt2 + 1][3]);
      const int t = tok0 + 16 * kt2 + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
      for (int p2 = 0; p2 < D / 16; ++p2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + swz<D>(t, 2 * p2 + lane / 16));
        mma<T>(o[2 * p2], pa, vb[0], vb[1]);
        mma<T>(o[2 * p2 + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // merge the warps' states (the TS slices of each row tile) through the
  // ring, then write the split's partial
  cp_async_wait<0>();
  __syncthreads();
  float* sm_acc = reinterpret_cast<float*>(smem);  // [4 warps][16][D]
  float* sm_m = sm_acc + 4 * 16 * D;               // [4][16]
  float* sm_l = sm_m + 4 * 16;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    if (cq == 0) {
      sm_m[warp * 16 + g + 8 * u] = m[u];
      sm_l[warp * 16 + g + 8 * u] = l[u];
    }
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      *reinterpret_cast<float2*>(sm_acc + (warp * 16 + g + 8 * u) * D + 8 * n + 2 * cq) =
          make_float2(o[n][2 * u], o[n][2 * u + 1]);
  __syncthreads();
  const size_t part = ((size_t)b * kvh + h) * n_splits + split;  // this partial
  const size_t n_parts = (size_t)gridDim.x * kvh * n_splits;
  float* ws_m = ws + part * rows;
  float* ws_l = ws + n_parts * rows + part * rows;
  float* ws_acc = ws + 2 * n_parts * rows + part * rows * D;
  for (int e = tid; e < rows * D; e += NT) {
    const int r = e / D, d = e % D;
    const int w0 = (r / 16) * TS, rr = r % 16;
    float mm = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < TS; ++k) mm = fmaxf(mm, sm_m[(w0 + k) * 16 + rr]);
    float acc = 0.f, ll = 0.f;
    if (mm != -CUDART_INF_F) {
#pragma unroll
      for (int k = 0; k < TS; ++k) {
        const float wk = exp2f(sm_m[(w0 + k) * 16 + rr] - mm);  // -inf: 0
        acc += sm_acc[((w0 + k) * 16 + rr) * D + d] * wk;
        ll += sm_l[(w0 + k) * 16 + rr] * wk;
      }
    }
    ws_acc[e] = acc;
    if (d == 0) {
      ws_m[r] = mm;
      ws_l[r] = ll;
    }
  }
}

// ---- the merge pass -----------------------------------------------------

// Row r of (slot b, kv head h) from the partials of the slot's live
// splits, one block of D threads a row (thread d owns column d), rounded
// once to T; a row with l == 0 writes 0 (never on the paths: every row
// attends position 0). The live splits are counted from the max position
// bounded by `pos_limit`, as the split kernel counts the splits it writes:
// the workspace holds nothing else.
template <int D, typename T>
__global__ void __launch_bounds__(D) merge_kernel(const float* __restrict__ ws,
                                                  const int* __restrict__ pos,
                                                  T* __restrict__ out, int kvh, int group,
                                                  int sq, int tiles_per_split, int n_splits,
                                                  int pos_limit) {
  __shared__ float warp_max[D / 32];
  const int b = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int d = threadIdx.x;
  const int rows = group * sq;
  int maxpos = 0;
  for (int t = 0; t < sq; ++t) maxpos = max(maxpos, pos[b * sq + t]);
  maxpos = min(maxpos, pos_limit);
  const int live = (maxpos / TILE) / tiles_per_split + 1;
  const size_t part0 = ((size_t)b * kvh + h) * n_splits;
  const size_t n_parts = (size_t)gridDim.x * kvh * n_splits;
  const float* ws_m = ws + part0 * rows + r;  // split i at [i * rows]
  const float* ws_l = ws + n_parts * rows + part0 * rows + r;
  const float* ws_acc = ws + 2 * n_parts * rows + (part0 * rows + r) * D + d;  // [i * rows * D]
  // M = max_i m_i over the block
  float mm = -CUDART_INF_F;
  for (int i = d; i < live; i += D) mm = fmaxf(mm, ws_m[(size_t)i * rows]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
  if (d % 32 == 0) warp_max[d / 32] = mm;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < D / 32; ++w) mm = fmaxf(mm, warp_max[w]);
  float num = 0.f, den = 0.f;
  if (mm != -CUDART_INF_F) {
#pragma unroll 4
    for (int i = 0; i < live; ++i) {
      const float w = exp2f(ws_m[(size_t)i * rows] - mm);  // -inf: exactly 0
      num += ws_acc[(size_t)i * rows * D] * w;
      den += ws_l[(size_t)i * rows] * w;
    }
  }
  out[(((size_t)b * kvh + h) * rows + r) * D + d] = from_float<T>(den == 0.f ? 0.f : num / den);
}

// ---- launch -------------------------------------------------------------

template <int D, int RT, bool QUANT, class Rows, typename T>
cudaError_t launch_rt(const T* q, const KvRows& kv, const Rows& rw, const int* pos,
                      float* ws, T* out, int b, int kvh, int group, int sq,
                      int tiles_per_split, int n_splits, float scale, cudaStream_t stream) {
  using L = Layout<D, RT, QUANT>;
  static bool smem_ok = false;
  if (!smem_ok) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<D, RT, QUANT, Rows, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::BYTES);
    if (err != cudaSuccess) return err;
    smem_ok = true;
  }
  split_kernel<D, RT, QUANT, Rows, T><<<dim3(b, kvh, n_splits), NT, L::BYTES, stream>>>(
      q, kv, rw, pos, ws, kvh, group, sq, tiles_per_split, n_splits, scale * LOG2E);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<D, T><<<dim3(b, kvh, group * sq), D, 0, stream>>>(
      ws, pos, out, kvh, group, sq, tiles_per_split, n_splits, rw.pos_limit());
  return cudaGetLastError();
}

template <int D, bool QUANT, class Rows, typename T>
cudaError_t launch_d(const T* q, const KvRows& kv, const Rows& rw, const int* pos, float* ws,
                     T* out, int b, int kvh, int group, int sq, int tiles_per_split,
                     int n_splits, float scale, cudaStream_t stream) {
  const int rows = group * sq;
  if (rows <= 16)
    return launch_rt<D, 1, QUANT>(q, kv, rw, pos, ws, out, b, kvh, group, sq, tiles_per_split,
                                  n_splits, scale, stream);
  if (rows <= 32)
    return launch_rt<D, 2, QUANT>(q, kv, rw, pos, ws, out, b, kvh, group, sq, tiles_per_split,
                                  n_splits, scale, stream);
  return launch_rt<D, 4, QUANT>(q, kv, rw, pos, ws, out, b, kvh, group, sq, tiles_per_split,
                                n_splits, scale, stream);
}

// Launch the split kernel and the merge pass on `stream`, T bf16 or fp16
// (q and out; the K/V rows too unless QUANT). D 64 or 128, R =
// group * sq in 1..64, paged: tiles_per_split * 64 / ps + 2 <= MAX_IDS
// (the wrapper checks all of it and sizes the workspace: B * KVH *
// n_splits * R * (D + 2) floats).
template <bool QUANT, class Rows, typename T>
cudaError_t launch(const T* q, const KvRows& kv, const Rows& rw, const int* pos, float* ws,
                   T* out, int b, int kvh, int group, int sq, int d, int tiles_per_split,
                   int n_splits, float scale, cudaStream_t stream) {
  const int rows = group * sq;
  if (rows < 1 || rows > MAX_ROWS || tiles_per_split < 1 || n_splits < 1)
    return cudaErrorInvalidValue;
  if (d == 128)
    return launch_d<128, QUANT>(q, kv, rw, pos, ws, out, b, kvh, group, sq, tiles_per_split,
                                n_splits, scale, stream);
  if (d == 64)
    return launch_d<64, QUANT>(q, kv, rw, pos, ws, out, b, kvh, group, sq, tiles_per_split,
                               n_splits, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace decode
