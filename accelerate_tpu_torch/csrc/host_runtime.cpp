// host_runtime — the host-side helpers of the port's checkpoint load path
// and of its data loader's prefetch ring.
//
// The port's own copy of entry points of the reference's
// csrc/att_runtime.cpp, built with g++ at first use and bound with ctypes
// (accelerate_tpu_torch/runtime/native.py). A ctypes call releases the
// interpreter lock, so it runs beside the loader's other threads.
//
//   host_quantize_group — per-group symmetric weight quantization
//     (linear int8 / int4, NF4) along dim 0 of a row-major [k, n] matrix,
//     straight from fp32 or bf16 bytes. Bit for bit the arithmetic of the
//     reference's att_quantize_group and of the plain version in
//     utils/quantization.py: an fp32 absmax per (group, column), scale =
//     amax / qmax (linear) or amax (NF4), 1 for an all-zero column, values
//     times the reciprocal of the scale (a multiply, not a divide), rounded
//     half to even and clipped to +-qmax, or the NF4 index = the number of
//     code midpoints below the value. Work items are (group, column range)
//     pairs, not whole groups: a layer-stacked leaf has a single group (k =
//     layers < group size), and splitting its columns keeps every core busy
//     and each item's rows in cache.
//
//   host_parallel_memcpy — count (dst, src, size) copies spread over
//     num_threads native threads: the prefetch producer's assembly of a
//     batch's fields into a ring slot.
//
//   host_ring_* — a ring of `slots` fixed-size byte buffers between one
//     producer and one consumer (runtime/prefetch.py's RingBuffer). The
//     producer takes the next slot with acquire_fill (blocking while the
//     consumer still holds it), writes it through slot_ptr and hands it
//     over with commit_fill; the consumer takes slots in the same order
//     with acquire_read (blocking until one is committed) and gives each
//     back with release_read. close() wakes both sides: acquire_fill then
//     returns -1, and acquire_read returns -1 once no committed slot is
//     left. Each slot's storage is 64-byte aligned.
//
// The reference's parallel pread (att_parallel_read) serves its per-rank
// distributed checkpoint reader, which the port does not carry yet.
//
// Pure C ABI: no Python or PyTorch headers.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

void parallel_for(int count, int num_threads, void (*body)(int, void *), void *ctx) {
  if (num_threads < 1) num_threads = 1;
  if (num_threads > count) num_threads = count > 0 ? count : 1;
  std::atomic<int> next{0};
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([&]() {
      int i;
      while ((i = next.fetch_add(1)) < count) body(i, ctx);
    });
  }
  for (auto &w : workers) w.join();
}

// NormalFloat4 code (QLoRA): must match utils/quantization.NF4_CODE.
const float kNf4Code[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.4407098591327667f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

struct Mids {
  float v[15];
  Mids() {
    for (int t = 0; t < 15; ++t) v[t] = 0.5f * (kNf4Code[t] + kNf4Code[t + 1]);
  }
};
const Mids kNf4Mid;

inline int nf4_index(float x) {
  int idx = 0;
  for (int t = 0; t < 15; ++t) idx += x > kNf4Mid.v[t];
  return idx;
}

inline int8_t quant_linear(float x, float qmax) {
  float v = std::nearbyintf(x);  // half to even under the default rounding mode
  if (v > qmax) v = qmax;
  if (v < -qmax) v = -qmax;
  return static_cast<int8_t>(v);
}

struct QuantCtx {
  const unsigned char *src;
  int src_dtype;  // 0 = fp32, 1 = bf16 (uint16 storage)
  uint64_t k, n, group, cols;  // cols: columns per work item
  uint64_t chunks;              // column ranges per group
  int bits;
  int nf4;
  int8_t *out_q;
  float *out_scale;
};

// rows [r0, r0 + rows) x columns [j0, j0 + w) of the source as fp32
void stage_rows(const QuantCtx &c, uint64_t r0, uint64_t rows, uint64_t j0, uint64_t w,
                float *buf) {
  for (uint64_t r = 0; r < rows; ++r) {
    const uint64_t off = (r0 + r) * c.n + j0;
    float *dst = buf + r * w;
    if (c.src_dtype == 0) {
      std::memcpy(dst, reinterpret_cast<const float *>(c.src) + off, w * sizeof(float));
    } else {
      const uint16_t *src = reinterpret_cast<const uint16_t *>(c.src) + off;
      uint32_t *bits = reinterpret_cast<uint32_t *>(dst);
      for (uint64_t j = 0; j < w; ++j) bits[j] = static_cast<uint32_t>(src[j]) << 16;
    }
  }
}

// one row's codes: linear values or NF4 indices of row * recip
void code_row(const float *row, const float *recip, uint64_t w, bool nf4, float qmax,
              int8_t *out) {
  if (nf4) {
    for (uint64_t j = 0; j < w; ++j) out[j] = static_cast<int8_t>(nf4_index(row[j] * recip[j]));
  } else {
    for (uint64_t j = 0; j < w; ++j) out[j] = quant_linear(row[j] * recip[j], qmax);
  }
}

void quant_item(int item, void *vctx) {
  const QuantCtx &c = *static_cast<const QuantCtx *>(vctx);
  const uint64_t g = static_cast<uint64_t>(item) / c.chunks;
  const uint64_t j0 = (static_cast<uint64_t>(item) % c.chunks) * c.cols;
  const uint64_t j1 = j0 + c.cols < c.n ? j0 + c.cols : c.n;
  if (j0 >= j1) return;
  const uint64_t w = j1 - j0;
  const uint64_t r0 = g * c.group;
  const float qmax = c.bits == 8 ? 127.0f : 7.0f;

  // the item's rows as fp32, once
  std::vector<float> buf(c.group * w);
  stage_rows(c, r0, c.group, j0, w, buf.data());

  // per-column absmax over the group's rows, row by row
  std::vector<float> amax(w, 0.0f);
  for (uint64_t r = 0; r < c.group; ++r)
    for (uint64_t j = 0; j < w; ++j) {
      float a = std::fabs(buf[r * w + j]);
      if (a > amax[j]) amax[j] = a;
    }
  std::vector<float> recip(w);
  float *scale_row = c.out_scale + g * c.n + j0;
  for (uint64_t j = 0; j < w; ++j) {
    float s = c.nf4 ? (amax[j] > 0 ? amax[j] : 1.0f) : (amax[j] > 0 ? amax[j] / qmax : 1.0f);
    scale_row[j] = s;
    recip[j] = 1.0f / s;
  }

  if (c.bits == 8) {
    for (uint64_t r = 0; r < c.group; ++r)
      code_row(buf.data() + r * w, recip.data(), w, false, qmax, c.out_q + (r0 + r) * c.n + j0);
    return;
  }
  // 4 bits: rows pack two per byte along dim 0 (row 2i the low nibble, row
  // 2i + 1 the high one); a missing last row (odd k) packs as zero
  std::vector<int8_t> lo(w), hi(w);
  for (uint64_t r = 0; r < c.group; r += 2) {
    code_row(buf.data() + r * w, recip.data(), w, c.nf4, qmax, lo.data());
    if (r + 1 < c.group)
      code_row(buf.data() + (r + 1) * w, recip.data(), w, c.nf4, qmax, hi.data());
    else
      std::memset(hi.data(), 0, w);
    int8_t *out_row = c.out_q + ((r0 + r) / 2) * c.n + j0;
    for (uint64_t j = 0; j < w; ++j)
      out_row[j] = static_cast<int8_t>((lo[j] & 0x0F) | ((hi[j] & 0x0F) << 4));
  }
}

}  // namespace

extern "C" {

// Per-group quantization of a row-major [k, n] matrix along dim 0.
// src_dtype: 0 = fp32, 1 = bf16. nf4: 0 = linear (scale = amax / qmax),
// 1 = NF4 (scale = amax, output = code indices). bits 8: out_q int8 [k, n];
// bits 4: out_q packed [(k + 1) / 2, n]. out_scale: fp32 [k / group, n].
// `group` must divide k; with bits 4 and k > group, group must be even.
// Returns 0 on success.
int host_quantize_group(const unsigned char *src, int src_dtype, uint64_t k, uint64_t n,
                        uint64_t group, int bits, int nf4, int8_t *out_q, float *out_scale,
                        int num_threads) {
  if (k == 0 || n == 0 || group == 0 || k % group != 0) return -1;
  if (bits != 8 && bits != 4) return -2;
  if (bits == 4 && group % 2 != 0 && k != group) return -3;
  if (src_dtype != 0 && src_dtype != 1) return -4;
  const uint64_t groups = k / group;
  // column ranges whose fp32 rows fit in ~1 MB (at least 64 columns)
  uint64_t cols = (uint64_t{1} << 18) / group;
  if (cols < 64) cols = 64;
  const uint64_t chunks = (n + cols - 1) / cols;
  QuantCtx ctx{src, src_dtype, k, n, group, cols, chunks, bits, nf4, out_q, out_scale};
  parallel_for(static_cast<int>(groups * chunks), num_threads, quant_item, &ctx);
  return 0;
}

// Copy sizes[i] bytes from srcs[i] to dsts[i] for every i < count, on up
// to num_threads threads.
void host_parallel_memcpy(unsigned char **dsts, const unsigned char **srcs,
                          const uint64_t *sizes, int count, int num_threads) {
  struct Ctx {
    unsigned char **dst;
    const unsigned char **src;
    const uint64_t *sz;
  } ctx{dsts, srcs, sizes};
  parallel_for(
      count, num_threads,
      [](int i, void *p) {
        auto *c = static_cast<Ctx *>(p);
        std::memcpy(c->dst[i], c->src[i], c->sz[i]);
      },
      &ctx);
}

}  // extern "C"

namespace {

struct Ring {
  int slots = 0;
  uint64_t slot_bytes = 0;
  std::vector<unsigned char *> storage;
  std::vector<int> state;  // 0 free, 1 filling, 2 ready, 3 reading
  int fill_cursor = 0;
  int read_cursor = 0;
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv;
};

}  // namespace

extern "C" {

// A ring of `slots` buffers of `slot_bytes` bytes each, or null when the
// arguments are out of range or the memory cannot be had.
void *host_ring_create(int slots, uint64_t slot_bytes) {
  if (slots < 1 || slot_bytes < 1) return nullptr;
  auto *r = new Ring();
  r->slots = slots;
  r->slot_bytes = slot_bytes;
  const uint64_t rounded = (slot_bytes + 63) / 64 * 64;
  for (int i = 0; i < slots; ++i) {
    void *p = std::aligned_alloc(64, rounded);
    if (p == nullptr) {
      for (unsigned char *q : r->storage) std::free(q);
      delete r;
      return nullptr;
    }
    r->storage.push_back(static_cast<unsigned char *>(p));
  }
  r->state.assign(slots, 0);
  return r;
}

void host_ring_destroy(void *ring) {
  auto *r = static_cast<Ring *>(ring);
  for (unsigned char *p : r->storage) std::free(p);
  delete r;
}

void host_ring_close(void *ring) {
  auto *r = static_cast<Ring *>(ring);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed = true;
  }
  r->cv.notify_all();
}

// The next slot to fill, or -1 once the ring is closed.
int host_ring_acquire_fill(void *ring) {
  auto *r = static_cast<Ring *>(ring);
  std::unique_lock<std::mutex> lk(r->mu);
  const int slot = r->fill_cursor;
  r->cv.wait(lk, [&] { return r->closed || r->state[slot] == 0; });
  if (r->closed) return -1;
  r->state[slot] = 1;
  r->fill_cursor = (slot + 1) % r->slots;
  return slot;
}

void host_ring_commit_fill(void *ring, int slot) {
  auto *r = static_cast<Ring *>(ring);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->state[slot] = 2;
  }
  r->cv.notify_all();
}

// The next committed slot, or -1 once the ring is closed with none left.
int host_ring_acquire_read(void *ring) {
  auto *r = static_cast<Ring *>(ring);
  std::unique_lock<std::mutex> lk(r->mu);
  const int slot = r->read_cursor;
  r->cv.wait(lk, [&] { return r->closed || r->state[slot] == 2; });
  if (r->state[slot] != 2) return -1;
  r->state[slot] = 3;
  r->read_cursor = (slot + 1) % r->slots;
  return slot;
}

void host_ring_release_read(void *ring, int slot) {
  auto *r = static_cast<Ring *>(ring);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->state[slot] = 0;
  }
  r->cv.notify_all();
}

unsigned char *host_ring_slot_ptr(void *ring, int slot) {
  return static_cast<Ring *>(ring)->storage[slot];
}

uint64_t host_ring_slot_bytes(void *ring) { return static_cast<Ring *>(ring)->slot_bytes; }

}  // extern "C"
