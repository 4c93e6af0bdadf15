// Hopper (sm_90a) building blocks for hand-written kernels: shared-memory
// barriers (mbarrier), TMA tile and bulk loads, warpgroup matrix multiply
// (wgmma) with its shared-memory descriptors, and the host-side encoding
// of a TMA tensor map.
//
// Layout contract. Every tile a wgmma reads from shared memory is loaded
// by TMA with the 128-byte swizzle: a box of 64 bf16 columns (one 128-byte
// row) by R rows lands as R rows of 128 bytes whose 16-byte chunks are
// permuted by (row % 8), in 1024-byte atoms of 8 rows. A tile wider than
// 64 columns is loaded as several such boxes, one after another. The
// descriptors below say the same thing to the tensor cores (layout type
// 1, SWIZZLE_128B, bits 62-63):
//
// - K-major operand (rows = M or N, 64 contiguous K values a row): SBO =
//   1024 bytes between 8-row groups, LBO unused; a k16 step inside the
//   64-column box advances the start address by 32 bytes.
// - MN-major operand (rows = K, 64 contiguous M or N values a row): SBO =
//   1024 bytes between 8-row groups along K, LBO = the byte distance to
//   the box holding the next 64 columns of M or N; a k16 step advances
//   the start address by 16 rows (2048 bytes).
//
// Element types. Every tile is 16-bit: bf16 (the default of every helper
// below) or fp16 (the flash kernels' fp16 entries). Elem<T> names the
// type to the TMA and the wgmma, and packs and unpacks pairs of it; both
// types have the same byte layout, so the swizzle and the descriptors are
// the same.
//
// The tensor-map encoder (cuTensorMapEncodeTiled) is in libcuda, not in
// the CUDA runtime that the kernels' libraries link: it is looked up once
// through cudaGetDriverEntryPointByVersion (CUDA 12.5 on;
// cudaGetDriverEntryPoint before), so no -lcuda is needed.
#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's enums: types only
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // two floats -> one register of two bf16 (round to nearest even), the
  // first in the low half
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  // the low / high element of a register, exactly
  __device__ static __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
  __device__ static __forceinline__ float hi(uint32_t w) {
    return __uint_as_float(w & 0xFFFF0000u);
  }
};

template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  // round to nearest even; past fp16's range a value becomes +-inf, so an
  // overflow reaches the caller's finite check
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static __forceinline__ float lo(uint32_t w) {
    return __half2float(__ushort_as_half((unsigned short)(w & 0xFFFFu)));
  }
  __device__ static __forceinline__ float hi(uint32_t w) {
    return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
};

template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the barrier's phase of parity `parity` has completed. A wait
// of 2^26 polls (far beyond any load's latency) means a barrier that will
// never complete: the kernel traps, so the caller sees an error, not a hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0; !mbar_try_wait(addr, parity); ++n)
    if (n == (1u << 26)) __trap();
}

// ---- TMA --------------------------------------------------------------

// one box of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory; completion is counted in bytes on `bar`. Out-of-range
// elements of the box are written as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16, from a 16-byte aligned address) of global
// memory into shared memory, completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ------------------------------------------------------------

// shared-memory matrix descriptor of a 128-byte-swizzled operand (see the
// layout contract above); offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// orders this thread's register and shared-memory writes before the
// wgmmas that follow
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator across the wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two floats -> one register of two T (round to nearest even), the first
// in the low half: the element of the lower k index
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return Elem<T>::pack(lo, hi);
}

// The accumulator of an m64nNk16 wgmma: thread t of the warpgroup (warp w
// = t / 32, lane l = t % 32) holds N / 2 floats; register i is row
// 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory, both
// K-major (no transpose). scale_d 0 overwrites D.
#define HOPPER_WGMMA_M64N128K16_SS(TY) \
  asm volatile(\
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"\
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "\
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "\
      "%64, %65, p, 1, 1, 0, 0;\n}\n"\
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),\
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),\
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),\
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),\
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])\
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>) {
    HOPPER_WGMMA_M64N128K16_SS("f16");
  } else {
    HOPPER_WGMMA_M64N128K16_SS("bf16");
  }
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory, both
// K-major (no transpose). scale_d 0 overwrites D.
#define HOPPER_WGMMA_M64N64K16_SS(TY) \
  asm volatile(\
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"\
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "\
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "\
      "%32, %33, p, 1, 1, 0, 0;\n}\n"\
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])\
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>) {
    HOPPER_WGMMA_M64N64K16_SS("f16");
  } else {
    HOPPER_WGMMA_M64N64K16_SS("bf16");
  }
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (four bf16 pairs a
// thread, the m16n8k16 A layout per warp), B from shared memory MN-major
// (the transpose bit set). scale_d 0 overwrites D.
#define HOPPER_WGMMA_M64N128K16_RS_TB(TY) \
  asm volatile(\
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"\
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "\
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "\
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"\
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),\
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),\
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),\
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),\
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])\
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>) {
    HOPPER_WGMMA_M64N128K16_RS_TB("f16");
  } else {
    HOPPER_WGMMA_M64N128K16_RS_TB("bf16");
  }
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (four bf16 pairs a
// thread, the m16n8k16 A layout per warp), B from shared memory MN-major
// (the transpose bit set). scale_d 0 overwrites D.
#define HOPPER_WGMMA_M64N64K16_RS_TB(TY) \
  asm volatile(\
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"\
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "\
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "\
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"\
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])\
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>) {
    HOPPER_WGMMA_M64N64K16_RS_TB("f16");
  } else {
    HOPPER_WGMMA_M64N64K16_RS_TB("bf16");
  }
}

// D[64 x N] += A[64 x 16] B[16 x N] for N 128 or 64 (a head dim): the
// register-A, MN-major-B product above of that width
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  static_assert(N == 128 || N == 64, "N is 64 or 128");
  if constexpr (N == 128) {
    wgmma_m64n128k16_rs_tb<T>(d, a, desc_b, 1);
  } else {
    wgmma_m64n64k16_rs_tb<T>(d, a, desc_b, 1);
  }
}

// ---- host: tensor maps ------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a contiguous 16-bit tensor of type T seen as [mats, rows,
// cols] (cols innermost), read in boxes of 64 columns x box_rows rows x 1
// with the 128-byte swizzle; rows past `rows` read as zeros.
template <typename T>
inline cudaError_t tile_map(CUtensorMap* map, const void* base, int cols, int rows, int mats,
                            int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 || (cols * 2) % 16) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, Elem<T>::TMA, 3, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
