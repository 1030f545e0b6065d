// Hopper (sm_90a) plumbing shared by the port's kernels: mbarriers, TMA,
// setmaxnreg, wgmma and its shared-memory descriptors, the int8 -> bf16
// conversion, and the host-side tensor-map encoding.
//
// Everything sits in an anonymous namespace, so each kernel source that
// includes this header gets its own internal copy, exactly as if the code
// were written in that source.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Every wait is on another warp of the same block, so one that lasts about
// 2^34 cycles (seconds) is a deadlock: it traps, and the launch fails instead
// of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t spins = 0;
  long long t0 = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && (++spins & 4095) == 0) {
      if (t0 == 0) t0 = clock64();
      else if (clock64() - t0 > (1ll << 34)) __trap();
    }
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Threads 0..127 of the producer warpgroup meet (named barrier 1); the
// consumers run on.
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cta.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Generic-proxy shared-memory writes made visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define LOTUS_ACC32(c)                                                                     \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),      \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),      \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define LOTUS_F(x) "+f"(x)
#define LOTUS_R(x) "+r"(x)
#define LOTUS_D32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D (64 x 64) += A (64 x 16 bf16, K-major) * B (64 x 16 bf16, K-major)^T;
// scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LOTUS_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : LOTUS_ACC32(LOTUS_F)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64) += A (64 x 32 s8, K-major) * B (64 x 32 s8, K-major)^T, exact.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " LOTUS_D32 ", %32, %33, p;\n}\n"
      : LOTUS_ACC32(LOTUS_R)
      : "l"(da), "l"(db), "r"(scale_d));
}

// Pins the accumulators in place around the asynchronous wgmma: no read or
// copy of them moves across this point.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- conversions -----------------------------------------------------------

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// Eight int8 values, little-endian in (lo, hi), as eight bf16 (exact), with
// no int -> float conversion instruction (those issue at a quarter of the
// ALU rate): byte v ^ 0x80 = v + 128 placed in the low mantissa of 2^23 gives
// the f32 2^23 + 128 + v, and subtracting 2^23 + 128 leaves v exactly.  An
// int8 has at most 8 significant bits, so its f32 is its bf16 in the high
// half, and one byte permute packs two of them.
__device__ __forceinline__ uint4 int8x8_to_bf16(uint32_t lo, uint32_t hi) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t src = (i < 2 ? lo : hi) ^ 0x80808080u;
    const int b0 = 2 * (i % 2);
    const float f0 = __fsub_rn(__uint_as_float(__byte_perm(src, 0x4B000000u, 0x7540u + b0)), 8388736.f);
    const float f1 = __fsub_rn(__uint_as_float(__byte_perm(src, 0x4B000000u, 0x7541u + b0)), 8388736.f);
    w[i] = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Unit u (16 bytes) of row r in a tile of 128-byte rows in the 128-byte
// swizzle, at a 1024-aligned base.
__device__ __forceinline__ uint4* swizzled(uint8_t* tile, int r, int u) {
  return reinterpret_cast<uint4*>(tile + r * 128 + ((u ^ (r & 7)) << 4));
}

// ---- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, d) row-major operand of esize-byte values as boxes of box_rows
// rows x box_bytes bytes of depth; outside (rows, d) a box holds zeros.
bool make_map(CUtensorMap* map, const void* ptr, int esize, int d, int rows, int box_bytes,
              int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_bytes / esize), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapDataType type = esize == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return encode(map, type, 2,
                const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned(const void* p, long bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace
