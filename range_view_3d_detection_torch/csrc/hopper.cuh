// Hopper (sm_90a) helpers shared by the port's wgmma kernels
// (conv3x3_i8.cu, meta_kernel_fused.cu, meta_kernel_fused_i8.cu):
// shared-memory addresses, mbarriers, TMA tensor loads, the wgmma fence /
// commit / wait, the two stems' 128-byte-swizzle tiles, bf16 unpacking
// and weight tensor maps.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait of more
// than 2^32 cycles (about 2 s) traps: a pipeline fault becomes a launch
// failure, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  long long t0 = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 < 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 32)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Makes this thread's generic-proxy shared-memory stores visible to the
// async proxy (wgmma operand reads, TMA) after a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Named barrier `id` over the first `kCount` threads of the block.
template <int kCount>
__device__ __forceinline__ void named_barrier_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kCount) : "memory");
}

// ---- The stems' (K1, K4) 64-row K-major tiles in the 128-byte swizzle.
constexpr int kSw128Rows = 64;
constexpr int kSw128AtomBytes = kSw128Rows * 128;

// Byte offset of byte `kb` of row m: k-block kb / 128 is an 8 KB atom of
// 64 rows of 128 bytes, and the 16-byte chunk index is XORed with m % 8, as
// TMA's SWIZZLE_128B writes it (kb = 2 k for bf16 channel k, k for int8).
__device__ __forceinline__ int sw128(int m, int kb) {
  return (kb >> 7) * kSw128AtomBytes + m * 128 + ((((kb >> 4) & 7) ^ (m & 7)) << 4) +
         (kb & 15);
}

// wgmma descriptor: K-major, 128-byte swizzle, 8-row groups 1024 bytes
// apart (SBO); the leading offset is unused for K-major swizzled tiles.
// A 32-byte k step (k16 in bf16, k32 in int8) inside the 128-byte row
// advances the start address by 32 bytes, i.e. the descriptor by 2 (the
// atom is 1024-byte aligned, so the base offset is 0).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// A 3-D tensor map over `mats` [C][C] matrices of `elem_bytes`-byte
// elements, boxes of 128 bytes of k x `rows` n x 1 matrix in the 128-byte
// swizzle. Elements outside a matrix (k or n >= C) arrive as zeros.
inline bool stem_weight_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                            const void* base, int C, int rows, int mats) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)C, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)C * elem_bytes,
                                 (cuuint64_t)C * C * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, type, 3, const_cast<void*>(base), dims, strides, box,
                                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
