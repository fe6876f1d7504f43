// Shared __device__ helpers of the tensor-core kernels (mm_tc_kernels.cu,
// attn_tc_kernels.cu): mbarriers, cp.async into shared memory, the
// 128-byte swizzle and its wgmma descriptor, and the wgmma fence /
// commit / wait instructions (sm_90a).  mm_kernels.cu's mm_vpu takes the
// cp.async ones.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

constexpr int kSwizzleRow = 128;   // bytes per row of a swizzled tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// arrive on bar once this thread's earlier cp.asyncs have landed (the
// arrival counts against the barrier's expected count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed cp.async groups pend
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// order generic-proxy shared-memory writes before async-proxy (wgmma) reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows under the 128-byte swizzle (rows in groups of 8, chunk ^ row % 8)
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return uint32_t(row * kSwizzleRow + ((chunk ^ (row & 7)) << 4));
}

// wgmma shared-memory descriptor under the 128-byte swizzle (mode 1):
// start address, leading and stride byte offsets, all in 16-byte units.
// K-major tile of 128-byte rows: stride 1024 bytes between 8-row groups,
// leading offset unused (1).  MN-major tile: stride 1024 bytes between
// 8-row k groups, leading offset between 64-column blocks.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lead = 16) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lead >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator definitions across the
// wgmma pipeline (an empty asm that "reads and writes" every register)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

}  // namespace tc
