// Hopper (sm_90a) primitives shared by the kernels that run on wgmma:
// the critic forward (pairwise_critic_fwd.cu through wgmma_tf32.cuh) and
// the bfloat16 fused-FFN weight gradients (fused_ffn_bwd.cu through
// wgmma_bf16.cuh).
//
//   * mbarrier init, arrive, arrive.expect_tx and the parity wait;
//     cp.async.bulk from global to shared memory and the 2-D TMA tile
//     load (cp.async.bulk.tensor, a tensor map), both completed on an
//     mbarrier; tmap_2d_bf16 builds the tensor map of a row-major bf16
//     matrix on the host (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPointByVersion, so nothing links libcuda);
//   * wgmma's fence, commit and group wait, and the compiler fence that
//     keeps accumulators in place across the asynchronous products;
//   * fence.proxy.async (shared-memory writes of the threads made visible
//     to wgmma, which reads through the async proxy) and a named barrier
//     of part of a block.
//
// tests/cuda_cpu/cuda_runtime.h defines CUDA_CPU_STANDIN and gives a CPU
// version of each (the tensor map a struct of its own, the TMA copy with
// the 128-byte swizzle and zero fill written out).
#pragma once

#include <cstdint>

#include "warp_mma.cuh"

#ifndef CUDA_CPU_STANDIN

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the barriers' initialisation visible to the async proxy (the copies)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive, and expect `bytes` more of copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing that many bytes of `bar`'s phase
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the box of `map` at (column col, row row) into shared memory at dst
// (1024-byte aligned for the 128-byte swizzle), zeros where it lies past
// the matrix; completes the box's bytes of `bar`'s phase
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(col), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

// this thread's shared-memory writes visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) of `count` threads
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// orders this warpgroup's register and shared-memory accesses before the
// wgmma that follow
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most n committed groups of this warpgroup are in flight
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The tensor map of a row-major bf16 matrix of `rows` x `cols` (cols a
// multiple of 8, base 16-byte aligned) whose TMA box is `box_rows` rows
// of 64 columns (128 bytes) in the 128-byte swizzle, zeros past the
// edges.  Returns a cudaError_t (cudaErrorInvalidValue if
// cuTensorMapEncodeTiled refuses the map).  Needs CUDA 12.5 or later.
inline int tmap_2d_bf16(CUtensorMap* map, const void* base, int rows,
                        int cols, int box_rows) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorInvalidValue;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

#endif  // CUDA_CPU_STANDIN
