// A CPU stand-in for the subset of the CUDA runtime that the pairwise
// critic, fused FFN and shallow conv kernels use, for the
// tests/test_torch_*_emulated.py files: blocks run
// one after another; the threads of a block run as std::threads that meet
// at __syncthreads (a std::barrier); __shared__ arrays become function
// statics, which all threads of the running block share; dynamic shared
// memory is one buffer filled with NaN at each launch.  Compiled with
// g++ -std=c++20 after the test rewrites `kernel<<<...>>>(args)` into
// emu_launch(kernel, ..., args) and `extern __shared__ ... name[];` into a
// pointer to that buffer.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>

using std::fmaf;
using std::fmaxf;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline std::barrier<>* emu_bar = nullptr;
inline std::vector<float> emu_dyn;

inline float* emu_dyn_smem() { return emu_dyn.data(); }
// the round-to-nearest product and sum, never contracted into an FMA
inline float __fmul_rn(float a, float b) {
  volatile float p = a * b;
  return p;
}
inline float __fadd_rn(float a, float b) {
  volatile float s = a + b;
  return s;
}
inline void __syncthreads() { emu_bar->arrive_and_wait(); }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                A... args) {
  gridDim = grid;
  blockDim = block;
  emu_dyn.assign(smem / sizeof(float) + 16, std::nanf(""));
  const unsigned n = block.x * block.y * block.z;
  std::barrier<> bar(n);
  emu_bar = &bar;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                       t / (block.x * block.y));
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; ++bx) {
            blockIdx = dim3(bx, by, bz);
            kernel(args...);
            bar.arrive_and_wait();  // the block's statics are free again
          }
    });
  for (auto& t : threads) t.join();
}
