// A CPU stand-in for the subset of the CUDA runtime that the pairwise
// critic, fused FFN, shallow conv and flash-attention kernels use, for the
// tests/test_torch_*_emulated.py files: blocks run
// one after another; the threads of a block run as std::threads that meet
// at __syncthreads (a std::barrier); __shared__ arrays become function
// statics, which all threads of the running block share; dynamic shared
// memory is one buffer filled with NaN at each launch.  The warp-level
// primitives of mimm_tpu_torch/csrc/warp_mma.cuh (shuffles, ldmatrix,
// mma.sync m16n8k16 bf16 and m16n8k8 tf32, cvt.rna.tf32.f32, cp.async, ex2) are given here from the PTX ISA's
// fragment tables: the 32 lanes of a warp meet at a barrier of their own,
// post their operands, and each lane computes its own result from all of
// them.  cp.async is a synchronous copy and its waits do nothing.  Compiled with
// g++ -std=c++20 after the test rewrites `kernel<<<...>>>(args)` into
// emu_launch(kernel, ..., args) and `extern __shared__ ... name[];` into a
// pointer to that buffer.
#pragma once
#define CUDA_CPU_STANDIN 1
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#include "cuda_bf16.h"

using std::fmaf;
using std::fmaxf;
using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline thread_local dim3 threadIdx, blockIdx;
inline thread_local unsigned emu_tid;  // linear thread index in the block
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
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((uint64_t)a * b) >> 32);
}
inline float __expf(float x) { return std::exp(x); }
template <typename T>
T __ldg(const T* p) {
  return *p;
}

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

// ---- warp-level primitives -------------------------------------------------
struct EmuWarp {
  explicit EmuWarp(unsigned lanes) : bar(lanes) {}
  std::barrier<> bar;
  alignas(16) unsigned char slot[32][64];
};
inline std::vector<std::unique_ptr<EmuWarp>> emu_warps;

inline unsigned emu_lane() { return emu_tid % 32; }

// every lane posts `mine`; all[i] is lane i's
template <typename T>
void emu_warp_gather(const T& mine, T (&all)[32]) {
  static_assert(sizeof(T) <= 64, "one slot a lane");
  EmuWarp& w = *emu_warps[emu_tid / 32];
  std::memcpy(w.slot[emu_lane()], &mine, sizeof(T));
  w.bar.arrive_and_wait();
  for (int i = 0; i < 32; ++i) std::memcpy(&all[i], w.slot[i], sizeof(T));
  w.bar.arrive_and_wait();  // every lane has read before the next post
}

template <typename T>
T __shfl_xor_sync(unsigned, T x, int m) {
  T all[32];
  emu_warp_gather(x, all);
  return all[emu_lane() ^ (unsigned)m];
}
template <typename T>
T __shfl_up_sync(unsigned, T x, unsigned d) {
  T all[32];
  emu_warp_gather(x, all);
  return emu_lane() >= d ? all[emu_lane() - d] : x;
}
template <typename T>
T __shfl_down_sync(unsigned, T x, unsigned d) {
  T all[32];
  emu_warp_gather(x, all);
  return emu_lane() + d < 32 ? all[emu_lane() + d] : x;
}
inline float shfl_xor(float x, int m) { return __shfl_xor_sync(~0u, x, m); }
inline unsigned shfl_xor(unsigned x, int m) {
  return __shfl_xor_sync(~0u, x, m);
}

inline float emu_bf16(unsigned bits16) {
  const uint32_t u = (bits16 & 0xFFFFu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}

// cvt.rna.tf32.f32: round the low 13 bits to nearest, ties away from zero
// (the sign is apart, so adding half an ulp to the magnitude and cutting
// does it); NaN and inf pass as they are
inline unsigned tf32_rna(float x) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7F800000u) == 0x7F800000u) return u;
  return (u + 0x1000u) & ~0x1FFFu;
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d = a·b + d: the
// products of tf32 values are exact in float32; each lane sums its 8 in k
// order and adds the sum to d
inline void mma_tf32_1688(float d[4], const unsigned a[4],
                          const unsigned b[2]) {
  struct Frag {
    unsigned a[4], b[2];
  } mine{{a[0], a[1], a[2], a[3]}, {b[0], b[1]}}, all[32];
  emu_warp_gather(mine, all);
  float A[16][8], B[8][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    const int rows[4] = {g, g + 8, g, g + 8}, cols[4] = {t, t, t + 4, t + 4};
    for (int r = 0; r < 4; ++r)
      A[rows[r]][cols[r]] = __uint_as_float(all[l].a[r] & ~0x1FFFu);
    B[t][g] = __uint_as_float(all[l].b[0] & ~0x1FFFu);
    B[t + 4][g] = __uint_as_float(all[l].b[1] & ~0x1FFFu);
  }
  const int g = emu_lane() / 4, t = emu_lane() % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2), col = 2 * t + (e % 2);
    float acc = 0.f;
    for (int k = 0; k < 8; ++k) acc += A[row][k] * B[k][col];
    d[e] += acc;
  }
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, d = a·b + d
inline void mma_bf16_16816(float d[4], const unsigned a[4],
                           const unsigned b[2]) {
  struct Frag {
    unsigned a[4], b[2];
  } mine{{a[0], a[1], a[2], a[3]}, {b[0], b[1]}}, all[32];
  emu_warp_gather(mine, all);
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    const unsigned* fa = all[l].a;
    const int rows[4] = {g, g + 8, g, g + 8}, cols[4] = {0, 0, 8, 8};
    for (int r = 0; r < 4; ++r) {
      A[rows[r]][2 * t + cols[r]] = emu_bf16(fa[r]);
      A[rows[r]][2 * t + cols[r] + 1] = emu_bf16(fa[r] >> 16);
    }
    for (int r = 0; r < 2; ++r) {
      B[2 * t + 8 * r][g] = emu_bf16(all[l].b[r]);
      B[2 * t + 8 * r + 1][g] = emu_bf16(all[l].b[r] >> 16);
    }
  }
  const int g = emu_lane() / 4, t = emu_lane() % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2), col = 2 * t + (e % 2);
    float acc = 0.f;
    for (int k = 0; k < 16; ++k) acc += A[row][k] * B[k][col];
    d[e] += acc;
  }
}

// ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: lanes 8i..8i+7 give
// the row addresses of matrix i
inline void emu_ldmatrix_x4(unsigned r[4], const void* p, bool trans) {
  const void* all[32];
  emu_warp_gather(p, all);
  const unsigned lane = emu_lane();
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (!trans) {  // element (lane/4, 2(lane%4) .. +1)
      const uint16_t* row = static_cast<const uint16_t*>(all[8 * i + lane / 4]);
      lo = row[2 * (lane % 4)];
      hi = row[2 * (lane % 4) + 1];
    } else {       // element (2(lane%4) .. +1, lane/4)
      lo = static_cast<const uint16_t*>(all[8 * i + 2 * (lane % 4)])[lane / 4];
      hi = static_cast<const uint16_t*>(
          all[8 * i + 2 * (lane % 4) + 1])[lane / 4];
    }
    r[i] = (unsigned)lo | ((unsigned)hi << 16);
  }
}
inline void ldmatrix_x4(unsigned r[4], const void* p) {
  emu_ldmatrix_x4(r, p, false);
}
inline void ldmatrix_x4_trans(unsigned r[4], const void* p) {
  emu_ldmatrix_x4(r, p, true);
}

inline void cp_async_16(void* dst, const void* src, bool valid) {
  if (valid)
    std::memcpy(dst, src, 16);
  else
    std::memset(dst, 0, 16);
}
inline void cp_async_4(void* dst, const void* src, bool valid) {
  if (valid)
    std::memcpy(dst, src, 4);
  else
    std::memset(dst, 0, 4);
}
inline float fast_exp2(float x) { return std::exp2(x); }
// two floats rounded to bf16 (nearest even), x in the lower half
inline unsigned pack_bf16(float x, float y) {
  return (unsigned)__float2bfloat16(x).bits |
         ((unsigned)__float2bfloat16(y).bits << 16);
}
inline void cp_async_commit() {}
template <int n>
void cp_async_wait() {}
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
  emu_warps.clear();
  for (unsigned w = 0; w * 32 < n; ++w)
    emu_warps.push_back(std::make_unique<EmuWarp>(std::min(32u, n - 32 * w)));
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                       t / (block.x * block.y));
      emu_tid = t;
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
