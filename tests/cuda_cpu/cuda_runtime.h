// A CPU stand-in for the subset of the CUDA runtime that the pairwise
// critic, fused FFN, shallow conv and flash-attention kernels use, for the
// tests/test_torch_*_emulated.py files: blocks run one after another; the
// threads of a block run as cooperative fibers (each with a stack of its
// own) on the launching thread, and a fiber runs until it waits at a
// barrier, then hands over to the next one in turn; __shared__ arrays
// become function statics, which all threads of the running block share;
// dynamic shared memory is one buffer (1024-byte aligned) filled with NaN
// at each launch.  So the emulation is deterministic and its time does not
// grow with the host's load.  The warp-level primitives of
// mimm_tpu_torch/csrc/warp_mma.cuh (shuffles, ldmatrix, mma.sync m16n8k16
// bf16 and m16n8k8 tf32, cvt.rna.tf32.f32, cp.async, ex2) and the Hopper
// primitives of csrc/hopper.cuh, csrc/wgmma_tf32.cuh and
// csrc/wgmma_bf16.cuh (wgmma.mma_async m64n256k8 tf32 with A from
// registers and B from a shared-memory matrix descriptor, m64n256k16 bf16
// with both operands MN-major by descriptors, its fence and group waits,
// mbarrier, cp.async.bulk, the 2-D TMA tile load in the 128-byte swizzle
// with its tensor map, fence.proxy.async, a warpgroup's named barrier) are
// given here from the PTX ISA's fragment tables and descriptor layout: the
// 32 lanes of a warp (the 128 of a warpgroup) meet at a barrier of their
// own, post their operands, and each lane computes its own result from
// all of them.  cp.async, cp.async.bulk and the TMA load are synchronous
// copies; cp.async's waits, wgmma's fence and waits and the proxy fence
// do nothing (wgmma computes when issued).  Exited threads leave
// the barriers they would have met, as on the card.  The occupancy queries
// answer for a card of 2 SMs holding 2 blocks each.  Compiled with g++
// -std=c++20 after the test rewrites `kernel<<<...>>>(args)` into
// emu_launch(kernel, ..., args) and `extern __shared__ ... name[];` into a
// pointer to that buffer.
#pragma once
#define CUDA_CPU_STANDIN 1
#ifndef __x86_64__
#error "the stand-in's fiber switch is written for x86-64"
#endif
#include <sys/mman.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
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

// ---- cooperative threads ----------------------------------------------------
// The running fiber's indices: plain globals, set on every switch.
inline dim3 threadIdx, blockIdx;
inline unsigned emu_tid;  // linear thread index in the block
inline dim3 gridDim, blockDim;
inline std::vector<float> emu_dyn;
inline float* emu_dyn_base = nullptr;  // 1024-byte aligned, inside emu_dyn

// emu_fiber_switch(save, to): pushes the callee-saved registers, stores the
// stack pointer in *save, loads `to` and pops the same registers from there
// (x86-64 System V).  A new fiber's stack holds zeros for those registers
// and then the address of emu_fiber_entry.
extern "C" void emu_fiber_switch(void** save, void* to);
asm(R"(
  .text
  .p2align 4
  .hidden emu_fiber_switch
  .globl emu_fiber_switch
  .type emu_fiber_switch, @function
emu_fiber_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_fiber_switch, .-emu_fiber_switch
)");

constexpr size_t EMU_STACK = 1 << 20;  // bytes a fiber; pages come on use
struct EmuFiber {
  void* sp = nullptr;
  char* stack = nullptr;  // mmap'd, its lowest page a guard
  bool done = true;
  ~EmuFiber() {
    if (stack) munmap(stack, EMU_STACK);
  }
};
inline std::vector<std::unique_ptr<EmuFiber>> emu_fibers;
inline unsigned emu_live = 0;     // fibers of this block not yet done
inline unsigned emu_cur = 0;      // the running fiber
inline void* emu_main_sp = nullptr;
inline std::function<void()> emu_body;  // the kernel call of this launch
inline unsigned long long emu_idle = 0;  // yields since the last progress

inline void emu_enter(unsigned t) {
  emu_cur = t;
  emu_tid = t;
  threadIdx = dim3(t % blockDim.x, (t / blockDim.x) % blockDim.y,
                   t / (blockDim.x * blockDim.y));
}

// hand over to the next fiber that is not done, in turn; back here when
// some fiber hands over to this one
inline void emu_yield() {
  if (++emu_idle > (1ull << 28)) {
    std::fprintf(stderr, "cuda_cpu: the threads of block (%u, %u, %u) wait "
                 "for each other forever\n", blockIdx.x, blockIdx.y,
                 blockIdx.z);
    std::abort();
  }
  const unsigned n = (unsigned)emu_fibers.size(), from = emu_cur;
  unsigned to = from;
  do to = (to + 1) % n;
  while (emu_fibers[to]->done && to != from);
  if (to == from) return;
  emu_enter(to);
  emu_fiber_switch(&emu_fibers[from]->sp, emu_fibers[to]->sp);
}

// A barrier of `expected` threads; a thread that exits leaves it (leave()).
struct EmuBarrier {
  unsigned expected = 0, count = 0, gen = 0;
  void complete() {
    count = 0;
    ++gen;
    emu_idle = 0;
  }
  void arrive_and_wait() {
    const unsigned g = gen;
    if (++count == expected) return complete();
    while (gen == g) emu_yield();
  }
  void leave() {
    --expected;
    if (count && count == expected) complete();
  }
};
inline EmuBarrier emu_block_bar;

// A team of lanes that post their operands and read everyone's: the 32
// lanes of a warp, or the 128 of a warpgroup.  Two slots in turn, so one
// barrier a gather: a lane posts into a slot again only after every lane
// has passed the next barrier, that is, after all have read it.
template <int LANES, int BYTES>
struct EmuTeam {
  EmuBarrier bar;
  unsigned calls[LANES] = {};
  alignas(16) unsigned char slot[2][LANES][BYTES];
  template <typename T>
  void gather(unsigned lane, const T& mine, T (&all)[LANES]) {
    static_assert(sizeof(T) <= BYTES, "one slot a lane");
    const unsigned s = calls[lane]++ & 1u;
    std::memcpy(slot[s][lane], &mine, sizeof(T));
    bar.arrive_and_wait();
    for (int i = 0; i < LANES; ++i) std::memcpy(&all[i], slot[s][i], sizeof(T));
  }
};
using EmuWarp = EmuTeam<32, 64>;
using EmuGroup = EmuTeam<128, 16>;
inline std::vector<std::unique_ptr<EmuWarp>> emu_warps;
inline std::vector<std::unique_ptr<EmuGroup>> emu_groups;

extern "C" inline void emu_fiber_entry() {
  emu_body();
  emu_fibers[emu_cur]->done = true;
  --emu_live;
  emu_block_bar.leave();
  emu_warps[emu_tid / 32]->bar.leave();
  emu_groups[emu_tid / 128]->bar.leave();
  emu_idle = 0;
  static void* dead_sp;  // this fiber's last stack pointer, never resumed
  if (emu_live == 0) emu_fiber_switch(&dead_sp, emu_main_sp);
  unsigned to = emu_cur;
  do to = (to + 1) % (unsigned)emu_fibers.size();
  while (emu_fibers[to]->done);
  emu_enter(to);
  emu_fiber_switch(&dead_sp, emu_fibers[to]->sp);
}

inline float* emu_dyn_smem() { return emu_dyn_base; }
// the round-to-nearest product and sum, never contracted into an FMA
inline float __fmul_rn(float a, float b) {
  volatile float p = a * b;
  return p;
}
inline float __fadd_rn(float a, float b) {
  volatile float s = a + b;
  return s;
}
inline void __syncthreads() { emu_block_bar.arrive_and_wait(); }
inline void __syncwarp(unsigned = ~0u) {
  emu_warps[emu_tid / 32]->bar.arrive_and_wait();
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((uint64_t)a * b) >> 32);
}
inline float __expf(float x) { return std::exp(x); }
template <typename T>
T __ldg(const T* p) {
  return *p;
}
template <typename T>
void __stcs(T* p, T v) {  // the streaming hint is the card's business
  *p = v;
}

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

// ---- warp-level primitives -------------------------------------------------
inline unsigned emu_lane() { return emu_tid % 32; }

// every lane posts `mine`; all[i] is lane i's
template <typename T>
void emu_warp_gather(const T& mine, T (&all)[32]) {
  emu_warps[emu_tid / 32]->gather(emu_lane(), mine, all);
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
// ---- Hopper: mbarrier, cp.async.bulk, wgmma tf32 (csrc/hopper.cuh,
// csrc/wgmma_tf32.cuh) --------------------------------------------------------
// A shared-memory address is the offset from the dynamic shared memory's
// base; the kernels that take one keep their operands there.
inline unsigned smem_addr(const void* p) {
  const ptrdiff_t off = static_cast<const char*>(p) -
                        reinterpret_cast<const char*>(emu_dyn_base);
  if (off < 0 || (size_t)off >= emu_dyn.size() * sizeof(float)) {
    std::fprintf(stderr, "cuda_cpu: a shared-memory address outside the "
                 "dynamic shared memory\n");
    std::abort();
  }
  return (unsigned)off;
}

// an mbarrier's 8 bytes: the copies' bytes still to come, the arrivals
// still to come, and the expected count with the phase in its top bit
struct EmuMbar {
  int32_t tx;
  uint16_t pending;
  uint16_t count_phase;
};
static_assert(sizeof(EmuMbar) == 8, "an mbarrier is 8 bytes");
inline EmuMbar& emu_mbar(uint64_t* bar) {
  return *reinterpret_cast<EmuMbar*>(bar);
}
inline void emu_mbar_step(EmuMbar& m) {
  if (m.pending == 0 && m.tx == 0) {
    m.count_phase ^= 0x8000u;
    m.pending = m.count_phase & 0x7FFFu;
    emu_idle = 0;
  }
}
inline void mbar_init(uint64_t* bar, unsigned count) {
  emu_mbar(bar) = EmuMbar{0, (uint16_t)count, (uint16_t)count};
}
inline void fence_mbar_init() {}
inline void mbar_arrive(uint64_t* bar) {
  --emu_mbar(bar).pending;
  emu_mbar_step(emu_mbar(bar));
}
inline void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  emu_mbar(bar).tx += (int32_t)bytes;
  mbar_arrive(bar);
}
// until the phase of parity `parity` has completed: the current one's
// parity is another
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  while ((emu_mbar(bar).count_phase >> 15) == parity) emu_yield();
}
inline void bulk_copy_g2s(void* dst, const void* src, unsigned bytes,
                          uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  emu_mbar(bar).tx -= (int32_t)bytes;
  emu_mbar_step(emu_mbar(bar));
}

inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int n>
void wgmma_wait() {}
inline void wgmma_fence_acc(float (&)[128]) {}

// element (row r, column k) of a K-major operand tile by its shared-memory
// matrix descriptor (PTX ISA, "Matrix Descriptor Format"): start address,
// leading and stride byte offsets in 16-byte units in bits 0-13, 16-29 and
// 32-45, the base offset in bits 49-51 (0 here), the layout in 62-63
// (0 none: 8 x 16-byte core matrices; 1, 2, 3: 128-, 64-, 32-byte swizzle,
// the 16-byte chunk bits 4.. of the address XOR'd with bits 7..); as tf32,
// its low 13 bits ignored
inline float emu_desc_tf32(uint64_t desc, int r, int k) {
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  const unsigned mode = (unsigned)(desc >> 62);
  if ((desc >> 49) & 7) {
    std::fprintf(stderr, "cuda_cpu: a descriptor base offset is not 0\n");
    std::abort();
  }
  uint32_t addr;
  if (mode == 0) {
    addr = start + (r / 8) * sbo + (k / 4) * lbo + (r % 8) * 16 + (k % 4) * 4;
  } else {
    const unsigned bits = 4 - mode;  // chunks a row: 8, 4, 2
    addr = start + (r / 8) * sbo + (r % 8) * (16u << bits) + k * 4;
    addr ^= ((addr >> 7) & ((1u << bits) - 1)) << 4;
  }
  unsigned u;
  std::memcpy(&u, reinterpret_cast<const char*>(emu_dyn_base) + addr, 4);
  return __uint_as_float(u & ~0x1FFFu);
}

// wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32, A from registers,
// d += A·B: the products of tf32 values are exact in float32; each lane
// sums its 8 in k order and adds the sum to d
inline void wgmma_m64n256k8_tf32(float (&d)[128], const unsigned (&a)[4],
                                 uint64_t desc_b) {
  struct Frag {
    unsigned a[4];
  } mine{{a[0], a[1], a[2], a[3]}}, all[128];
  emu_groups[emu_tid / 128]->gather(emu_tid % 128, mine, all);
  float A[64][8];
  for (int l = 0; l < 128; ++l) {
    const int r = 16 * (l / 32) + (l % 32) / 4, t = l % 4;
    A[r][t] = __uint_as_float(all[l].a[0] & ~0x1FFFu);
    A[r + 8][t] = __uint_as_float(all[l].a[1] & ~0x1FFFu);
    A[r][t + 4] = __uint_as_float(all[l].a[2] & ~0x1FFFu);
    A[r + 8][t + 4] = __uint_as_float(all[l].a[3] & ~0x1FFFu);
  }
  const int l = emu_tid % 128;
  const int r = 16 * (l / 32) + (l % 32) / 4, t = l % 4;
  for (int j = 0; j < 32; ++j)
    for (int c = 0; c < 2; ++c) {
      const int n = 8 * j + 2 * t + c;
      float b[8];
      for (int k = 0; k < 8; ++k) b[k] = emu_desc_tf32(desc_b, n, k);
      for (int h = 0; h < 2; ++h) {
        float acc = 0.f;
        for (int k = 0; k < 8; ++k) acc += A[r + 8 * h][k] * b[k];
        d[4 * j + 2 * h + c] += acc;
      }
    }
}

// ---- Hopper: TMA tensor maps and wgmma bf16 (csrc/hopper.cuh,
// csrc/wgmma_bf16.cuh) -------------------------------------------------------
// A tensor map of the stand-in's own: the matrix and its box; the card's is
// an opaque 128 bytes from cuTensorMapEncodeTiled.
#define __grid_constant__
struct alignas(64) CUtensorMap {
  const unsigned char* base;
  int rows, cols, box_rows;
};
inline int tmap_2d_bf16(CUtensorMap* map, const void* base, int rows,
                        int cols, int box_rows) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || rows < 1 || cols < 1 ||
      cols % 8 || box_rows < 1 || box_rows > 256)
    return (int)cudaErrorInvalidValue;
  *map = CUtensorMap{static_cast<const unsigned char*>(base), rows, cols,
                     box_rows};
  return 0;
}
// the box (box_rows x 64 bf16 at column col, row row) into shared memory
// at dst in the 128-byte swizzle: element (r, c) at byte r·128 + 2c of the
// box, the 16-byte chunk bits 4-6 of the address XOR'd with its bits 7-9;
// zeros past the matrix's edges
inline void tma_load_2d(void* dst, const CUtensorMap* map, int col, int row,
                        uint64_t* bar) {
  const unsigned at = smem_addr(dst);
  if (at % 1024) {
    std::fprintf(stderr, "cuda_cpu: a 128-byte-swizzled TMA box at a "
                 "shared-memory address that is not 1024-byte aligned\n");
    std::abort();
  }
  unsigned char* smem = reinterpret_cast<unsigned char*>(emu_dyn_base);
  for (int r = 0; r < map->box_rows; ++r)
    for (int c = 0; c < 64; ++c) {
      const long long gr = (long long)row + r, gc = (long long)col + c;
      uint16_t v = 0;
      if (gr >= 0 && gr < map->rows && gc >= 0 && gc < map->cols)
        std::memcpy(&v, map->base + 2 * (gr * map->cols + gc), 2);
      unsigned o = at + 128 * r + 2 * c;
      o ^= ((o >> 7) & 7) << 4;
      std::memcpy(smem + o, &v, 2);
    }
  emu_mbar(bar).tx -= map->box_rows * 128;
  emu_mbar_step(emu_mbar(bar));
}
inline void fence_proxy_async() {}
// the stand-in's named barriers are the warpgroups' own
inline void named_bar_sync(int, int count) {
  if (count != 128) {
    std::fprintf(stderr, "cuda_cpu: a named barrier of %d threads (the "
                 "stand-in gives one of a warpgroup's 128)\n", count);
    std::abort();
  }
  emu_groups[emu_tid / 128]->bar.arrive_and_wait();
}

// element (mn, k) of an MN-major 16-bit operand by its descriptor (PTX
// ISA, "Matrix Descriptor Format"; CUTLASS's canonical MN-major layouts)
// in a swizzled layout (1, 2, 3: 128-, 64-, 32-byte rows of W = 64, 32, 16
// elements): row k of a panel of W columns at (k / 8)·SBO + (k % 8)·2W
// bytes, panels LBO apart, then the swizzle of the address; as bf16
inline float emu_desc_mn_bf16(uint64_t desc, int mn, int k) {
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  const unsigned mode = (unsigned)(desc >> 62);
  if (((desc >> 49) & 7) || mode == 0) {
    std::fprintf(stderr, "cuda_cpu: an MN-major descriptor with a base "
                 "offset or no swizzle (not emulated)\n");
    std::abort();
  }
  const unsigned bits = 4 - mode, w = 8u << bits;
  uint32_t addr = start + (mn / w) * lbo + (k / 8) * sbo + (k % 8) * 2 * w +
                  (mn % w) * 2;
  addr ^= ((addr >> 7) & ((1u << bits) - 1)) << 4;
  uint16_t u;
  std::memcpy(&u, reinterpret_cast<const char*>(emu_dyn_base) + addr, 2);
  return emu_bf16(u);
}

// wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 with both operands
// MN-major (the transpose bits set), d += A·B: the 128 lanes check that
// they give one pair of descriptors; the products of bf16 values are exact
// in float32, each lane sums its 16 in k order and adds the sum to d
inline void wgmma_m64n256k16_bf16_mn(float (&d)[128], uint64_t desc_a,
                                     uint64_t desc_b) {
  struct Descs {
    uint64_t a, b;
  } mine{desc_a, desc_b}, all[128];
  emu_groups[emu_tid / 128]->gather(emu_tid % 128, mine, all);
  for (int l = 0; l < 128; ++l)
    if (all[l].a != desc_a || all[l].b != desc_b) {
      std::fprintf(stderr, "cuda_cpu: the lanes of a warpgroup give a wgmma "
                   "different descriptors\n");
      std::abort();
    }
  const int l = emu_tid % 128;
  const int r = 16 * (l / 32) + (l % 32) / 4, t = l % 4;
  float A[2][16];
  for (int h = 0; h < 2; ++h)
    for (int k = 0; k < 16; ++k) A[h][k] = emu_desc_mn_bf16(desc_a, r + 8 * h, k);
  for (int j = 0; j < 32; ++j)
    for (int c = 0; c < 2; ++c) {
      const int n = 8 * j + 2 * t + c;
      float b[16];
      for (int k = 0; k < 16; ++k) b[k] = emu_desc_mn_bf16(desc_b, n, k);
      for (int h = 0; h < 2; ++h) {
        float acc = 0.f;
        for (int k = 0; k < 16; ++k) acc += A[h][k] * b[k];
        d[4 * j + 2 * h + c] += acc;
      }
    }
}

#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// The stand-in's card: 2 SMs that hold 2 blocks of any kernel each, so a
// grid sized to one wave of the card has 4 blocks.
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 2;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int,
                                                          size_t) {
  *blocks = 2;
  return cudaSuccess;
}

template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                A... args) {
  gridDim = grid;
  blockDim = block;
  emu_dyn.assign(smem / sizeof(float) + 256 + 16, std::nanf(""));
  emu_dyn_base = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(emu_dyn.data()) + 1023) & ~uintptr_t(1023));
  const unsigned n = block.x * block.y * block.z;
  while (emu_fibers.size() < n) {
    auto f = std::make_unique<EmuFiber>();
    void* m = mmap(nullptr, EMU_STACK, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (m == MAP_FAILED) std::abort();
    f->stack = static_cast<char*>(m);
    mprotect(f->stack, 4096, PROT_NONE);
    emu_fibers.push_back(std::move(f));
  }
  emu_fibers.resize(n);
  emu_body = [&] { kernel(args...); };
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = dim3(bx, by, bz);
        emu_block_bar = EmuBarrier{n};
        emu_warps.clear();
        for (unsigned w = 0; w * 32 < n; ++w) {
          emu_warps.push_back(std::make_unique<EmuWarp>());
          emu_warps.back()->bar.expected = std::min(32u, n - 32 * w);
        }
        emu_groups.clear();
        for (unsigned w = 0; w * 128 < n; ++w) {
          emu_groups.push_back(std::make_unique<EmuGroup>());
          emu_groups.back()->bar.expected = std::min(128u, n - 128 * w);
        }
        for (auto& f : emu_fibers) {  // zeros for the six registers, then
          void** top = reinterpret_cast<void**>(f->stack + EMU_STACK);
          top[-1] = nullptr;          // the entry's own return address
          top[-2] = reinterpret_cast<void*>(&emu_fiber_entry);
          for (int r = 3; r <= 8; ++r) top[-r] = nullptr;
          f->sp = top - 8;
          f->done = false;
        }
        emu_live = n;
        emu_idle = 0;
        emu_enter(0);
        emu_fiber_switch(&emu_main_sp, emu_fibers[0]->sp);
      }
  emu_body = nullptr;
}
