// Hopper's warpgroup tensor-core product in TF32 at float32 accuracy, for
// the pairwise critic's pair products (pairwise_critic_fwd.cu; meant to
// carry over to the backward's z2 recompute): each float32 operand split
// into two tf32 parts (warp_mma.cuh split_tf32) and three wgmma.mma_async
// a product, lo_a·hi_b + hi_a·lo_b + hi_a·hi_b (3xTF32; only lo·lo, ~2^-22
// relative, is dropped).
//
// The pieces:
//   * wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 with A (64 x 8)
//     from registers and B (8 x 256) from shared memory through a matrix
//     descriptor, and its fence, commit and wait (PTX ISA, "Asynchronous
//     Warpgroup Level Matrix Multiply-Accumulate").  For .tf32 both
//     operands are K-major (no transpose), so B is stored as 256 rows (n)
//     of K.  A register fragment, warp w of the warpgroup holding rows 16w
//     .. 16w + 15, g = lane / 4, t = lane % 4: a[0] = (g, t), a[1] = (g+8,
//     t), a[2] = (g, t+4), a[3] = (g+8, t+4), as mma.m16n8k8's.  The
//     accumulator: d[4j + e] = row 16w + g + 8(e / 2), column 8j + 2t + e % 2.
//   * The B operand's image: a weight W (K x N, row-major float32) split
//     once per launch by image_kernel into stages of STAGE_K = 16 rows of K
//     by TILE_N = 256 columns, a stage being its hi tile and its lo tile
//     (16 KB each) as wgmma reads them from shared memory: K-major, rows
//     of 16 tf32 (64 bytes), 8-row groups 512 bytes apart, in the 64-byte
//     swizzle (the 16-byte chunk c of byte offset o stored at c ^ ((o >>
//     7) & 3)), so a stage is one contiguous cp.async.bulk.  Within a
//     stage, the wgmma of step kk (0, 1) takes at its column c (0..7) the
//     row stage_k(8kk + c) = 4(c % 4) + 2kk + c / 4: then a thread's A
//     values for a stage are 4 consecutive k of each of its two rows (k =
//     4t .. 4t + 3), one 16-byte load each.
//   * from hopper.cuh: mbarrier init, arrive, arrive.expect_tx and the
//     parity wait, cp.async.bulk from global to shared memory completed on
//     an mbarrier (no tensor map: the image is already laid out), and
//     wgmma's fence, commit and wait.
//
// tests/cuda_cpu/cuda_runtime.h defines CUDA_CPU_STANDIN and gives a CPU
// version of each PTX wrapper below (the descriptor decoded from the PTX
// ISA's layout, the 128 lanes of a warpgroup meeting to gather A).
#pragma once

#include <cstdint>

#include "hopper.cuh"
#include "warp_mma.cuh"

#ifndef CUDA_CPU_STANDIN

// d += A·B, A (64 x 8 tf32) from this thread's fragment a, B (8 x 256 tf32)
// by the descriptor desc_b
__device__ __forceinline__ void wgmma_m64n256k8_tf32(float (&d)[128],
                                                     const unsigned (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#endif  // CUDA_CPU_STANDIN

namespace wgmma_tf32 {

constexpr int TILE_N = 256;                // columns of B a wgmma
constexpr int STAGE_K = 16;                // rows of K a stage: two k8 steps
constexpr int TILE = TILE_N * STAGE_K;     // floats of a hi or lo tile
constexpr int STAGE = 2 * TILE;            // floats of a stage: hi, lo
constexpr unsigned STAGE_BYTES = 4u * STAGE;

// the row of K within a stage that column q % 8 of step q / 8 takes
__host__ __device__ constexpr int stage_k(int q) {
  return 4 * (q % 4) + 2 * (q / 8) + (q % 8) / 4;
}

// float offset of (n, q) in a tile: K-major, 64-byte rows, 64-byte swizzle
__host__ __device__ constexpr int tile_offset(int n, int q) {
  return ((n * 64 + q * 4) ^ ((((n * 64 + q * 4) >> 7) & 3) << 4)) >> 2;
}

// the descriptor of a tile (its 512-byte aligned start, or that start plus
// 32 bytes: step 1) for wgmma: start address >> 4, leading byte offset 1
// (unused in a swizzled K-major layout), stride byte offset 512 >> 4 (the
// next 8 rows), layout 2 (64-byte swizzle) in bits 62-63
__device__ __forceinline__ uint64_t desc_sw64(const float* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// w (k_dim x n_dim, row-major float32) into `image`: for pass p (256
// columns) and stage s (16 rows of K), stage p·kstages + s holds the hi
// tile and then the lo tile of W[16s + stage_k(q)][256p + n] at
// tile_offset(n, q); zeros past k_dim and n_dim.  One thread an element.
__global__ void image_kernel(const float* __restrict__ w,
                             float* __restrict__ image, int k_dim, int n_dim,
                             int kstages, int stages) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= (long long)stages * TILE) return;
  const int n = (int)(v % TILE_N), q = (int)(v / TILE_N % STAGE_K);
  const int st = (int)(v / TILE);
  const int k = STAGE_K * (st % kstages) + stage_k(q);
  const int col = TILE_N * (st / kstages) + n;
  const float x = k < k_dim && col < n_dim ? w[(size_t)k * n_dim + col] : 0.f;
  unsigned hi, lo;
  split_tf32(x, hi, lo);
  float* dst = image + (size_t)st * STAGE;
  dst[tile_offset(n, q)] = __uint_as_float(hi);
  dst[TILE + tile_offset(n, q)] = __uint_as_float(lo);
}

// A's fragments for a stage from this thread's values v[h][e]: row g + 8h
// of its warp's 16, stage row 4t + e; hi, lo[kk] for step kk
__device__ __forceinline__ void split_a(const float (&v)[2][4],
                                        unsigned (&hi)[2][4],
                                        unsigned (&lo)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    split_tf32(v[0][2 * kk], hi[kk][0], lo[kk][0]);
    split_tf32(v[1][2 * kk], hi[kk][1], lo[kk][1]);
    split_tf32(v[0][2 * kk + 1], hi[kk][2], lo[kk][2]);
    split_tf32(v[1][2 * kk + 1], hi[kk][3], lo[kk][3]);
  }
}

// acc += A (64 x 16) · B (16 x 256) in 3xTF32, B the stage at `stage` in
// shared memory; the small products first, as warp_mma.cuh mma_step
__device__ __forceinline__ void mma_stage(float (&acc)[128],
                                          const unsigned (&hi)[2][4],
                                          const unsigned (&lo)[2][4],
                                          const float* stage) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint64_t bh = desc_sw64(stage + 8 * kk);
    const uint64_t bl = desc_sw64(stage + TILE + 8 * kk);
    wgmma_m64n256k8_tf32(acc, lo[kk], bh);
    wgmma_m64n256k8_tf32(acc, hi[kk], bl);
    wgmma_m64n256k8_tf32(acc, hi[kk], bh);
  }
}

}  // namespace wgmma_tf32
