// Hopper's warpgroup tensor-core product in bfloat16 with both operands in
// shared memory, MN-major, for products summed over the rows of two
// row-major matrices (the fused FFN's weight gradients, fused_ffn_bwd.cu:
// dw1 = dhᵀ·x, dw2 = (gᵀ·dy)ᵀ, the sum over the T token rows).
//
//   * wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16, D (64 x 256,
//     f32) += A (64 x 16) · B (16 x 256), A and B both by shared-memory
//     matrix descriptors with the transpose bits set (PTX ISA,
//     "Asynchronous Warpgroup Level Matrix Multiply-Accumulate"): each
//     operand is stored MN-major, its M (or N) index contiguous, so a tile
//     of T rows of a row-major (T, M) matrix is the operand as it lies in
//     memory and no transposed copy is made.  The accumulator, warp w of
//     the warpgroup, g = lane / 4, t = lane % 4: d[4j + e] = row 16w + g +
//     8(e / 2), column 8j + 2t + e % 2 (as the tf32 product's,
//     wgmma_tf32.cuh).
//   * The operand tile, as a 2-D TMA box of BK rows by 64 columns lands in
//     the 128-byte swizzle (hopper.cuh tma_load_2d, tmap_2d_bf16): a
//     "panel" of 64 columns is BK rows of 128 bytes, the 16-byte chunk c of
//     row r stored at chunk c ^ (r % 8), panels BK·128 bytes apart.  In the
//     descriptor's terms (CUTLASS's canonical MN-major SW128 layout,
//     ((8 elements, 8 chunks, panels), (8 rows, row groups)) : ((1, 8,
//     LBO), (64, SBO)) in elements): the leading byte offset is the
//     distance between panels, the stride byte offset between groups of 8
//     rows (1024), layout 1 (128-byte swizzle) in bits 62-63.  Step kk of
//     a 64-row stage starts 16·kk rows (2048 bytes) in; every start stays
//     1024-byte aligned, so the base offset is 0.
//
// tests/cuda_cpu/cuda_runtime.h defines CUDA_CPU_STANDIN and gives a CPU
// version of the product (both descriptors decoded from the same layout).
#pragma once

#include <cstdint>

#include "hopper.cuh"

namespace wgmma_bf16 {

constexpr int PANEL = 64;                 // columns of a panel: 128 bytes
constexpr unsigned ROW_BYTES = 2 * PANEL;

// the descriptor of the MN-major operand whose first panel starts at
// `tile` (1024-byte aligned), its panels `panel_bytes` apart
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* tile,
                                                  unsigned panel_bytes) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)((panel_bytes & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

}  // namespace wgmma_bf16

#ifndef CUDA_CPU_STANDIN

// d += A·B, A (64 x 16) and B (16 x 256) bf16, both MN-major by their
// descriptors
__device__ __forceinline__ void wgmma_m64n256k16_bf16_mn(float (&d)[128],
                                                         uint64_t desc_a,
                                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
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
      "}, %128, %129, p, 1, 1, 1, 1;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#endif  // CUDA_CPU_STANDIN
