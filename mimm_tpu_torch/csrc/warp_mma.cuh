// The warp-level primitives of the bfloat16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu), the bfloat16 fused FFN
// forward (fused_ffn_fwd.cu) and the pairwise critic backward
// (pairwise_critic_bwd.cu), each behind a small device function:
// bf16 packing, the tensor-core products mma.sync m16n8k16 (bf16 x bf16,
// f32 accumulation) and m16n8k8 (tf32 x tf32, f32 accumulation), the
// float32 -> tf32 rounding, ldmatrix from shared memory, cp.async and its
// waits, the lane shuffle and the base-2 exponential.  tests/cuda_cpu/cuda_runtime.h defines
// CUDA_CPU_STANDIN and gives a CPU version of each (the PTX ISA's fragment
// tables), so the kernels' indexing can be checked without a card.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), g = lane / 4, t = lane % 4, two bf16 per 32-bit register,
// the lower index in the lower half:
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..2t+1),
//                           a[2] = (g, 2t+8..), a[3] = (g+8, 2t+8..)
//   B (16 x 8, k x n):      b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g)
//   C, D (16 x 8, f32):     c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..)
// So the accumulators of two neighbouring n8 tiles, rounded and packed in
// pairs, are the A fragment of the next product: a probability tile never
// leaves the registers.
//
// mma.m16n8k8 with .tf32 (PTX ISA, "Matrix Fragments for mma.m16n8k8"),
// one tf32 (a float32 whose low 13 bits are ignored) per register:
//   A (16 x 8, row-major): a[0] = (g, t), a[1] = (g+8, t), a[2] = (g, t+4),
//                          a[3] = (g+8, t+4)
//   B (8 x 8, k x n):      b[0] = (k t, n g), b[1] = (k t+4, n g)
//   C, D (16 x 8, f32):    as for m16n8k16.
// 3xTF32 (mma_step): each float32 operand x is split as hi = rna(x),
// lo = rna(x − hi), both tf32, and a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b
// in f32; only lo·lo (~2^-22 relative) is dropped, so the product keeps
// about float32's accuracy at a third of the TF32 tensor-core rate.

#pragma once

#ifndef CUDA_CPU_STANDIN

// two floats rounded to bf16 (nearest even), x in the lower half
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(y), "f"(x));
  return d;
}

// d = a·b + d, a 16 x 16 and b 16 x 8 in bf16, d 16 x 8 in f32
__device__ __forceinline__ void mma_bf16_16816(float d[4], const unsigned a[4],
                                               const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// float32 -> tf32, round to nearest with ties away from zero; the tf32 in
// the upper 19 bits of the result, zeros below
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned d;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(d) : "f"(x));
  return d;
}

// d = a·b + d, a 16 x 8 and b 8 x 8 in tf32, d 16 x 8 in f32
__device__ __forceinline__ void mma_tf32_1688(float d[4], const unsigned a[4],
                                              const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] is matrix i's element (lane/4, 2(lane%4)..+1)
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed: r[i] holds elements (2(lane%4)..+1,
// lane/4) of the stored matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// !valid (the source is then not read)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes likewise, for rows whose length is no multiple of 4 floats
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n committed groups of this thread are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// 2^x (MUFU.EX2, ~2 ulp); 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float shfl_xor(float x, int m) {
  return __shfl_xor_sync(0xffffffffu, x, m);
}

__device__ __forceinline__ unsigned shfl_xor(unsigned x, int m) {
  return __shfl_xor_sync(0xffffffffu, x, m);
}

#endif  // CUDA_CPU_STANDIN

// x = hi + lo (up to 2^-22 relative), both tf32
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// acc[mt][nt] += A(16mt .. 16mt+15, 0..7) · B(0..7, 8nt .. 8nt+7): one
// k-step of a warp's (16·MT) × (8·NT) tile in 3xTF32.  fa(m, k, hi, lo)
// and fb(k, n, hi, lo) give an operand element's tf32 parts (split as
// loaded, or split once when staged).  An operand that is exact in tf32
// (A_EXACT, B_EXACT: lo = 0) drops the product its lo would enter.  Each
// of the products runs over all tiles in turn: MT·NT independent mmas
// between two that add into one accumulator.
template <int MT, int NT, bool A_EXACT, bool B_EXACT, class FA, class FB>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], FA fa,
                                         FB fb, int lane) {
  const int g = lane / 4, t = lane % 4;
  unsigned ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    fa(16 * mt + g, t, ah[mt][0], al[mt][0]);
    fa(16 * mt + g + 8, t, ah[mt][1], al[mt][1]);
    fa(16 * mt + g, t + 4, ah[mt][2], al[mt][2]);
    fa(16 * mt + g + 8, t + 4, ah[mt][3], al[mt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    fb(t, 8 * nt + g, bh[nt][0], bl[nt][0]);
    fb(t + 4, 8 * nt + g, bh[nt][1], bl[nt][1]);
  }
  if (!A_EXACT) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32_1688(acc[mt][nt], al[mt], bh[nt]);
  }
  if (!B_EXACT) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32_1688(acc[mt][nt], ah[mt], bl[nt]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32_1688(acc[mt][nt], ah[mt], bh[nt]);
}
