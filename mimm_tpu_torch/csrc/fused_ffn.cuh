// Shared device code of the fused BERT FFN kernels for Hopper (sm_90a):
// the tanh-GELU and its derivative, the typed loads, the shapes the
// kernels take, and the row-tile kernel of the float32 forward
// (csrc/fused_ffn_fwd.cu) and the float32 backward A (csrc/fused_ffn_bwd.cu);
// in bfloat16 both are the tensor-core kernel of csrc/fused_ffn_tc.cuh.
//
// The row-tile kernel chains two products through shared memory and
// registers.  A block of 256 threads owns BM = 32 rows of the token
// dimension and walks the intermediate width f in chunks of FC = 128
// columns:
//
//   forward (BWD = false), replaces mimm_tpu/ops/fused_ffn.py _fwd_kernel:
//     h[:, c]  = x_tile · w1[:, c] + b1[c]        (stored)
//     g        = gelu_tanh(h)                     (kept in shared memory)
//     y_tile  += g · w2[c, :]                     (in registers)
//   backward A (BWD = true), replaces _bwd_a_kernel:
//     dg       = dy_tile · w2[c, :]ᵀ
//     dh[:, c] = dg ∘ gelu_tanh'(h_saved[:, c])   (stored; shared memory)
//     dx_tile += dh · w1[:, c]ᵀ
//
// The input tile (x or dy, 32 × d) sits in shared memory as f32 for the
// whole block; the (32 × d) output tile is 8 × 2·NJ accumulators a thread
// (d = 128·NJ: 96 at d = 768).  The weights stream through shared memory
// in slices of 32 (first product) and 8 (second product) along the summed
// axis, each slice's global loads issued before the previous slice's
// FMAs.  Nothing of the weights stays resident: every block re-reads both
// matrices once, from L2 after the first blocks (at T = 20480 that is 640
// row tiles × 18.9 MB in f32, 9.4 MB in bf16, of L2 traffic a launch).
//
// The weights are read where torch.nn.Linear keeps them, (out, in)
// row-major: `w1` is intermediate.dense.weight (f, d) and `w2` is
// output.dense.weight (d, f).  The forward therefore reads both along the
// summed axis (4 consecutive elements a thread, transposed into the
// staged slice), the backward along the output axis; no transposed copy of
// a weight is ever made.
//
// All products of this kernel are f32 FMAs on the CUDA cores.  tanhf
// is the precise one: the f32 check against the plain version depends on
// it (no --use_fast_math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace fused_ffn {

constexpr int THREADS = 256;
constexpr int BM = 32;             // rows of a row tile
constexpr int FC = 128;            // columns of f per chunk
constexpr int BK_A = 32;           // slice depth of the first product
constexpr int BK_B = 8;            // slice depth of the second product
constexpr int A_STRIDE = BM + 4;   // [k][row] tiles, padded
constexpr int WA_STRIDE = FC + 4;  // [k][col] slice of the first product
constexpr int WA_STRIDE_T = FC + 2;  // ... where it is stored transposed
constexpr int MAX_NJ = 8;          // d = 128·NJ <= 1024

constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
constexpr float GELU_C = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float h) {
  const float u = SQRT_2_OVER_PI * (h + GELU_C * h * h * h);
  return 0.5f * h * (1.0f + tanhf(u));
}

__device__ __forceinline__ float dgelu_tanh(float h) {
  const float u = SQRT_2_OVER_PI * (h + GELU_C * h * h * h);
  const float t = tanhf(u);
  const float du = SQRT_2_OVER_PI * (1.0f + 3.0f * GELU_C * h * h);
  return 0.5f * (1.0f + t) + 0.5f * h * (1.0f - t * t) * du;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// v rounded to T, as f32: the value a later product sees
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// 4 consecutive elements (16 aligned bytes)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  float4 t;
  t.x = v[0], t.y = v[1], t.z = v[2], t.w = v[3];
  *reinterpret_cast<float4*>(p) = t;
}

// acc[r][2j + c] += Σ_kk a[kk][r] · b[kk][128 j + c]: `a` points at the
// thread's 8 rows of a [k][A_STRIDE] tile, `b` at its first column of a
// [k][b_stride] slice.
template <int NJ, int KN>
__device__ __forceinline__ void fma_slice(float (&acc)[8][2 * NJ],
                                          const float* a, const float* b,
                                          int b_stride) {
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + kk * A_STRIDE);
    const float4 a1 = *reinterpret_cast<const float4*>(a + kk * A_STRIDE + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 bj =
          *reinterpret_cast<const float2*>(b + kk * b_stride + 128 * j);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc[r][2 * j] = fmaf(av[r], bj.x, acc[r][2 * j]);
        acc[r][2 * j + 1] = fmaf(av[r], bj.y, acc[r][2 * j + 1]);
      }
    }
  }
}

template <int NJ>
constexpr size_t row_tile_smem_bytes() {
  constexpr int D = 128 * NJ;
  constexpr int slice = BK_A * WA_STRIDE > BK_B * (D + 4) ? BK_A * WA_STRIDE
                                                           : BK_B * (D + 4);
  return sizeof(float) * (size_t)(D * A_STRIDE + FC * A_STRIDE + slice);
}

// in: x (forward) or dy (backward), (t, d).  wa: the first product's
// weight, wb: the second's (forward: w1 (f, d) then w2 (d, f); backward:
// w2 (d, f) then w1 (f, d)).  b1, b2: the forward's biases.  h_in: the
// backward's saved h (t, f).  out: y or dx (t, d).  mid: h or dh (t, f).
template <int NJ, bool BWD>
__global__ void __launch_bounds__(THREADS)
    row_tile_kernel(const float* __restrict__ in, const float* __restrict__ wa,
                    const float* __restrict__ wb, const float* __restrict__ b1,
                    const float* __restrict__ b2,
                    const float* __restrict__ h_in, float* __restrict__ out,
                    float* __restrict__ mid, int t, int f) {
  constexpr int D = 128 * NJ;
  constexpr int WB_STRIDE = D + 4;
  // 8-byte aligned rows either way; the forward's transposed stores of the
  // first slice meet on 2 banks at FC + 2 and on 4 at FC + 4
  constexpr int WA = BWD ? WA_STRIDE : WA_STRIDE_T;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [D][A_STRIDE]: the input tile, [k][row]
  float* gs = xs + D * A_STRIDE;    // [FC][A_STRIDE]: g or dh of the chunk
  float* ws = gs + FC * A_STRIDE;   // the staged weight slice, [k][col]

  const int tid = threadIdx.x;
  const int ty = tid / 64;          // rows ty*8 .. ty*8+7 of the tile
  const int tx = tid % 64;          // columns tx*2, tx*2+1 (+128 j)
  const int r0 = blockIdx.x * BM;

  // the input tile, transposed to [k][row]; rows past t are zero
  for (int g = tid; g < BM * (D / 4); g += THREADS) {
    const int row = g % BM;
    const int c4 = (g / BM) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + row < t) load4(in + (size_t)(r0 + row) * D + c4, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) xs[(c4 + e) * A_STRIDE + row] = v[e];
  }

  float acc2[8][2 * NJ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 2 * NJ; ++c) acc2[r][c] = 0.f;

  float pa[4][4];    // the first product's next slice, in flight
  float pb[NJ][4];   // the second product's
  // slice [k0, k0 + BK_A) × chunk columns of the first weight
  auto load_a = [&](int c0, int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = tid + THREADS * i;
      if (BWD)  // w2 (d, f): row k, 4 consecutive columns
        load4(wa + (size_t)(k0 + g / 32) * f + c0 + (g % 32) * 4, pa[i]);
      else      // w1 (f, d): row = column n of the chunk, 4 consecutive k;
                // 8 neighbouring threads read 128 consecutive bytes of a row
        load4(wa + (size_t)(c0 + g / 8) * D + k0 + (g % 8) * 4, pa[i]);
    }
  };
  auto store_a = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = tid + THREADS * i;
      if (BWD) {
        store4(ws + (g / 32) * WA + (g % 32) * 4, pa[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ws[((g % 8) * 4 + e) * WA + g / 8] = pa[i][e];
      }
    }
  };
  // slice [c0 + kb, c0 + kb + BK_B) × all d columns of the second weight
  auto load_b = [&](int c0, int kb) {
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int g = tid + THREADS * i;
      if (BWD)  // w1 (f, d): row k, 4 consecutive columns
        load4(wb + (size_t)(c0 + kb + g / (D / 4)) * D + (g % (D / 4)) * 4,
              pb[i]);
      else      // w2 (d, f): row = column n, 4 consecutive k; 2
                // neighbouring threads read 32 consecutive bytes of a row
        load4(wb + (size_t)(g / 2) * f + c0 + kb + (g % 2) * 4, pb[i]);
    }
  };
  auto store_b = [&]() {
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int g = tid + THREADS * i;
      if (BWD) {
        store4(ws + (g / (D / 4)) * WB_STRIDE + (g % (D / 4)) * 4, pb[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ws[((g % 2) * 4 + e) * WB_STRIDE + g / 2] = pb[i][e];
      }
    }
  };

  __syncthreads();
  for (int c0 = 0; c0 < f; c0 += FC) {
    // first product: (32 × d) · (d × 128) into 8 × 2 sums a thread
    float acc1[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc1[r][0] = acc1[r][1] = 0.f;
    load_a(c0, 0);
    for (int k0 = 0; k0 < D; k0 += BK_A) {
      store_a();
      __syncthreads();
      if (k0 + BK_A < D) load_a(c0, k0 + BK_A);
      fma_slice<1, BK_A>(acc1, xs + k0 * A_STRIDE + ty * 8, ws + tx * 2, WA);
      __syncthreads();
    }
    load_b(c0, 0);  // in flight during the epilogue
    // its epilogue: h (or dh) to device memory, g (or dh) to shared memory
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = tx * 2 + c;
      const float bias = BWD ? 0.f : b1[c0 + col];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = ty * 8 + r;
        const bool live = r0 + row < t;
        const size_t at = (size_t)(r0 + row) * f + c0 + col;
        float v;
        if (BWD) {
          v = acc1[r][c] * dgelu_tanh(live ? h_in[at] : 0.f);
          if (live) mid[at] = v;
        } else {
          const float hv = acc1[r][c] + bias;
          if (live) mid[at] = hv;
          v = gelu_tanh(hv);
        }
        gs[col * A_STRIDE + row] = v;
      }
    }
    // second product: (32 × 128) · (128 × d) into the output tile's sums
    for (int kb = 0; kb < FC; kb += BK_B) {
      store_b();
      __syncthreads();  // also orders the writes of gs before its reads
      if (kb + BK_B < FC) load_b(c0, kb + BK_B);
      fma_slice<NJ, BK_B>(acc2, gs + kb * A_STRIDE + ty * 8, ws + tx * 2,
                          WB_STRIDE);
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 128 * j + tx * 2 + c;
      const float bias = BWD ? 0.f : b2[col];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = r0 + ty * 8 + r;
        if (row < t)
          out[(size_t)row * D + col] = acc2[r][2 * j + c] + bias;
      }
    }
}

template <int NJ, bool BWD>
int launch_row_tile(const void* in, const void* wa, const void* wb,
                    const void* b1, const void* b2, const void* h_in,
                    void* out, void* mid, int t, int f, void* stream) {
  constexpr size_t smem = row_tile_smem_bytes<NJ>();
  const cudaError_t err = cudaFuncSetAttribute(
      row_tile_kernel<NJ, BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  row_tile_kernel<NJ, BWD><<<dim3((t + BM - 1) / BM), dim3(THREADS), smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(wa),
      static_cast<const float*>(wb), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(h_in),
      static_cast<float*>(out), static_cast<float*>(mid), t, f);
  return (int)cudaGetLastError();
}

// the shapes every fused FFN kernel takes: d = 128·NJ with 1 <= NJ <=
// MAX_NJ, f a multiple of FC, t·f < 2^31
inline bool shape_ok(int t, int d, int f) {
  return t >= 1 && d >= 128 && d % 128 == 0 && d <= 128 * MAX_NJ &&
         f >= FC && f % FC == 0 && (long long)t * f < (1LL << 31);
}

template <bool BWD>
int dispatch_row_tile(const void* in, const void* wa, const void* wb,
                      const void* b1, const void* b2, const void* h_in,
                      void* out, void* mid, int t, int d, int f,
                      void* stream) {
  if (!shape_ok(t, d, f)) return (int)cudaErrorInvalidValue;
#define MIMM_ROW_TILE_CASE(NJ)                                              \
  case NJ:                                                                  \
    return launch_row_tile<NJ, BWD>(in, wa, wb, b1, b2, h_in, out, mid, t, \
                                    f, stream);
  switch (d / 128) {
    MIMM_ROW_TILE_CASE(1)
    MIMM_ROW_TILE_CASE(2)
    MIMM_ROW_TILE_CASE(3)
    MIMM_ROW_TILE_CASE(4)
    MIMM_ROW_TILE_CASE(5)
    MIMM_ROW_TILE_CASE(6)
    MIMM_ROW_TILE_CASE(7)
    MIMM_ROW_TILE_CASE(8)
  }
#undef MIMM_ROW_TILE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace fused_ffn
