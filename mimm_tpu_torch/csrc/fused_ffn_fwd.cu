// Fused BERT FFN forward for Hopper (sm_90a):
//   h = x·w1 + b1 (f32 sums), saved in the compute type;
//   y = T(gelu_tanh(h_f32))·w2 + b2,
// x (T, d), w1 (d, f), w2 (f, d), in float32 or bfloat16 throughout.
//
// Replaces the TPU kernel mimm_tpu/ops/fused_ffn.py _fwd_kernel (:85,
// pallas_call in _ffn_fwd :161).  What carries over: one pass over x that
// yields y and the saved pre-GELU activation h, with g = gelu(h) never
// written to device memory, every sum in f32, the GELU applied to the f32
// h before h is rounded, and g rounded to the compute type before the
// second product.  What does not: the weights resident in on-chip memory
// across a sequential grid and the whole (128, f) f32 intermediate (a TPU
// core's VMEM holds them; an SM's 227 KB does not), and the row padding
// (tail rows are masked here).
//
// Bound at (T, d, f) = (20480, 768, 3072): two products of 2·T·d·f = 96.6
// GFLOP each; on the CUDA cores' 67 TFLOP/s that is 2.885 ms, against
// 396 MB (f32) or 198 MB (bf16) moved once, 0.118 or 0.059 ms at 3.35
// TB/s: operations bound it in both types, in bf16 at 0.195 ms on the
// tensor cores (989 TFLOP/s).
//
// Two designs, one per type.
//
// float32: csrc/fused_ffn.cuh row_tile_kernel<float, NJ, false> on the CUDA
// cores (a TF32 product keeps ~10 mantissa bits, too few for the f32
// tolerance of 1e-5), one block per 32 rows.
//
// bfloat16 (the production preset's type): fwd_bf16_kernel, on the tensor
// cores, mma.sync m16n8k16 (bf16 x bf16, f32 accumulation) fed by ldmatrix
// (warp_mma.cuh).  One block of 8 warps per 32 token rows, the x tile
// staged once in shared memory (bf16, rows padded by 16 bytes, so the 8
// rows an ldmatrix reads fall in 8 bank groups).  f is walked in chunks of
// 256 columns, and a chunk is a sequence of stages of one ring of two
// shared-memory slots, each filled by cp.async while the warps work on the
// other:
//   first product, d/128 stages of w1 (256 rows of the chunk x 128 of d):
//     h = x·w1 in f32, each warp all 32 rows x 32 columns; then b1, h
//     stored as bf16, g = bf16(gelu_tanh(h)) (precise tanhf) into shared
//     memory (zero past f: the last chunk may be half of one);
//   second product, 256/KS2 stages of w2 (all d rows x KS2 columns of the
//     chunk): y += g·w2, each warp all 32 rows x d/8 columns of f32 sums in
//     registers (96 a lane at d = 768), stored once, plus b2, as bf16.
// Both weights are read in the nn.Linear layout, (f, d) and (d, f): the
// summed axis is contiguous, which is the layout ldmatrix takes for the B
// operand without .trans.  g goes through shared memory and not from the
// first product's accumulators into the second's A fragments (as the
// flash kernels pass P): a warp would then need all d columns of y for its
// rows, 384 f32 registers a lane at d = 768 for 16 rows; in shared memory
// it is 32 x 256 bf16, exact, since the second product takes g rounded to
// bf16.
// The sizes.  32 rows keep y at 96 registers a lane.  Each block reads
// both weights once, from L2 after the first blocks (9.4 MB; 6 GB a
// launch at T = 20480), but in trials on the H100 neither those re-reads
// nor the cp.async latency bound it: 64 rows a block (16 warps, capped at
// 128 registers a thread, which spills) and rings of three or four
// slots were slower.  Shared-memory reads weigh more: ldmatrix moves 512
// bytes in 4 of the SM's cycles.  So each warp takes all 32 rows (two A
// fragments, and each B fragment loaded once a block, not once for each
// row tile), and the chunk is 256 columns (x's A fragments, which every
// warp loads, serve twice the columns): 2560 ldmatrix for 256 columns of
// f, against 3968 with 16-row warp tiles and 128-column chunks.  1 block
// an SM (206 KB of shared memory at d = 768).
//
// Interface: plain extern "C", raw device pointers and the stream; returns
// the cudaError_t of the launch (cudaErrorInvalidValue for shapes it does
// not take).  The weights are given as torch.nn.Linear stores them: w1 as
// (f, d) and w2 as (d, f), row-major.

#include <type_traits>

#include "fused_ffn.cuh"
#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int TC_BM = 32;      // token rows a block: two m16 tiles
constexpr int TC_FC = 256;     // columns of f a chunk: 32 a warp
constexpr int KS1 = 128;       // depth of a w1 stage (d)
constexpr int PAD = 8;         // bf16 of padding a staged row
constexpr size_t SMEM_LIMIT = 232448;  // a block's shared memory on sm_90

template <int NJ, int KS2_>
struct TcShape {
  static constexpr int D = 128 * NJ;
  static constexpr int KS2 = KS2_;  // depth of a w2 stage (f)
  static constexpr int XS_LD = D + PAD;
  static constexpr int GS_LD = TC_FC + PAD;
  static constexpr int W1_LD = KS1 + PAD;
  static constexpr int W2_LD = KS2 + PAD;
  static constexpr int SLOT =
      TC_FC * W1_LD > D * W2_LD ? TC_FC * W1_LD : D * W2_LD;
  static constexpr size_t SMEM =
      sizeof(bf16) * (TC_BM * XS_LD + TC_BM * GS_LD + 2 * SLOT);
};
// w2 stages 32 deep where they fit (d <= 896), else 16
template <int NJ>
using TcSizes = std::conditional_t<TcShape<NJ, 32>::SMEM <= SMEM_LIMIT,
                                   TcShape<NJ, 32>, TcShape<NJ, 16>>;

// x: (t, D); w1: (f, D); w2: (D, f); h: (t, f); y: (t, D); bf16.  Warp w
// takes chunk columns 32w in the first product, y columns (D/8)·w in the
// second, all 32 rows of the tile in both.
template <int NJ>
__global__ void __launch_bounds__(fused_ffn::THREADS, 1)
    fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, bf16* __restrict__ y,
                    bf16* __restrict__ h, int t, int f) {
  using S = TcSizes<NJ>;
  constexpr int D = S::D, KS2 = S::KS2, THREADS = fused_ffn::THREADS;
  constexpr int S1 = D / KS1, S2 = TC_FC / KS2, NT2 = 2 * NJ;
  static_assert(TC_FC * KS1 / 8 % THREADS == 0 && D * KS2 / 8 % THREADS == 0,
                "whole 16-byte copies a thread");
  extern __shared__ __align__(16) float smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [TC_BM][XS_LD]
  bf16* gs = xs + TC_BM * S::XS_LD;          // [TC_BM][GS_LD]
  bf16* ring = gs + TC_BM * S::GS_LD;        // [2][SLOT]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int r0 = blockIdx.x * TC_BM;
  const int stages = (f + TC_FC - 1) / TC_FC * (S1 + S2);

  // stage s: chunk c0 = TC_FC·(s / (S1 + S2)); its first S1 stages are w1
  // rows [c0, c0 + TC_FC) x columns [KS1·q, +KS1), the next S2 are w2 rows
  // [0, D) x columns [c0 + KS2·(q − S1), +KS2); zeros past f
  auto stage = [&](int s) {
    const int c0 = s / (S1 + S2) * TC_FC, q = s % (S1 + S2);
    bf16* dst = ring + (s & 1) * S::SLOT;
    if (q < S1) {
#pragma unroll
      for (int i = 0; i < TC_FC * KS1 / 8 / THREADS; ++i) {
        const int v = tid + THREADS * i;
        const int r = v / (KS1 / 8), c = v % (KS1 / 8) * 8;
        const bool ok = c0 + r < f;
        cp_async_16(dst + r * S::W1_LD + c,
                    w1 + (size_t)(ok ? c0 + r : 0) * D + q * KS1 + c, ok);
      }
    } else {
      const int k0 = c0 + (q - S1) * KS2;
      const bool ok = k0 < f;      // KS2 divides the 128 that f is made of
#pragma unroll
      for (int i = 0; i < D * KS2 / 8 / THREADS; ++i) {
        const int v = tid + THREADS * i;
        const int r = v / (KS2 / 8), c = v % (KS2 / 8) * 8;
        cp_async_16(dst + r * S::W2_LD + c,
                    w2 + (size_t)r * f + (ok ? k0 + c : 0), ok);
      }
    }
  };

  // the x tile (rows past t zero) and stage 0: the first group
#pragma unroll
  for (int i = 0; i < TC_BM * D / 8 / THREADS; ++i) {
    const int v = tid + THREADS * i;
    const int r = v / (D / 8), c = v % (D / 8) * 8;
    const bool ok = r0 + r < t;
    cp_async_16(xs + r * S::XS_LD + c, x + (size_t)(ok ? r0 + r : 0) * D + c,
                ok);
  }
  stage(0);
  cp_async_commit();

  float acc1[2][4][4], acc2[2][NT2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
      acc2[mt][nt][0] = acc2[mt][nt][1] = acc2[mt][nt][2] =
          acc2[mt][nt][3] = 0.f;
  // this lane's ldmatrix rows: A rows lane % 16 of an m16 tile, B rows 8
  // of each of two n8 tiles (warp_mma.cuh's fragment layouts)
  const int a_row = lane % 16, a_col = 8 * (lane / 16);
  const int b_row = 8 * (lane / 16) + lane % 8, b_col = 8 * ((lane / 8) % 2);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int c0 = s / (S1 + S2) * TC_FC, q = s % (S1 + S2);
    const bf16* b = ring + (s & 1) * S::SLOT;
    if (q < S1) {
      // h[.., 32w..] += x[.., KS1·q + k] · w1[c0 + 32w + n, KS1·q + k]
      if (q == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            acc1[mt][nt][0] = acc1[mt][nt][1] = acc1[mt][nt][2] =
                acc1[mt][nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS1; kk += 16) {
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], xs + (16 * mt + a_row) * S::XS_LD + q * KS1 +
                                 kk + a_col);
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          unsigned bb[4];  // B fragments of n8 tiles nt and nt + 1
          ldmatrix_x4(bb, b + (32 * warp + 8 * nt + b_row) * S::W1_LD + kk +
                              b_col);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16_16816(acc1[mt][nt], a[mt], bb);
            mma_bf16_16816(acc1[mt][nt + 1], a[mt], bb + 2);
          }
        }
      }
      if (q == S1 - 1) {
        // acc1[mt][nt][2hh + e]: row 16mt + g4 + 8hh, chunk column
        // 32w + 8nt + 2t4 + e; h = sum + b1, stored as bf16, and g
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = 32 * warp + 8 * nt + 2 * t4;
          const bool okc = c0 + col < f;   // both columns: f is even
          const float bias0 = okc ? __bfloat162float(b1[c0 + col]) : 0.f;
          const float bias1 = okc ? __bfloat162float(b1[c0 + col + 1]) : 0.f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = 16 * mt + g4 + 8 * hh;
              const float h0 = acc1[mt][nt][2 * hh] + bias0;
              const float h1 = acc1[mt][nt][2 * hh + 1] + bias1;
              if (okc && r0 + row < t)
                *reinterpret_cast<unsigned*>(h + (size_t)(r0 + row) * f +
                                             c0 + col) = pack_bf16(h0, h1);
              *reinterpret_cast<unsigned*>(gs + row * S::GS_LD + col) =
                  okc ? pack_bf16(fused_ffn::gelu_tanh(h0),
                                  fused_ffn::gelu_tanh(h1))
                      : 0u;
            }
        }
      }
    } else {
      // y[.., (D/8)w..] += g[.., KS2·(q − S1) + k] · w2[.., c0 + ...]
      const int kg = (q - S1) * KS2;
#pragma unroll
      for (int kk = 0; kk < KS2; kk += 16) {
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], gs + (16 * mt + a_row) * S::GS_LD + kg + kk +
                                 a_col);
#pragma unroll
        for (int nt = 0; nt < NT2; nt += 2) {
          unsigned bb[4];
          ldmatrix_x4(bb, b + (16 * NJ * warp + 8 * nt + b_row) * S::W2_LD +
                              kk + b_col);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16_16816(acc2[mt][nt], a[mt], bb);
            mma_bf16_16816(acc2[mt][nt + 1], a[mt], bb + 2);
          }
        }
      }
    }
    __syncthreads();  // the slot read, and gs written, before the next
  }

#pragma unroll
  for (int nt = 0; nt < NT2; ++nt) {
    const int col = 16 * NJ * warp + 8 * nt + 2 * t4;
    const float bias0 = __bfloat162float(b2[col]);
    const float bias1 = __bfloat162float(b2[col + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 16 * mt + g4 + 8 * hh;
        if (row < t)
          *reinterpret_cast<unsigned*>(y + (size_t)row * D + col) =
              pack_bf16(acc2[mt][nt][2 * hh] + bias0,
                        acc2[mt][nt][2 * hh + 1] + bias1);
      }
  }
}

template <int NJ>
int launch_fwd_bf16(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* y, void* h, int t,
                    int f, void* stream) {
  constexpr size_t smem = TcSizes<NJ>::SMEM;
  static_assert(smem <= SMEM_LIMIT, "shared memory of a block");
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_bf16_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_bf16_kernel<NJ><<<dim3((t + TC_BM - 1) / TC_BM),
                        dim3(fused_ffn::THREADS), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(y),
      static_cast<bf16*>(h), t, f);
  return (int)cudaGetLastError();
}

int dispatch_fwd_bf16(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* y, void* h, int t,
                      int d, int f, void* stream) {
  if (!fused_ffn::shape_ok(t, d, f)) return (int)cudaErrorInvalidValue;
#define MIMM_FWD_BF16_CASE(NJ) \
  case NJ:                     \
    return launch_fwd_bf16<NJ>(x, w1, b1, w2, b2, y, h, t, f, stream);
  switch (d / 128) {
    MIMM_FWD_BF16_CASE(1)
    MIMM_FWD_BF16_CASE(2)
    MIMM_FWD_BF16_CASE(3)
    MIMM_FWD_BF16_CASE(4)
    MIMM_FWD_BF16_CASE(5)
    MIMM_FWD_BF16_CASE(6)
    MIMM_FWD_BF16_CASE(7)
    MIMM_FWD_BF16_CASE(8)
  }
#undef MIMM_FWD_BF16_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (t, d); w1: (f, d); b1: (f); w2: (d, f); b2: (d); y: (t, d); h: (t,
// f); contiguous, 16-byte aligned, all float32 (is_bf16 = 0) or all
// bfloat16 (is_bf16 = 1).  d = 128·n <= 1024, f a multiple of 128,
// t·f < 2^31.
extern "C" int mimm_fused_ffn_fwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* y, void* h, int t,
                                  int d, int f, int is_bf16,
                                  void* stream) {
  if (is_bf16) return dispatch_fwd_bf16(x, w1, b1, w2, b2, y, h, t, d, f, stream);
  return fused_ffn::dispatch_row_tile<float, false>(x, w1, w2, b1, b2, nullptr,
                                                    y, h, t, d, f, stream);
}
