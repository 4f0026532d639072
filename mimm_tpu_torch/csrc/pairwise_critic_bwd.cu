// Pairwise critic backward for Hopper (sm_90a): given g = dL/dS (B_img,
// B_txt) and the forward's inputs, with
//   z1 = h_img[i] + h_txt[j] + b1,  t = relu(z1),  z2 = t·W2 + b2,
//   dz2 = (g[i,j]·w3) ∘ [z2 > 0],   dt = dz2·W2ᵀ,  dz1 = dt ∘ [t > 0],
// it computes dh_img[i] = Σ_j dz1, dh_txt[j] = Σ_i dz1, dW2 = Σ tᵀdz2,
// db2 = Σ dz2, dw3 = Σ relu(z2)·g, db1 = Σ dz1 and db3 = Σ g.  float32.
//
// Replaces the TPU kernels mimm_tpu/ops/pairwise_critic.py _bwd_img_kernel
// (:205; dh_img and the weight gradients, pallas_call in _bwd_call :331)
// and _bwd_txt_kernel (:270; dh_txt, pallas_call :361).  As there, z2 and
// the pair activation are recomputed tile by tile and no buffer of
// B_img·B_txt·H1 or B_img·B_txt·H2 floats exists.
//
// Bound at B_img = B_txt = 2048, H1 = 1024, H2 = 512: the backward cannot do
// less than three pair products (the z2 recompute, dt and dW2), 13.2 TFLOP;
// its bytes (~60 MB) are negligible, so operations bound it: 197 ms at the
// 67 TFLOP/s float32 rate outside the tensor cores, 80 ms at the TF32
// tensor-core rate (495 TFLOP/s) for the 3 x 3 TF32 products of 3xTF32.
//
// What the TPU kernel did that a GPU cannot: it kept dW2 (H1 × H2 f32, 2 MB)
// resident in VMEM across a sequential grid.  No SM holds 2 MB, adding a
// partial per pair tile into device memory would move ~260 GB a step, and
// storing dz2 for every pair would take B²·H2·4 B.  But dz2 is g·w3 where
// z2 > 0: one bit a pair and column (B²·H2/8 B, 268 MB at 2048²) carries
// it from the kernel that computes z2 to the one that needs it for dW2.
// The same bits give dh_txt its mask, so row 7 needs no z2 of its own.
// Past 256 MiB of bits the wrapper (ops/pairwise_critic.py
// BITS_BUDGET_BYTES) runs bwd_img, bwd_w and bwd_txt over ranges of image
// rows in turn, bwd_w adding into the same partials and bwd_txt into the
// same dh_txt, so the bits never take more.
//
// Rows 6 and 7, four pair products on the tensor cores, mma.sync m16n8k8
// in 3xTF32 (warp_mma.cuh: each float32 operand split into a tf32 high part
// and a tf32 remainder, three mmas a product, float32 accumulation; about
// float32's accuracy).  Two facts make it cheaper.  dz2 = g·w3·mask with
// mask = [z2 > 0], so g and w3 come out of the products: dt =
// g·(mask·(w3∘W2)ᵀ) and dW2 = w3·((g·t)ᵀ·mask); the mask, 1.0 or 0.0, is
// exact in tf32, so those products take two mmas where 3xTF32 takes three.  And an operand that several warps read (t, g·t,
// and row 7's w3∘W2) is split once, when it is staged in shared memory,
// not at every load.
// * bwd_img_kernel: a block owns 4 image rows and loops over the text rows
//   in tiles of 16, 64 pairs a tile (one m16 tile per image row).  Per tile
//   it computes z2 over all of H2 (t built 16 deep in shared memory from
//   h_img, h_txt and b1, W2 staged with cp.async, double-buffered), keeps
//   the mask (64 × H2 in shared memory), writes it as bits, adds db2 and
//   dw3 into per-block sums, then dt in 256-column passes over H1, masks it
//   to dz1 and sums it over the tile's text rows into the block's dh rows
//   (shuffles, then shared memory).  Two pair products.
// * bwd_w_kernel: a split-K product for dW2 over the pairs: a block owns a
//   128 × 128 tile of dW2 and one of `splits` pair ranges, stages g·t and
//   the mask (from the bits) 16 pairs deep in shared memory, adds the
//   tensor cores' sums into a float32 tile in shared memory every 512
//   pairs, and writes one partial per split.  One pair product.
// * reduce_kernel: adds the split partials, the per-block db2, dw3 and db3,
//   and db1 = Σ_i dh_img[i], in a fixed order.
// * bwd_txt_kernel (row 7, dh_txt): bwd_img's dt transposed: a block owns
//   4 text rows and loops over the image rows in tiles of 16, 64 pairs a
//   tile, dt = g·(mask·(w3∘W2)ᵀ) in 256-column passes over H1 with the
//   mask expanded from bwd_img's bits as it is loaded (two mmas a tile,
//   (w3∘W2) split once as it is staged), masked to dz1 and summed over the
//   tile's image rows into the block's dh rows.  One pair product, where
//   its first design on the CUDA cores recomputed z2 and took two.
//
// No float atomics anywhere: every sum runs in a fixed order, so the result
// is the same from run to run.  The forward accumulates z2 on the CUDA
// cores in one order, bwd_img on the tensor cores in another, so their
// relu masks agree wherever z2 is not within float32 rounding of 0; where
// it is, a flipped mask moves a gradient by a term of that size, which
// the kernels' tolerances (CRITIC_TOL in chip_smoke.py) hold.  Every
// gradient of the backward takes its z2 mask from the same bits.
//
// Interface: plain extern "C", raw device pointers and the stream; each
// returns the cudaError_t of its launch (cudaErrorInvalidValue for shapes
// it does not take: H1 > 1024, H2 > 512, or row offsets past int).

#include <cuda_runtime.h>

#include "warp_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_H1 = 1024;
constexpr int MAX_H2 = 512;

// ---- row 6: the 3xTF32 warp product (warp_mma.cuh mma_step) ---------------
constexpr int KC = 32;          // depth of a staged chunk: four k-steps of 8

// the tf32 parts of x, split once, as one 8-byte shared-memory word
__device__ __forceinline__ uint2 split_pair(float x) {
  unsigned hi, lo;
  split_tf32(x, hi, lo);
  return make_uint2(hi, lo);
}

// ---- dh_img, the z2 bits, db2, dw3, db3 (row 6) -----------------------------
constexpr int IT = 4;                 // image rows per block
constexpr int JT = 16;                // text rows per tile: an m16 tile a row
constexpr int MP = IT * JT;           // pairs per tile
constexpr int PN = 256;               // columns per pass: 32 a warp
constexpr int TS_LD = KC + 4;         // t chunk [pair][k], split (uint2)
constexpr int WZ_LD = PN + 8;         // W2 chunk [k][n] of a z2 pass
constexpr int WT_LD = KC + 4;         // W2 chunk [n = H1][k = H2] of a dt pass
constexpr int MK_LD = MAX_H2 / 32 + 1; // the tile's z2 > 0 bits [pair][word]
constexpr int WB_FLOATS =
    KC * WZ_LD > PN * WT_LD ? KC * WZ_LD : PN * WT_LD;
constexpr size_t IMG_SMEM_BYTES =
    sizeof(uint2) * 2 * MP * TS_LD +
    sizeof(float) * (2 * WB_FLOATS + MP * MK_LD + IT * MAX_H1 +
                     3 * MAX_H2 + MP);

// One block per IT image rows, 8 warps, each a 64 × 32 tile of every pass
// (all of the tile's pairs, 32 columns).  dz2 = g·w3·[z2 > 0] is kept as
// its mask, bits in shared memory that become 1.0 or 0.0 (exact in tf32)
// as they are loaded: dt = g·(mask·(w3∘W2)ᵀ), so the dt product takes two
// mmas a tile (the mask has no low part) and g joins in the epilogue.  bits: (n_img·n_txt, ceil(H2/32)) words, bit n%32 of word
// n/32 set where z2 > 0; vecp: per block [db2 (H2) | dw3 (H2) | db3].
__global__ void __launch_bounds__(THREADS, 1)
    bwd_img_kernel(const float* __restrict__ hi, const float* __restrict__ hj,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ w3,
                   const float* __restrict__ g, float* __restrict__ dh,
                   unsigned* __restrict__ bits, float* __restrict__ vecp,
                   int n_img, int n_txt, int h1, int h2, int vec16) {
  extern __shared__ __align__(16) float smem[];
  uint2* ts = reinterpret_cast<uint2*>(smem);  // [2][MP][TS_LD]
  float* wb = smem + 2 * 2 * MP * TS_LD;       // [2][WB_FLOATS]
  unsigned* mk = reinterpret_cast<unsigned*>(wb + 2 * WB_FLOATS);
                                               // [MP][MK_LD]
  float* dhs = reinterpret_cast<float*>(mk + MP * MK_LD);  // [IT][MAX_H1]
  float* red = dhs + IT * MAX_H1;              // db2, dw3 [MAX_H2] each
  float* w3s = red + 2 * MAX_H2;               // [MAX_H2]
  float* gs = w3s + MAX_H2;                    // [MP]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int i0 = blockIdx.x * IT;
  const int wpp = (h2 + 31) / 32;
  for (int e = tid; e < IT * MAX_H1; e += THREADS) dhs[e] = 0.f;
  for (int e = tid; e < 2 * MAX_H2; e += THREADS) red[e] = 0.f;
  for (int e = tid; e < MAX_H2; e += THREADS) w3s[e] = e < h2 ? w3[e] : 0.f;
  float db3 = 0.f;

  // t of pair tid/4 at depths k0 + tid%4 + 4q, q < KC/4 (conflict-free
  // 8-byte stores)
  const int sm = tid / 4, sk = tid % 4;
  const int si = i0 + sm / JT;
  float tv[KC / 4];
  auto load_t = [&](int j0, int k0) {
    const int j = j0 + sm % JT;
    const bool live = si < n_img && j < n_txt;
#pragma unroll
    for (int q = 0; q < KC / 4; ++q) {
      const int k = k0 + sk + 4 * q;
      tv[q] = live && k < h1
                  ? fmaxf((hi[(size_t)si * h1 + k] + hj[(size_t)j * h1 + k]) +
                              b1[k],
                          0.f)
                  : 0.f;
    }
  };
  auto store_t = [&](int buf) {
#pragma unroll
    for (int q = 0; q < KC / 4; ++q)
      ts[(buf * MP + sm) * TS_LD + sk + 4 * q] = split_pair(tv[q]);
  };
  // W2[k0 + kk][n0 + n] at wb[buf][kk][n] (kk < KC, n < PN)
  auto stage_wz = [&](int buf, int k0, int n0) {
    float* dst = wb + buf * WB_FLOATS;
    if (vec16) {
#pragma unroll
      for (int q = 0; q < KC * PN / 4 / THREADS; ++q) {
        const int v = tid + THREADS * q, kk = v / (PN / 4);
        const int n = (v % (PN / 4)) * 4, k = k0 + kk, col = n0 + n;
        const bool ok = k < h1 && col < h2;
        cp_async_16(dst + kk * WZ_LD + n, ok ? w2 + (size_t)k * h2 + col : w2,
                    ok);
      }
    } else {
      for (int q = 0; q < KC * PN / THREADS; ++q) {
        const int e = tid + THREADS * q, kk = e / PN, n = e % PN;
        const int k = k0 + kk, col = n0 + n;
        const bool ok = k < h1 && col < h2;
        cp_async_4(dst + kk * WZ_LD + n, ok ? w2 + (size_t)k * h2 + col : w2,
                   ok);
      }
    }
  };
  // W2[p0 + n][k0 + kk] at wb[buf][n][kk] (n < PN, kk < KC): W2ᵀ's chunk
  auto stage_wt = [&](int buf, int k0, int p0) {
    float* dst = wb + buf * WB_FLOATS;
    if (vec16) {
#pragma unroll
      for (int q = 0; q < PN * KC / 4 / THREADS; ++q) {
        const int v = tid + THREADS * q, n = v / (KC / 4);
        const int kk = (v % (KC / 4)) * 4, row = p0 + n, col = k0 + kk;
        const bool ok = row < h1 && col < h2;
        cp_async_16(dst + n * WT_LD + kk,
                    ok ? w2 + (size_t)row * h2 + col : w2, ok);
      }
    } else {
      for (int q = 0; q < PN * KC / THREADS; ++q) {
        const int e = tid + THREADS * q, n = e / KC, kk = e % KC;
        const int row = p0 + n, col = k0 + kk;
        const bool ok = row < h1 && col < h2;
        cp_async_4(dst + n * WT_LD + kk,
                   ok ? w2 + (size_t)row * h2 + col : w2, ok);
      }
    }
  };

  for (int j0 = 0; j0 < n_txt; j0 += JT) {
    if (tid < MP) {
      const int i = i0 + tid / JT, j = j0 + tid % JT;
      gs[tid] = i < n_img && j < n_txt ? g[(size_t)i * n_txt + j] : 0.f;
    }
    __syncthreads();
    if (tid == 0)
      for (int m = 0; m < MP; ++m) db3 += gs[m];

    // ---- z2 = t·W2 + b2 in passes of PN columns; its mask, db2, dw3
    const int nk = (h1 + KC - 1) / KC;
    for (int n0 = 0; n0 < h2; n0 += PN) {
      float acc[4][4][4] = {};
      load_t(j0, 0);
      store_t(0);
      stage_wz(0, 0, n0);
      cp_async_commit();
      for (int c = 0; c < nk; ++c) {
        if (c + 1 < nk) {
          stage_wz((c + 1) & 1, (c + 1) * KC, n0);
          load_t(j0, (c + 1) * KC);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const uint2* a = ts + (c & 1) * MP * TS_LD;
        const float* b = wb + (c & 1) * WB_FLOATS + warp * 32;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 8)
          mma_step<4, 4, false, false>(
              acc,
              [&](int m, int k, unsigned& h, unsigned& l) {
                const uint2 v = a[m * TS_LD + kk + k];
                h = v.x;
                l = v.y;
              },
              [&](int k, int n, unsigned& h, unsigned& l) {
                split_tf32(b[(kk + k) * WZ_LD + n], h, l);
              },
              lane);
        if (c + 1 < nk) store_t((c + 1) & 1);
        __syncthreads();
      }
      // acc[mt][nt][2h + e]: pair 16mt + g4 + 8h (image row i0 + mt, text
      // row j0 + g4 + 8h), column nw + 8nt + 2t4 + e
      const int nw = n0 + warp * 32;
      float s2[4][2] = {}, s3[4][2] = {};
      unsigned word[4][2] = {};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nw + 8 * nt + 2 * t4 + e;
          const bool okn = n < h2;
          const float wn = w3s[n];
          const float bias = okn ? b2[n] : 0.f;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = 16 * mt + g4 + 8 * h;
              const float z2 = acc[mt][nt][2 * h + e] + bias;
              const bool on = okn && z2 > 0.f;
              const float gp = gs[m];
              s2[nt][e] += on ? gp * wn : 0.f;
              if (okn) s3[nt][e] = fmaf(fmaxf(z2, 0.f), gp, s3[nt][e]);
              if (on) word[mt][h] |= 1u << (8 * nt + 2 * t4 + e);
            }
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int x = 4; x < 32; x *= 2) {
            s2[nt][e] += shfl_xor(s2[nt][e], x);
            s3[nt][e] += shfl_xor(s3[nt][e], x);
          }
          const int n = nw + 8 * nt + 2 * t4 + e;
          if (g4 == 0 && n < h2) {
            red[n] += s2[nt][e];
            red[MAX_H2 + n] += s3[nt][e];
          }
        }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned w = word[mt][h];
          w |= shfl_xor(w, 1);
          w |= shfl_xor(w, 2);
          const int i = i0 + mt, j = j0 + g4 + 8 * h;
          if (t4 == 0) mk[(16 * mt + g4 + 8 * h) * MK_LD + nw / 32] = w;
          if (t4 == 0 && nw < h2 && i < n_img && j < n_txt)
            bits[((size_t)i * n_txt + j) * wpp + nw / 32] = w;
        }
    }
    __syncthreads();  // mk complete

    // ---- dt = g·(mask·(w3∘W2)ᵀ) in passes of PN columns of H1; dz1 = dt
    // where z1 > 0, summed over the tile's text rows into dhs
    const int nk2 = (h2 + KC - 1) / KC;
    for (int p0 = 0; p0 < h1; p0 += PN) {
      float acc[4][4][4] = {};
      stage_wt(0, 0, p0);
      cp_async_commit();
      for (int c = 0; c < nk2; ++c) {
        if (c + 1 < nk2) stage_wt((c + 1) & 1, (c + 1) * KC, p0);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* b = wb + (c & 1) * WB_FLOATS + warp * 32 * WT_LD;
        const float* ws = w3s + c * KC;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 8)
          mma_step<4, 4, true, false>(
              acc,
              [&](int m, int k, unsigned& h, unsigned&) {  // 1.0f or 0.0f
                const int col = c * KC + kk + k;
                h = (mk[m * MK_LD + col / 32] >> (col % 32)) & 1u ? 0x3F800000u
                                                                  : 0u;
              },
              [&](int k, int n, unsigned& h, unsigned& l) {
                split_tf32(ws[kk + k] * b[n * WT_LD + kk + k], h, l);
              },
              lane);
        __syncthreads();
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = p0 + warp * 32 + 8 * nt + 2 * t4 + e;
          const bool okc = col < h1;
          const float bias = okc ? b1[col] : 0.f;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const int i = i0 + mt;
            const bool oki = okc && i < n_img;
            const float hv = oki ? hi[(size_t)i * h1 + col] : 0.f;
            float s = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = j0 + g4 + 8 * h;
              if (oki && j < n_txt &&
                  (hv + hj[(size_t)j * h1 + col]) + bias > 0.f)
                s += gs[16 * mt + g4 + 8 * h] * acc[mt][nt][2 * h + e];
            }
#pragma unroll
            for (int x = 4; x < 32; x *= 2) s += shfl_xor(s, x);
            if (g4 == 0 && okc) dhs[mt * MAX_H1 + col] += s;
          }
        }
    }
    __syncthreads();  // gs read by every warp before the next tile's
  }

  for (int e = tid; e < IT * h1; e += THREADS) {
    const int il = e / h1, col = e % h1;
    if (i0 + il < n_img) dh[(size_t)(i0 + il) * h1 + col] = dhs[il * MAX_H1 + col];
  }
  float* vp = vecp + (size_t)blockIdx.x * (2 * h2 + 1);
  for (int n = tid; n < h2; n += THREADS) {
    vp[n] = red[n];
    vp[h2 + n] = red[MAX_H2 + n];
  }
  if (tid == 0) vp[2 * h2] = db3;
}

// ---- dW2 (row 6) ----------------------------------------------------------------
constexpr int WM = 128;               // H1 rows of a block's dW2 tile
constexpr int WNB = 128;              // H2 columns of it: 4 words of bits
constexpr int WKP = 16;               // pairs a chunk
constexpr int WA_LD = WM + 4;         // g·t chunk [pair][H1], split (uint2)
constexpr int W_FLUSH = 32;           // chunks between two adds into `tot`
constexpr size_t W_SMEM_BYTES = sizeof(float) * WM * WNB +
                                sizeof(uint2) * 2 * WKP * WA_LD +
                                sizeof(unsigned) * 2 * WKP * (WNB / 32);

// Block (n-tile, m-tile, split); 8 warps, each a 64 × 32 tile of dW2; the
// block's pairs are the chunks [chunks·split / splits, chunks·(split+1) /
// splits) of WKP consecutive pairs (p = i·n_txt + j).  With dz2 = g·w3·mask,
// dW2[m, n] = w3[n]·Σ_p (g·t)[p, m]·mask[p, n]: A = (g·t)ᵀ, split once
// when staged; B = the mask, staged as bwd_img's bits (a warp's 32 columns
// are one word) and expanded to 1.0 or 0.0, exact in tf32, as loaded (two
// mmas a tile); w3 joins at the end.  The tensor cores' float32 sums run
// W_FLUSH chunks (512 pairs) long; each is then added into the block's tile
// in shared memory with a rounded float32 add, so a split's 2^18 pairs (at
// 2048²) are not one chain of tensor-core sums.  With `accumulate` the
// partials are added to what dw2p holds (one launch per range of image
// rows, in order) instead of overwriting it.
__global__ void __launch_bounds__(THREADS)
    bwd_w_kernel(const float* __restrict__ hi, const float* __restrict__ hj,
                 const float* __restrict__ b1, const float* __restrict__ w3,
                 const float* __restrict__ g,
                 const unsigned* __restrict__ bits, float* __restrict__ dw2p,
                 int n_img, int n_txt, int h1, int h2, int accumulate) {
  extern __shared__ __align__(16) float smem[];
  float* tot = smem;                                      // [64][THREADS]
  uint2* ta = reinterpret_cast<uint2*>(tot + WM * WNB);   // [2][WKP][WA_LD]
  unsigned* bw = reinterpret_cast<unsigned*>(ta + 2 * WKP * WA_LD);
                                                          // [2][WKP][4]
  const int n0 = blockIdx.x * WNB, m0 = blockIdx.y * WM, split = blockIdx.z;
  const long long pairs = (long long)n_img * n_txt;
  const long long chunks = (pairs + WKP - 1) / WKP;
  const long long c_begin = chunks * split / gridDim.z;
  const long long c_end = chunks * (split + 1) / gridDim.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int wpp = (h2 + 31) / 32;
  // this thread stages g·t of pair tid/16 at H1 rows m0 + tid%16 + 16q
  // (q < 8: conflict-free 8-byte stores), and threads tid < 64 the bits
  // word n0/32 + tid%4 of pair tid/4
  const int sp = tid / 16, sj = tid % 16;
  const int bp = tid / 4, bq = tid % 4;
  const bool bits_ok = tid < 4 * WKP && n0 / 32 + bq < wpp;
  float b1r[8], tv[8];
  unsigned word = 0u;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int m = m0 + sj + 16 * q;
    b1r[q] = m < h1 ? b1[m] : 0.f;
  }
  // the next chunk this thread loads; its pair p = pi·n_txt + pj, stepped
  // by WKP
  long long c_next = c_begin;
  long long p = c_begin * WKP + sp;
  int pi = (int)(p / n_txt), pj = (int)(p % n_txt);
  auto load = [&]() {
    const bool live = p < pairs;
    const float* hr = hi + (size_t)(live ? pi : 0) * h1;
    const float* tr = hj + (size_t)(live ? pj : 0) * h1;
    const float gp = live ? g[p] : 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int m = m0 + sj + 16 * q;
      tv[q] = live && m < h1 ? gp * fmaxf((hr[m] + tr[m]) + b1r[q], 0.f)
                             : 0.f;
    }
    const long long pb = c_next * WKP + bp;
    word = bits_ok && pb < pairs ? bits[(size_t)pb * wpp + n0 / 32 + bq] : 0u;
    ++c_next;
    p += WKP;
    for (pj += WKP; pj >= n_txt; pj -= n_txt) ++pi;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      ta[(buf * WKP + sp) * WA_LD + sj + 16 * q] = split_pair(tv[q]);
    if (tid < 4 * WKP) bw[(buf * WKP + bp) * 4 + bq] = word;
  };

  float acc[4][4][4] = {};
  // acc added into tot (this thread's own 64 slots), then zeroed
  auto flush = [&](bool first) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& slot = tot[((mt * 4 + nt) * 4 + e) * THREADS + tid];
          slot = first ? acc[mt][nt][e] : slot + acc[mt][nt][e];
          acc[mt][nt][e] = 0.f;
        }
  };
  if (c_begin < c_end) {
    load();
    store(0);
  }
  __syncthreads();
  for (long long c = c_begin; c < c_end; ++c) {
    const int buf = (int)((c - c_begin) & 1);
    const bool more = c + 1 < c_end;
    if (more) load();       // in flight during the products
    const uint2* a = ta + buf * WKP * WA_LD + wm;
    const unsigned* b = bw + buf * WKP * 4 + warp % 4;
#pragma unroll
    for (int kk = 0; kk < WKP; kk += 8)
      mma_step<4, 4, false, true>(
          acc,
          [&](int m, int k, unsigned& h, unsigned& l) {
            const uint2 v = a[(kk + k) * WA_LD + m];
            h = v.x;
            l = v.y;
          },
          [&](int k, int n, unsigned& h, unsigned&) {  // 1.0f or 0.0f
            h = (b[(kk + k) * 4] >> n) & 1u ? 0x3F800000u : 0u;
          },
          lane);
    if ((c - c_begin) % W_FLUSH == W_FLUSH - 1) flush(c - c_begin < W_FLUSH);
    if (more) store(buf ^ 1);
    __syncthreads();
  }
  flush(c_end - c_begin < W_FLUSH);

  const int g4 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + wn + 8 * nt + 2 * t4 + e % 2;
      const float wn3 = n < h2 ? w3[n] : 0.f;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int m = m0 + wm + 16 * mt + g4 + 8 * (e / 2);
        if (m < h1 && n < h2) {
          float& out = dw2p[((size_t)split * h1 + m) * h2 + n];
          const float v = wn3 * tot[((mt * 4 + nt) * 4 + e) * THREADS + tid];
          out = accumulate ? out + v : v;
        }
      }
    }
}

// ---- dh_txt (row 7) -----------------------------------------------------------
constexpr int TJ = 4;                 // text rows per block
constexpr int TI = 16;                // image rows per tile: an m16 tile a row
constexpr int TP = TJ * TI;           // pairs per tile
constexpr int TW_LD = KC + 4;         // (w3∘W2) chunk [n = H1][k = H2], split
constexpr size_t TXT_SMEM_BYTES =
    sizeof(uint2) * 2 * PN * TW_LD +
    sizeof(float) * (TP * MK_LD + TJ * MAX_H1 + MAX_H2 + TP);

// bwd_img's transpose: one block per TJ text rows, 8 warps, each a 64 × 32
// tile of every pass (all of the tile's pairs, 32 columns of H1), the image
// rows walked in tiles of TI.  dt = g·(mask·(w3∘W2)ᵀ) with the mask read
// from bwd_img's bits (the same range of image rows): 1.0 or 0.0, exact in
// tf32, so two mmas a tile; (w3∘W2) is split into its tf32 parts once, as
// it is staged (register-prefetched a chunk ahead), and g joins in the
// epilogue.  dz1 = dt where z1 > 0 is summed over the tile's image rows
// (shuffles, then shared memory) into the block's dh rows, tile after tile;
// written, or added to dh's values where accumulate is nonzero.
__global__ void __launch_bounds__(THREADS, 1)
    bwd_txt_kernel(const float* __restrict__ hi, const float* __restrict__ hj,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ w3, const float* __restrict__ g,
                   const unsigned* __restrict__ bits, float* __restrict__ dh,
                   int n_img, int n_txt, int h1, int h2, int accumulate) {
  extern __shared__ __align__(16) float smem[];
  uint2* wt = reinterpret_cast<uint2*>(smem);           // [2][PN][TW_LD]
  unsigned* mk = reinterpret_cast<unsigned*>(wt + 2 * PN * TW_LD);
                                                        // [TP][MK_LD]
  float* dhs = reinterpret_cast<float*>(mk + TP * MK_LD);  // [TJ][MAX_H1]
  float* w3s = dhs + TJ * MAX_H1;                       // [MAX_H2]
  float* gs = w3s + MAX_H2;                             // [TP]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int j0 = blockIdx.x * TJ;
  const int wpp = (h2 + 31) / 32;
  for (int e = tid; e < TJ * MAX_H1; e += THREADS) dhs[e] = 0.f;
  for (int e = tid; e < MAX_H2; e += THREADS) w3s[e] = e < h2 ? w3[e] : 0.f;
  __syncthreads();

  // this thread stages W2[p0 + warp + 8q][k0 + lane], q < PN/8: a warp
  // reads 128 consecutive bytes of a row and stores 32 consecutive words
  float wv[PN / 8];
  auto load_w = [&](int p0, int k0) {
    const int k = k0 + lane;
#pragma unroll
    for (int q = 0; q < PN / 8; ++q) {
      const int row = p0 + warp + 8 * q;
      wv[q] = row < h1 && k < h2 ? w2[(size_t)row * h2 + k] : 0.f;
    }
  };
  auto store_w = [&](int buf, int k0) {
    const float s = w3s[k0 + lane];
#pragma unroll
    for (int q = 0; q < PN / 8; ++q)
      wt[(buf * PN + warp + 8 * q) * TW_LD + lane] = split_pair(s * wv[q]);
  };

  const int nk = (h2 + KC - 1) / KC;   // a chunk of KC columns: one word
  for (int i0 = 0; i0 < n_img; i0 += TI) {
    // the tile's g and bits: pair m = TI·jl + il is text row j0 + jl and
    // image row i0 + il; read after the first chunk's barrier
    if (tid < TP) {
      const int j = j0 + tid / TI, i = i0 + tid % TI;
      gs[tid] = i < n_img && j < n_txt ? g[(size_t)i * n_txt + j] : 0.f;
    }
    for (int e = tid; e < TP * wpp; e += THREADS) {
      const int m = e / wpp, w = e % wpp;
      const int j = j0 + m / TI, i = i0 + m % TI;
      mk[m * MK_LD + w] =
          i < n_img && j < n_txt ? bits[((size_t)i * n_txt + j) * wpp + w] : 0u;
    }
    for (int p0 = 0; p0 < h1; p0 += PN) {
      float acc[4][4][4] = {};
      load_w(p0, 0);
      store_w(0, 0);
      __syncthreads();
      for (int c = 0; c < nk; ++c) {
        if (c + 1 < nk) load_w(p0, (c + 1) * KC);  // in flight during the mmas
        const uint2* b = wt + ((c & 1) * PN + warp * 32) * TW_LD;
        const unsigned* mw = mk + c;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 8)
          mma_step<4, 4, true, false>(
              acc,
              [&](int m, int k, unsigned& h, unsigned&) {  // 1.0f or 0.0f
                h = (mw[m * MK_LD] >> (kk + k)) & 1u ? 0x3F800000u : 0u;
              },
              [&](int k, int n, unsigned& h, unsigned& l) {
                const uint2 v = b[n * TW_LD + kk + k];
                h = v.x;
                l = v.y;
              },
              lane);
        if (c + 1 < nk) store_w((c + 1) & 1, (c + 1) * KC);
        __syncthreads();
      }
      // acc[mt][nt][2h + e]: pair 16mt + g4 + 8h (text row j0 + mt, image
      // row i0 + g4 + 8h), column p0 + 32·warp + 8nt + 2t4 + e
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = p0 + warp * 32 + 8 * nt + 2 * t4 + e;
          const bool okc = col < h1;
          const float bias = okc ? b1[col] : 0.f;
          float hv[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 + g4 + 8 * h;
            hv[h] = okc && i < n_img ? hi[(size_t)i * h1 + col] : 0.f;
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const int j = j0 + mt;
            const bool okj = okc && j < n_txt;
            const float hw = okj ? hj[(size_t)j * h1 + col] : 0.f;
            float s = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (okj && i0 + g4 + 8 * h < n_img && (hv[h] + hw) + bias > 0.f)
                s += gs[16 * mt + g4 + 8 * h] * acc[mt][nt][2 * h + e];
#pragma unroll
            for (int x = 4; x < 32; x *= 2) s += shfl_xor(s, x);
            if (g4 == 0 && okc) dhs[mt * MAX_H1 + col] += s;
          }
        }
    }
    __syncthreads();  // gs, mk and dhs settled before the next tile's
  }

  for (int e = tid; e < TJ * h1; e += THREADS) {
    const int jl = e / h1, col = e % h1;
    if (j0 + jl < n_txt) {
      float& out = dh[(size_t)(j0 + jl) * h1 + col];
      const float v = dhs[jl * MAX_H1 + col];
      out = accumulate ? out + v : v;
    }
  }
}

// ---- the fixed-order sums (row 6) -------------------------------------------
__global__ void __launch_bounds__(THREADS)
    reduce_kernel(const float* __restrict__ dw2p,
                  const float* __restrict__ vecp,
                  const float* __restrict__ dh_img, float* __restrict__ dw2,
                  float* __restrict__ db1, float* __restrict__ db2,
                  float* __restrict__ dw3, float* __restrict__ db3,
                  int splits, int parts, int n_img, int h1, int h2) {
  const long long nw = (long long)h1 * h2;
  const long long items = nw + 2LL * h2 + h1 + 1;
  const int vs = 2 * h2 + 1;           // a row of vecp
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < items;
       e += (long long)gridDim.x * THREADS) {
    float s = 0.f;
    if (e < nw) {
      for (int k = 0; k < splits; ++k) s += dw2p[k * nw + e];
      dw2[e] = s;
    } else if (e < nw + 2LL * h2) {
      const int v = (int)(e - nw);     // db2 then dw3
      for (int k = 0; k < parts; ++k) s += vecp[(size_t)k * vs + v];
      (v < h2 ? db2[v] : dw3[v - h2]) = s;
    } else if (e < nw + 2LL * h2 + h1) {
      const int m = (int)(e - nw - 2LL * h2);
      for (int i = 0; i < n_img; ++i) s += dh_img[(size_t)i * h1 + m];
      db1[m] = s;
    } else {
      for (int k = 0; k < parts; ++k) s += vecp[(size_t)k * vs + 2 * h2];
      db3[0] = s;
    }
  }
}

bool shapes_ok(int n_img, int n_txt, int h1, int h2) {
  return n_img >= 1 && n_txt >= 1 && h1 >= 1 && h1 <= MAX_H1 && h2 >= 1 &&
         h2 <= MAX_H2 && (long long)n_img * h1 < (1LL << 31) &&
         (long long)n_txt * h1 < (1LL << 31);
}

}  // namespace

// dh_txt (n_txt, h1) by bwd_txt_kernel (row 7) from the bits of bwd_img on
// the same image rows, written, or added to dh's values where accumulate is
// nonzero (one launch per range of image rows, in order).  hi: (n_img, h1),
// hj: (n_txt, h1), b1: (h1), w2: (h1, h2), w3: (h2), g: (n_img, n_txt),
// bits: (n_img·n_txt, ceil(h2/32)); float32 (bits uint32), contiguous, on
// the device.
extern "C" int mimm_pairwise_critic_bwd_txt(
    const void* hi, const void* hj, const void* b1, const void* w2,
    const void* w3, const void* g, const void* bits, void* dh, int n_img,
    int n_txt, int h1, int h2, int accumulate, void* stream) {
  if (!shapes_ok(n_img, n_txt, h1, h2)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_txt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TXT_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  bwd_txt_kernel<<<(unsigned)((n_txt + TJ - 1) / TJ), THREADS, TXT_SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hi), static_cast<const float*>(hj),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(w3), static_cast<const float*>(g),
      static_cast<const unsigned*>(bits), static_cast<float*>(dh), n_img,
      n_txt, h1, h2, accumulate);
  return (int)cudaGetLastError();
}

// dh_img (n_img, h1); bits (n_img·n_txt, ceil(h2/32)) uint32, z2 > 0;
// vecp (blocks, 2·h2 + 1): per block [db2 | dw3 | db3].
extern "C" int mimm_pairwise_critic_bwd_img(
    const void* hi, const void* hj, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* g, void* dh, void* bits,
    void* vecp, int n_img, int n_txt, int h1, int h2, void* stream) {
  if (!shapes_ok(n_img, n_txt, h1, h2)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_img_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)IMG_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies of W2 rows need H2 and the base a multiple of 4 floats
  const int vec16 = h2 % 4 == 0 && (size_t)w2 % 16 == 0;
  bwd_img_kernel<<<(unsigned)((n_img + IT - 1) / IT), THREADS,
                   IMG_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hi), static_cast<const float*>(hj),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(g), static_cast<float*>(dh),
      static_cast<unsigned*>(bits), static_cast<float*>(vecp), n_img, n_txt,
      h1, h2, vec16);
  return (int)cudaGetLastError();
}

// Per-split partials of dW2 (splits, h1, h2) from the bits of bwd_img,
// written, or added to dw2p's values where accumulate is nonzero; the grid
// is (ceil(h2 / 128), ceil(h1 / 128), splits).
extern "C" int mimm_pairwise_critic_bwd_w(const void* hi, const void* hj,
                                          const void* b1, const void* w3,
                                          const void* g, const void* bits,
                                          void* dw2p, int n_img, int n_txt,
                                          int h1, int h2, int splits,
                                          int accumulate, void* stream) {
  if (!shapes_ok(n_img, n_txt, h1, h2) || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)W_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h2 + WNB - 1) / WNB, (h1 + WM - 1) / WM, splits);
  bwd_w_kernel<<<grid, THREADS, W_SMEM_BYTES,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hi), static_cast<const float*>(hj),
      static_cast<const float*>(b1), static_cast<const float*>(w3),
      static_cast<const float*>(g), static_cast<const unsigned*>(bits),
      static_cast<float*>(dw2p), n_img, n_txt, h1, h2, accumulate);
  return (int)cudaGetLastError();
}

// dW2 (h1, h2) from the split partials, db2, dw3 (h2) and db3 (1) from the
// per-block partials (parts, 2·h2 + 1), db1 (h1) as the column sum of
// dh_img (n_img, h1).
extern "C" int mimm_pairwise_critic_bwd_reduce(
    const void* dw2p, const void* vecp, const void* dh_img, void* dw2,
    void* db1, void* db2, void* dw3, void* db3, int splits, int parts,
    int n_img, int h1, int h2, void* stream) {
  if (!shapes_ok(n_img, 1, h1, h2) || splits < 1 || parts < 1)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)h1 * h2 + 2LL * h2 + h1 + 1;
  const unsigned blocks =
      (unsigned)(items < 4096LL * THREADS ? (items + THREADS - 1) / THREADS
                                          : 4096);
  reduce_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dw2p), static_cast<const float*>(vecp),
      static_cast<const float*>(dh_img), static_cast<float*>(dw2),
      static_cast<float*>(db1), static_cast<float*>(db2),
      static_cast<float*>(dw3), static_cast<float*>(db3), splits, parts,
      n_img, h1, h2);
  return (int)cudaGetLastError();
}
