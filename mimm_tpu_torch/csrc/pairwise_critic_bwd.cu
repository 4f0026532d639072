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
// B_img·B_txt·H1 or B_img·B_txt·H2 elements exists.
//
// Bound at B_img = B_txt = 2048, H1 = 1024, H2 = 512: the backward cannot do
// less than three pair products (the z2 recompute, dt and dW2), 13.2 TFLOP,
// 197 ms at the 67 TFLOP/s f32 rate outside the tensor cores; its bytes
// (~60 MB) are negligible, so operations bound it.
//
// What the TPU kernel did that a GPU cannot: it kept dW2 (H1 × H2 f32, 2 MB)
// resident in VMEM across a sequential grid.  No SM holds 2 MB, adding a
// partial per pair tile into device memory would move ~260 GB a step, and
// storing dz2 for every pair would take B²·H2·4 B.  The design rests on
// column n of z2 needing only column n of W2:
//
// * bwd_w_kernel (dW2, db2, dw3, db3): a block owns 16 columns of H2 and one
//   of `splits` ranges of the pairs.  Per tile of 256 pairs it recomputes z2
//   for its columns (a register-blocked FMA product over H1, the pair
//   activation rebuilt 8 deep in shared memory), forms dz2, and adds tᵀ·dz2
//   into its (H1 × 16) slice of dW2 held in registers, t rebuilt 8 pairs at
//   a time.  It writes one partial per split; over all blocks this is two
//   pair products.
// * bwd_rows_kernel<false> (dh_img) and <true> (dh_txt): a block owns 4 rows
//   of its side and loops over the other side in tiles of 16 rows, the TPU
//   grid's inner dimension as a loop inside the block.  Per tile it
//   recomputes z2 over all of H2 and keeps dz2 (64 pairs × H2) in shared
//   memory, then forms dt in 128-column passes over H1, masks it to dz1 and
//   sums it over the tile's other rows into the block's dh rows in shared
//   memory.  Two pair products each.
// * reduce_kernel: adds the split partials, db1 = Σ_i dh_img[i] and db3, in
//   a fixed order.
//
// Six pair products in all (26.4 TFLOP) against JAX's five and the minimum
// of three, with O(splits·H1·H2) scratch (33.6 MB at 16 splits).  No float
// atomics anywhere: every sum runs in a fixed order, so the result is the
// same from run to run.  z2 is accumulated in the same order (fmaf over
// H1 from 0 up) as in pairwise_critic_fwd.cu, so the relu masks of the
// forward and of the three kernels agree bit for bit.  A simple first
// version on the CUDA cores; tensor cores, wgmma and TMA are later work.
//
// Interface: plain extern "C", raw device pointers and the stream; each
// returns the cudaError_t of its launch (cudaErrorInvalidValue for shapes
// it does not take: H1 > 1024, H2 > 512, or row offsets past int).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 8;          // depth of a staged slice
constexpr int MAX_H1 = 1024;
constexpr int MAX_H2 = 512;

// ---- dh_img / dh_txt --------------------------------------------------------
constexpr int TO = 4;              // own rows per block
constexpr int TT = 16;             // other rows per tile
constexpr int PT = TO * TT;        // pairs per tile
constexpr int RN = 128;            // columns per pass (of H2, then of H1)
constexpr int RA_STRIDE = PT + 4;  // padded: conflict-free transposed stores
constexpr int RB_STRIDE = RN + 4;

__host__ __device__ inline int dz2_stride(int h2) {
  return (h2 + RN - 1) / RN * RN + 4;
}

size_t rows_smem_bytes(int h1, int h2) {
  return sizeof(float) * ((size_t)PT * dz2_stride(h2) + (size_t)TO * h1);
}

// OWN_TXT = false: own rows are images (dh_img); true: texts (dh_txt).
// Pair (own o, other t) is g[o][t] or g[t][o]; z1 = (h_own + h_other) + b1
// is the forward's (h_img + h_txt) + b1, since float addition commutes.
template <bool OWN_TXT>
__global__ void __launch_bounds__(THREADS)
    bwd_rows_kernel(const float* __restrict__ hi, const float* __restrict__ hj,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ w3,
                    const float* __restrict__ g, float* __restrict__ dh,
                    int n_img, int n_txt, int h1, int h2) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) float as[BK * RA_STRIDE];  // t slice [k][pair]
  __shared__ __align__(16) float bs[BK * RB_STRIDE];  // W2 / W2ᵀ slice
  __shared__ float red[16 * RN];                      // [ty][column]
  const int h2s = dz2_stride(h2);
  float* dz2s = smem;                    // [PT][h2s]
  float* dhs = smem + (size_t)PT * h2s;  // [TO][h1]

  const float* own = OWN_TXT ? hj : hi;
  const float* other = OWN_TXT ? hi : hj;
  const int n_own = OWN_TXT ? n_txt : n_img;
  const int n_other = OWN_TXT ? n_img : n_txt;
  const int o0 = blockIdx.x * TO;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  // this thread's pairs ty*4 + r: own row co, other rows ct + r of the tile
  const int co = o0 + ty / 4;
  const int ct = (ty % 4) * 4;
  // the thread builds t for pairs tid/8 + 32q (q < 2) at depth tid % 8
  const int ak = tid % BK;

  for (int e = tid; e < TO * h1; e += THREADS) dhs[e] = 0.f;

  for (int t0 = 0; t0 < n_other; t0 += TT) {
    int off_o[2], off_t[2];  // row offsets of the built pairs; -1: none
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int m = tid / BK + 32 * q;
      const int o = o0 + m / TT;
      const int t = t0 + m % TT;
      const bool live = o < n_own && t < n_other;
      off_o[q] = live ? o * h1 : -1;
      off_t[q] = live ? t * h1 : 0;
    }
    float gv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t0 + ct + r;
      gv[r] = (co < n_own && t < n_other)
                  ? g[OWN_TXT ? (size_t)t * n_txt + co : (size_t)co * n_txt + t]
                  : 0.f;
    }

    // ---- z2 over all of H2; dz2 = g·w3 where z2 > 0, into shared memory
    for (int n0 = 0; n0 < h2; n0 += RN) {
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      float ra[2], rb[4];
      auto load = [&](int k0) {
        const int k = k0 + ak;
        const float bias = k < h1 ? b1[k] : 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q)
          ra[q] = (off_o[q] >= 0 && k < h1)
                      ? fmaxf(own[off_o[q] + k] + other[off_t[q] + k] + bias,
                              0.f)
                      : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = k0 + tid / RN + 2 * q;
          const int n = n0 + tid % RN;
          rb[q] = (kk < h1 && n < h2) ? w2[(size_t)kk * h2 + n] : 0.f;
        }
      };
      load(0);
      for (int k0 = 0; k0 < h1; k0 += BK) {
#pragma unroll
        for (int q = 0; q < 2; ++q) as[ak * RA_STRIDE + tid / BK + 32 * q] = ra[q];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bs[(tid / RN + 2 * q) * RB_STRIDE + tid % RN] = rb[q];
        __syncthreads();
        if (k0 + BK < h1) load(k0 + BK);  // in flight during the FMAs
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(as + kk * RA_STRIDE + ty * 4);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          float b[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) b[c] = bs[kk * RB_STRIDE + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = n0 + tx + 16 * c;
        const bool ok = n < h2;
        const float wn = ok ? w3[n] : 0.f;
        const float bias = ok ? b2[n] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dz2s[(ty * 4 + r) * h2s + n] =
              (ok && acc[r][c] + bias > 0.f) ? gv[r] * wn : 0.f;
      }
    }
    __syncthreads();  // dz2s complete

    // ---- dt = dz2·W2ᵀ in 128-column passes over H1; dz1 = dt where z1 > 0,
    // summed over the tile's other rows into the block's dh rows
    for (int m0 = 0; m0 < h1; m0 += RN) {
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      float rb[4];  // W2[m0 + tid/8 + 32q][k0 + tid % 8]
      auto load = [&](int k0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int mm = m0 + tid / BK + 32 * q;
          const int k = k0 + ak;
          rb[q] = (mm < h1 && k < h2) ? w2[(size_t)mm * h2 + k] : 0.f;
        }
      };
      load(0);
      for (int k0 = 0; k0 < h2; k0 += BK) {
#pragma unroll
        for (int q = 0; q < 4; ++q) bs[ak * RB_STRIDE + tid / BK + 32 * q] = rb[q];
        __syncthreads();
        if (k0 + BK < h2) load(k0 + BK);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = dz2s[(ty * 4 + r) * h2s + k0 + kk];
          float b[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) b[c] = bs[kk * RB_STRIDE + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int m = m0 + tx + 16 * c;
        float s = 0.f;
        if (m < h1 && co < n_own) {
          const float ho = own[(size_t)co * h1 + m];
          const float bias = b1[m];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t = t0 + ct + r;
            if (t < n_other && ho + other[(size_t)t * h1 + m] + bias > 0.f)
              s += acc[r][c];
          }
        }
        red[ty * RN + tx + 16 * c] = s;
      }
      __syncthreads();
      for (int e = tid; e < TO * RN; e += THREADS) {
        const int o = e / RN;
        const int mm = e % RN;
        if (m0 + mm < h1)
          dhs[o * h1 + m0 + mm] += red[(4 * o) * RN + mm] +
                                   red[(4 * o + 1) * RN + mm] +
                                   red[(4 * o + 2) * RN + mm] +
                                   red[(4 * o + 3) * RN + mm];
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < TO * h1; e += THREADS) {
    const int o = o0 + e / h1;
    if (o < n_own) dh[(size_t)o * h1 + e % h1] = dhs[e];
  }
}

// ---- dW2, db2, dw3, db3 -----------------------------------------------------
constexpr int WP = 256;            // pairs per tile
constexpr int WN = 16;             // columns of H2 per block
constexpr int WC = 8;              // pairs per stage of the dW2 product
constexpr int WA_STRIDE = WP + 4;

constexpr size_t W_SMEM_BYTES =
    sizeof(float) * ((size_t)WC * MAX_H1 + (size_t)WP * WN);

__global__ void __launch_bounds__(THREADS)
    bwd_w_kernel(const float* __restrict__ hi, const float* __restrict__ hj,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ w3,
                 const float* __restrict__ g, float* __restrict__ dw2p,
                 float* __restrict__ db2p, float* __restrict__ dw3p,
                 float* __restrict__ db3p, int n_img, int n_txt, int h1,
                 int h2) {
  extern __shared__ __align__(16) float smem[];
  float* tcs = smem;                  // [WC][MAX_H1] t rows of a stage
  float* dz2s = smem + WC * MAX_H1;   // [WP][WN]
  __shared__ __align__(16) float as[BK * WA_STRIDE];  // t slice [k][pair]
  __shared__ __align__(16) float bs[BK * WN];         // W2 slice [k][col]
  __shared__ int rowi[WP];   // h_img row offset of each pair; -1: none
  __shared__ int rowj[WP];
  __shared__ float gs[WP];
  __shared__ float red_b2[64 * WN];
  __shared__ float red_w3[64 * WN];
  __shared__ float red_b3[THREADS];

  const int n0 = blockIdx.x * WN;
  const int split = blockIdx.y;
  const long long pairs = (long long)n_img * n_txt;
  const long long tiles = (pairs + WP - 1) / WP;
  const long long tile_begin = tiles * split / gridDim.y;
  const long long tile_end = tiles * (split + 1) / gridDim.y;

  const int tid = threadIdx.x;
  const int mg = tid % 128;  // dW2 rows mg + 128r (r < 8) ...
  const int ng = tid / 128;  // ... and columns ng*8 + c (c < 8)
  const int py = tid / 4;    // z2 pairs py*4 + r ...
  const int nx = tid % 4;    // ... and columns nx*4 + c (r, c < 4)
  const int ak = tid % BK;   // t is built for pairs tid/8 + 32q at depth tid%8

  float accw[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) accw[r][c] = 0.f;
  float db2a[4] = {0.f, 0.f, 0.f, 0.f};
  float dw3a[4] = {0.f, 0.f, 0.f, 0.f};
  float db3a = 0.f;

  for (long long tile = tile_begin; tile < tile_end; ++tile) {
    {
      const long long p = tile * WP + tid;
      const bool live = p < pairs;
      rowi[tid] = live ? (int)(p / n_txt) * h1 : -1;
      rowj[tid] = live ? (int)(p % n_txt) * h1 : 0;
      gs[tid] = live ? g[p] : 0.f;
    }
    __syncthreads();

    // ---- z2 of the tile's pairs for this block's 16 columns
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    float ra[8];
    float rb = 0.f;
    auto load = [&](int k0) {
      const int k = k0 + ak;
      const float bias = k < h1 ? b1[k] : 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int m = tid / BK + 32 * q;
        const int oi = rowi[m];
        ra[q] = (oi >= 0 && k < h1)
                    ? fmaxf(hi[oi + k] + hj[rowj[m] + k] + bias, 0.f)
                    : 0.f;
      }
      if (tid < BK * WN) {
        const int kk = k0 + tid / WN;
        const int n = n0 + tid % WN;
        rb = (kk < h1 && n < h2) ? w2[(size_t)kk * h2 + n] : 0.f;
      }
    };
    load(0);
    for (int k0 = 0; k0 < h1; k0 += BK) {
#pragma unroll
      for (int q = 0; q < 8; ++q) as[ak * WA_STRIDE + tid / BK + 32 * q] = ra[q];
      if (tid < BK * WN) bs[tid] = rb;
      __syncthreads();
      if (k0 + BK < h1) load(k0 + BK);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(as + kk * WA_STRIDE + py * 4);
        const float4 b4 =
            *reinterpret_cast<const float4*>(bs + kk * WN + nx * 4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }
    // dz2 into shared memory; db2, dw3 (and db3 once per pair) partials
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + nx * 4 + c;
      const bool ok = n < h2;
      const float wn = ok ? w3[n] : 0.f;
      const float bias = ok ? b2[n] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pl = py * 4 + r;
        const float gp = gs[pl];
        const float z2 = acc[r][c] + bias;
        const float d = (ok && z2 > 0.f) ? gp * wn : 0.f;
        dz2s[pl * WN + nx * 4 + c] = d;
        db2a[c] += d;
        if (ok) dw3a[c] = fmaf(fmaxf(z2, 0.f), gp, dw3a[c]);
      }
    }
    if (nx == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) db3a += gs[py * 4 + r];
    }
    __syncthreads();  // dz2s complete

    // ---- dW2[:, cols] += tᵀ·dz2 over the tile's pairs, WC pairs a stage
    for (int pc = 0; pc < WP; pc += WC) {
#pragma unroll
      for (int w = 0; w < WC; ++w) {
        const int oi = rowi[pc + w];
        const int oj = rowj[pc + w];
        for (int m = tid; m < h1; m += THREADS)
          tcs[w * MAX_H1 + m] =
              oi >= 0 ? fmaxf(hi[oi + m] + hj[oj + m] + b1[m], 0.f) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < WC; ++w) {
        const float* drow = dz2s + (pc + w) * WN + ng * 8;
        const float4 d0 = *reinterpret_cast<const float4*>(drow);
        const float4 d1 = *reinterpret_cast<const float4*>(drow + 4);
        const float b[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int m = mg + 128 * r;
          const float a = m < h1 ? tcs[w * MAX_H1 + m] : 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) accw[r][c] = fmaf(a, b[c], accw[r][c]);
        }
      }
      __syncthreads();
    }
  }

  // this split's partials
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = mg + 128 * r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + ng * 8 + c;
      if (m < h1 && n < h2)
        dw2p[((size_t)split * h1 + m) * h2 + n] = accw[r][c];
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    red_b2[py * WN + nx * 4 + c] = db2a[c];
    red_w3[py * WN + nx * 4 + c] = dw3a[c];
  }
  red_b3[tid] = db3a;
  __syncthreads();
  if (tid < WN && n0 + tid < h2) {
    float s2 = 0.f, s3 = 0.f;
    for (int y = 0; y < 64; ++y) {
      s2 += red_b2[y * WN + tid];
      s3 += red_w3[y * WN + tid];
    }
    db2p[(size_t)split * h2 + n0 + tid] = s2;
    dw3p[(size_t)split * h2 + n0 + tid] = s3;
  }
  if (blockIdx.x == 0 && tid == 0) {
    float s = 0.f;
    for (int t = 0; t < THREADS; ++t) s += red_b3[t];
    db3p[split] = s;
  }
}

// ---- the fixed-order sums ---------------------------------------------------
__global__ void __launch_bounds__(THREADS)
    reduce_kernel(const float* __restrict__ dw2p,
                  const float* __restrict__ db2p,
                  const float* __restrict__ dw3p,
                  const float* __restrict__ db3p,
                  const float* __restrict__ dh_img, float* __restrict__ dw2,
                  float* __restrict__ db1, float* __restrict__ db2,
                  float* __restrict__ dw3, float* __restrict__ db3,
                  int splits, int n_img, int h1, int h2) {
  const long long nw = (long long)h1 * h2;
  const long long items = nw + 2LL * h2 + h1 + 1;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < items;
       e += (long long)gridDim.x * THREADS) {
    float s = 0.f;
    if (e < nw) {
      for (int k = 0; k < splits; ++k) s += dw2p[k * nw + e];
      dw2[e] = s;
    } else if (e < nw + h2) {
      const int n = (int)(e - nw);
      for (int k = 0; k < splits; ++k) s += db2p[(size_t)k * h2 + n];
      db2[n] = s;
    } else if (e < nw + 2LL * h2) {
      const int n = (int)(e - nw - h2);
      for (int k = 0; k < splits; ++k) s += dw3p[(size_t)k * h2 + n];
      dw3[n] = s;
    } else if (e < nw + 2LL * h2 + h1) {
      const int m = (int)(e - nw - 2LL * h2);
      for (int i = 0; i < n_img; ++i) s += dh_img[(size_t)i * h1 + m];
      db1[m] = s;
    } else {
      for (int k = 0; k < splits; ++k) s += db3p[k];
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

// dh = dh_img (txt = 0, grid over image rows) or dh_txt (txt = 1): (n, h1).
// hi: (n_img, h1), hj: (n_txt, h1), b1: (h1), w2: (h1, h2), b2, w3: (h2),
// g: (n_img, n_txt); float32, contiguous, on the device.
extern "C" int mimm_pairwise_critic_bwd_rows(const void* hi, const void* hj,
                                             const void* b1, const void* w2,
                                             const void* b2, const void* w3,
                                             const void* g, void* dh,
                                             int n_img, int n_txt, int h1,
                                             int h2, int txt, void* stream) {
  if (!shapes_ok(n_img, n_txt, h1, h2)) return (int)cudaErrorInvalidValue;
  const size_t smem = rows_smem_bytes(h1, h2);
  const int rows = txt ? n_txt : n_img;
  const unsigned blocks = (unsigned)((rows + TO - 1) / TO);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (txt) {
    err = cudaFuncSetAttribute(bwd_rows_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    bwd_rows_kernel<true><<<blocks, THREADS, smem, st>>>(
        static_cast<const float*>(hi), static_cast<const float*>(hj),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(w3),
        static_cast<const float*>(g), static_cast<float*>(dh), n_img, n_txt,
        h1, h2);
  } else {
    err = cudaFuncSetAttribute(bwd_rows_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    bwd_rows_kernel<false><<<blocks, THREADS, smem, st>>>(
        static_cast<const float*>(hi), static_cast<const float*>(hj),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(w3),
        static_cast<const float*>(g), static_cast<float*>(dh), n_img, n_txt,
        h1, h2);
  }
  return (int)cudaGetLastError();
}

// Per-split partials of dW2 (splits, h1, h2), db2 and dw3 (splits, h2) and
// db3 (splits); the grid is (ceil(h2 / 16), splits).
extern "C" int mimm_pairwise_critic_bwd_w(const void* hi, const void* hj,
                                          const void* b1, const void* w2,
                                          const void* b2, const void* w3,
                                          const void* g, void* dw2p,
                                          void* db2p, void* dw3p, void* db3p,
                                          int n_img, int n_txt, int h1, int h2,
                                          int splits, void* stream) {
  if (!shapes_ok(n_img, n_txt, h1, h2) || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)W_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h2 + WN - 1) / WN, splits);
  bwd_w_kernel<<<grid, THREADS, W_SMEM_BYTES,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hi), static_cast<const float*>(hj),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(g), static_cast<float*>(dw2p),
      static_cast<float*>(db2p), static_cast<float*>(dw3p),
      static_cast<float*>(db3p), n_img, n_txt, h1, h2);
  return (int)cudaGetLastError();
}

// dW2 (h1, h2), db2, dw3 (h2) from the split partials, db1 (h1) as the
// column sum of dh_img (n_img, h1), and db3 (1).
extern "C" int mimm_pairwise_critic_bwd_reduce(
    const void* dw2p, const void* db2p, const void* dw3p, const void* db3p,
    const void* dh_img, void* dw2, void* db1, void* db2, void* dw3, void* db3,
    int splits, int n_img, int h1, int h2, void* stream) {
  if (!shapes_ok(n_img, 1, h1, h2) || splits < 1)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)h1 * h2 + 2LL * h2 + h1 + 1;
  const unsigned blocks =
      (unsigned)(items < 4096LL * THREADS ? (items + THREADS - 1) / THREADS
                                          : 4096);
  reduce_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dw2p), static_cast<const float*>(db2p),
      static_cast<const float*>(dw3p), static_cast<const float*>(db3p),
      static_cast<const float*>(dh_img), static_cast<float*>(dw2),
      static_cast<float*>(db1), static_cast<float*>(db2),
      static_cast<float*>(dw3), static_cast<float*>(db3), splits, n_img, h1,
      h2);
  return (int)cudaGetLastError();
}
