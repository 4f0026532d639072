// Pairwise critic forward for Hopper (sm_90a): the scores of the 3-layer
// critic over every (image, text) pair,
//   S[i, j] = b3 + Σ_n w3[n] · relu(b2[n] + Σ_m t[i,j,m] · W2[m, n]),
//   t[i,j,m] = relu(h_img[i, m] + h_txt[j, m] + b1[m]),
// with h_img = X·W1[:768] and h_txt = Y·W1[768:] computed outside (plain
// GEMMs, as in JAX).  Everything is float32.
//
// Replaces the TPU kernel mimm_tpu/ops/pairwise_critic.py _fwd_kernel
// (:144, pallas_call in _fwd_call :181).  What carries over is what that
// kernel keeps out of device memory: no (B_img·B_txt, H1) or (B_img·B_txt,
// H2) tensor exists.  The pair activation t is rebuilt on the fly, 8
// columns of H1 at a time, in shared memory.  What does not carry over:
// the Mosaic one-hot expanders, the Sᵀ output layout and the row padding
// (TPU schedules).  S is written as (B_img, B_txt) row-major, and ragged
// edges are masked here.
//
// Bound at the GradCache shape B_img = B_txt = 2048, H1 = 1024, H2 = 512:
// one pair product, 2·P·H1·H2 = 4.40 TFLOP, 65.8 ms at the 67 TFLOP/s f32
// rate outside the tensor cores; the bytes (h rows, W2, S: ~25 MB) are
// negligible, so operations bound it.
//
// Design: one block of 256 threads per 128 consecutive pairs of the
// row-major pair index p = i·B_txt + j.  The block walks H2 in 128-column
// passes; each pass is a register-blocked f32 FMA product (each thread 8
// pairs × 8 columns) over H1 in 8-deep slices: the slice of t (built from
// the h rows, b1 and relu) and the slice of W2 are staged in shared memory,
// the next slice's global loads are issued before the current slice's
// FMAs.  The relu(·+b2)·w3 epilogue of a pass folds into 8 running sums a
// thread, so z2 never leaves registers; at the end the 16 column-threads of
// a pair are summed in a fixed order through shared memory (no atomics:
// the result is deterministic).  A simple first version on the CUDA cores;
// tensor cores (TF32 would bound the product at 8.9 ms), wgmma and TMA are
// later work.
//
// Interface: plain extern "C", raw device pointers and the stream; returns
// the cudaError_t of the launch (cudaErrorInvalidValue for shapes it does
// not take).  b3 is read on the device, so the step never syncs for it.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128;           // pairs per block
constexpr int BN = 128;           // columns of H2 per pass
constexpr int BK = 8;             // depth of a staged slice of H1
constexpr int A_STRIDE = BM + 4;  // padded: conflict-free transposed stores
constexpr int RED_STRIDE = 17;    // 16 column-threads + 1

__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const float* __restrict__ hi, const float* __restrict__ hj,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ w3,
               const float* __restrict__ b3, float* __restrict__ out,
               int n_img, int n_txt, int h1, int h2) {
  __shared__ __align__(16) float as[BK * A_STRIDE];  // t slice [k][pair]
  __shared__ __align__(16) float bs[BK * BN];        // W2 slice [k][col]
  __shared__ float red[BM * RED_STRIDE];

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // this thread's pairs: ty*8 .. ty*8+7
  const int tx = tid % 16;  // this thread's columns: tx + 16c, c < 8
  const long long pairs = (long long)n_img * n_txt;
  const long long p0 = (long long)blockIdx.x * BM;

  // The thread builds t for pairs tid/8 + 32q (q < 4) at depth tid % 8.
  const int ak = tid % BK;
  int off_i[4], off_j[4];  // row offsets into hi / hj; -1: past the end
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long p = p0 + tid / BK + 32 * q;
    off_i[q] = p < pairs ? (int)(p / n_txt) * h1 : -1;
    off_j[q] = p < pairs ? (int)(p % n_txt) * h1 : 0;
  }
  // ... and loads W2 rows tid/128 + 2q of the slice at column tid % 128.
  const int bk = tid / BN;
  const int bn = tid % BN;

  float ra[4], rb[4];
  auto load = [&](int k0, int n0) {
    const int k = k0 + ak;
    const float bias = k < h1 ? b1[k] : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ra[q] = (off_i[q] >= 0 && k < h1)
                  ? fmaxf(hi[off_i[q] + k] + hj[off_j[q] + k] + bias, 0.f)
                  : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = k0 + bk + 2 * q;
      rb[q] = (kk < h1 && n0 + bn < h2) ? w2[(size_t)kk * h2 + n0 + bn] : 0.f;
    }
  };

  float part[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) part[r] = 0.f;

  for (int n0 = 0; n0 < h2; n0 += BN) {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    load(0, n0);
    for (int k0 = 0; k0 < h1; k0 += BK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        as[ak * A_STRIDE + tid / BK + 32 * q] = ra[q];
        bs[(bk + 2 * q) * BN + bn] = rb[q];
      }
      __syncthreads();
      if (k0 + BK < h1) load(k0 + BK, n0);  // in flight during the FMAs
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(as + kk * A_STRIDE + ty * 8);
        const float4 a1 =
            *reinterpret_cast<const float4*>(as + kk * A_STRIDE + ty * 8 + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = bs[kk * BN + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }
    // epilogue of the pass: relu(z2 + b2) · w3 into the running sums
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < h2) {
        const float wn = w3[n];
        const float bias = b2[n];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          part[r] = fmaf(wn, fmaxf(acc[r][c] + bias, 0.f), part[r]);
      }
    }
  }

  // the 16 column-threads of each pair, summed in a fixed order
#pragma unroll
  for (int r = 0; r < 8; ++r) red[(ty * 8 + r) * RED_STRIDE + tx] = part[r];
  __syncthreads();
  if (tid < BM) {
    const long long p = p0 + tid;
    if (p < pairs) {
      float s = 0.f;
      for (int t = 0; t < 16; ++t) s += red[tid * RED_STRIDE + t];
      out[p] = s + b3[0];
    }
  }
}

}  // namespace

// hi: (n_img, h1), hj: (n_txt, h1), b1: (h1), w2: (h1, h2), b2: (h2),
// w3: (h2), b3: (1), out: (n_img, n_txt); all float32, contiguous, on the
// device.  Row offsets must fit in int: n·h1 < 2^31.  Returns a cudaError_t.
extern "C" int mimm_pairwise_critic_fwd(const void* hi, const void* hj,
                                        const void* b1, const void* w2,
                                        const void* b2, const void* w3,
                                        const void* b3, void* out, int n_img,
                                        int n_txt, int h1, int h2,
                                        void* stream) {
  if (n_img < 1 || n_txt < 1 || h1 < 1 || h2 < 1 ||
      (long long)n_img * h1 >= (1LL << 31) ||
      (long long)n_txt * h1 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)n_img * n_txt + BM - 1) / BM;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  fwd_kernel<<<(unsigned)blocks, THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hi), static_cast<const float*>(hj),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), n_img, n_txt,
      h1, h2);
  return (int)cudaGetLastError();
}
