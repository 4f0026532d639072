// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV of
//   ctx = dropout(softmax(Q Kᵀ/√D + bias)) V
// given dO, with the forward's dropout mask regenerated from the seed.
//
// Replaces the TPU kernels mimm_tpu/ops/flash_attention.py _ws_bwd_kernel
// (whole-sample grid, :155, pallas_call at :274) and _bwd_kernel ((b,h)
// grid, :77, pallas_call at :284); both compute one function.  The dtype
// steps follow _bwd_kernel:
//   P recomputed in f32 (the forward's _probs); M = keep ? 1/(1-rate) : 0;
//   dV = round_T(P∘M)ᵀ · dO;  dP = (dO · Vᵀ) ∘ M;
//   dS = round_T(P ∘ (dP − rowsum(dP ∘ P)) · scale);
//   dQ = dS · K;  dK = dSᵀ · Q;
// every product accumulated in f32, every output stored in the input dtype
// T.  The bias gets no gradient (the JAX custom_vjp returns zeros).  The
// keep bits come from philox.cuh, the forward kernel's generator.
//
// Design: two passes, no atomics, deterministic.  The TPU kernel keeps a
// whole (L, L) tile per head in VMEM and walks the grid in order; on the
// card nothing carries between blocks, and dK/dV need sums over all
// queries while dQ needs sums over all keys.
//   pass 1, one block per (32 query rows, head, sample): recompute the
//     32 x L score rows and dO·Vᵀ rows in shared memory (2·32·L·4 B: 80 KB
//     at L=320, 128 KB at 512), form P, the masked dP, rowsum(dP∘P) and
//     dS, write dQ = dS·K, and write the row statistics (row max, row sum
//     of exp, rowsum(dP∘P)) as (3, B, H, L) f32 scratch;
//   pass 2, one block per (32 keys, head, sample): walk the queries in
//     chunks of 64, recompute those columns of P and dP from the row
//     statistics (the same f32 operation order as pass 1, so the same
//     values), and accumulate dV and dK for the block's keys in registers.
// Products are f32 FMAs on the CUDA cores for both input types, as in the
// forward kernel; tensor cores, TMA and wgmma are later work.
//
// Bound at the serving shape (B,H,L,D) = (64,12,320,64): the five products
// of the function, 5·2·B·H·L²·D = 50.3 GFLOP, take 0.751 ms at the 67
// TFLOP/s f32 rate and 50.9 µs at 989 TFLOP/s in bf16.  Its bytes, q, k,
// v, dO read and dQ, dK, dV written once, are 440 MB in f32 (131 µs at
// 3.35 TB/s) and 220 MB in bf16 (65.8 µs).  So operations bound it in f32
// (0.751 ms) and bytes in bf16 (65.8 µs).  This design does 7 products
// (Q·Kᵀ and dO·Vᵀ in both passes, then dS·K, Pᵀ·dO, dSᵀ·Q): 70.5 GFLOP,
// 1.05 ms at the f32 rate, and two Philox draws per probability (pass 1
// one call per four keys, pass 2 likewise).
//
// Interface: plain extern "C", raw device pointers and the stream; returns
// the cudaError_t of the launches (cudaErrorInvalidValue for shapes it does
// not take: D != 64, L outside [1, 512]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int D = 64;
constexpr int THREADS = 256;
constexpr int MAX_L = 512;
constexpr int STRIDE = D + 1;     // padded row: conflict-free column walks
// pass 1
constexpr int BQ = 32;            // query rows per block
constexpr int BK = 64;            // keys per streamed K / V chunk
constexpr int ROW_GROUPS = THREADS / BK;   // 4
constexpr int RPT = BQ / ROW_GROUPS;       // 8 rows per thread
// pass 2
constexpr int KT = 32;            // keys per block
constexpr int QC = 64;            // queries per chunk
constexpr int PS = KT + 1;        // padded row of the P / dS chunk tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round to T and back: the TPU kernel's .astype(in_dtype) before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_rows(int L) {
  return sizeof(float) * (size_t)(2 * BQ * D + BK * STRIDE + 2 * BQ * L);
}

size_t smem_cols() {
  return sizeof(float) *
         (size_t)(2 * KT * STRIDE + 2 * QC * STRIDE + 2 * QC * PS + 3 * QC);
}

// ---- pass 1: dQ and the row statistics ---------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const int* __restrict__ seed, const T* __restrict__ dout,
                    T* __restrict__ dq, float* __restrict__ stats, int B,
                    int H, int L, float scale, int dropout,
                    unsigned threshold, float keep_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][D]
  float* dos = qs + BQ * D;          // [BQ][D]
  float* kv = dos + BQ * D;          // [BK][STRIDE], K / V chunks
  float* s = kv + BK * STRIDE;       // [BQ][L] scores, then P (f32)
  float* dp = s + BQ * L;            // [BQ][L] dO·Vᵀ, then dS (rounded)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)L * D;
  const float* bias_row = bias + (size_t)b * L;

  // a thread owns one column (a key, then a d) and rows row0 + 4i
  const int col = tid % BK;
  const int row0 = tid / BK;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const bool in = q0 + i / D < L;
    qs[i] = in ? to_f32(q[head + (size_t)q0 * D + i]) : 0.f;
    dos[i] = in ? to_f32(dout[head + (size_t)q0 * D + i]) : 0.f;
  }

  // S = Q Kᵀ * scale + bias into s, then dO Vᵀ into dp (the forward's
  // loop, the same f32 operation order)
  for (int pass = 0; pass < 2; ++pass) {
    const T* src = (pass == 0 ? k : v) + head;
    const float* lhs = pass == 0 ? qs : dos;
    float* dst = pass == 0 ? s : dp;
    for (int k0 = 0; k0 < L; k0 += BK) {
      const int nk = min(BK, L - k0);
      __syncthreads();
      for (int i = tid; i < nk * D; i += THREADS)
        kv[(i / D) * STRIDE + i % D] = to_f32(src[(size_t)k0 * D + i]);
      __syncthreads();
      if (col < nk) {
        float acc[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
        const float* kr = kv + col * STRIDE;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float kd = kr[d];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            acc[i] = fmaf(lhs[(row0 + ROW_GROUPS * i) * D + d], kd, acc[i]);
        }
        if (pass == 0) {
          const float bj = bias_row[k0 + col];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            dst[(row0 + ROW_GROUPS * i) * L + k0 + col] = acc[i] * scale + bj;
        } else {
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            dst[(row0 + ROW_GROUPS * i) * L + k0 + col] = acc[i];
        }
      }
    }
  }
  __syncthreads();

  // per row: P, the masked dP, delta = rowsum(dP∘P), dS; one warp a row
  const int warp = tid / 32;
  const int lane = tid % 32;
  const unsigned bh = (unsigned)(b * H + h);
  const size_t plane = (size_t)B * H * L;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float* sr = s + r * L;
    float* dr = dp + r * L;
    const int row = q0 + r;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float delta = 0.f;
    if (!dropout) {
      for (int j = lane; j < L; j += 32) {
        const float p = sr[j] / sum;
        sr[j] = p;
        delta += dr[j] * p;
      }
    } else {
      const unsigned sd = (unsigned)__ldg(seed);
      for (int j4 = 4 * lane; j4 < L; j4 += 128) {
        const uint4 w = dropout_words(sd, bh, (unsigned)row, (unsigned)j4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = j4 + t;
          if (j < L) {
            const float p = sr[j] / sum;
            const float dpj =
                dr[j] * (word_at(w, t) >= threshold ? keep_scale : 0.f);
            sr[j] = p;
            dr[j] = dpj;
            delta += dpj * p;
          }
        }
      }
    }
    delta = warp_sum(delta);
    for (int j = lane; j < L; j += 32)
      dr[j] = round_to<T>((sr[j] * (dr[j] - delta)) * scale);
    if (lane == 0 && row < L) {
      const size_t at = ((size_t)b * H + h) * L + row;
      stats[at] = m;
      stats[plane + at] = sum;
      stats[2 * plane + at] = delta;
    }
  }

  // dQ = dS K: a thread owns one d and rows row0 + 4i
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  const T* kh = k + head;
  for (int k0 = 0; k0 < L; k0 += BK) {
    const int nk = min(BK, L - k0);
    __syncthreads();
    for (int i = tid; i < nk * D; i += THREADS)
      kv[(i / D) * STRIDE + i % D] = to_f32(kh[(size_t)k0 * D + i]);
    __syncthreads();
    const float* kc = kv + col;
    const float* dc = dp + k0;
    for (int j = 0; j < nk; ++j) {
      const float kj = kc[j * STRIDE];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(dc[(row0 + ROW_GROUPS * i) * L + j], kj, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + row0 + ROW_GROUPS * i;
    if (r < L) dq[head + (size_t)r * D + col] = from_f32<T>(acc[i]);
  }
}

// ---- pass 2: dK and dV --------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const int* __restrict__ seed, const T* __restrict__ dout,
                    const float* __restrict__ stats, T* __restrict__ dk,
                    T* __restrict__ dv, int B, int H, int L, float scale,
                    int dropout, unsigned threshold, float keep_scale) {
  extern __shared__ float smem[];
  float* ks = smem;                  // [KT][STRIDE]
  float* vs = ks + KT * STRIDE;      // [KT][STRIDE]
  float* qc = vs + KT * STRIDE;      // [QC][STRIDE]
  float* dc = qc + QC * STRIDE;      // [QC][STRIDE] dO chunk
  float* pt = dc + QC * STRIDE;      // [QC][PS] round_T(P∘M)
  float* st = pt + QC * PS;          // [QC][PS] dS (rounded)
  float* mrow = st + QC * PS;        // [QC] row max
  float* lrow = mrow + QC;           // [QC] row sum of exp
  float* drow = lrow + QC;           // [QC] rowsum(dP∘P)

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * KT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)L * D;
  const size_t plane = (size_t)B * H * L;
  const float* st_head = stats + ((size_t)b * H + h) * L;
  const unsigned bh = (unsigned)(b * H + h);
  const unsigned sd = dropout ? (unsigned)__ldg(seed) : 0u;

  for (int i = tid; i < KT * D; i += THREADS) {
    const bool in = j0 + i / D < L;
    ks[(i / D) * STRIDE + i % D] =
        in ? to_f32(k[head + (size_t)j0 * D + i]) : 0.f;
    vs[(i / D) * STRIDE + i % D] =
        in ? to_f32(v[head + (size_t)j0 * D + i]) : 0.f;
  }

  // scores: a thread owns 4 consecutive keys jg*4.. and queries qi, qi+32
  const int jg = tid % (KT / 4);     // 0..7
  const int qi = tid / (KT / 4);     // 0..31
  float bj[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = j0 + 4 * jg + u;
    bj[u] = j < L ? bias[(size_t)b * L + j] : 0.f;
  }
  // accumulation: a thread owns one d and keys kr0 + 4u
  const int dcol = tid % D;
  const int kr0 = tid / D;           // 0..3
  float acc_v[KT / 4], acc_k[KT / 4];
#pragma unroll
  for (int u = 0; u < KT / 4; ++u) acc_v[u] = acc_k[u] = 0.f;

  for (int c0 = 0; c0 < L; c0 += QC) {
    __syncthreads();  // previous chunk consumed
    for (int i = tid; i < QC * D; i += THREADS) {
      const bool in = c0 + i / D < L;
      qc[(i / D) * STRIDE + i % D] =
          in ? to_f32(q[head + (size_t)c0 * D + i]) : 0.f;
      dc[(i / D) * STRIDE + i % D] =
          in ? to_f32(dout[head + (size_t)c0 * D + i]) : 0.f;
    }
    for (int i = tid; i < QC; i += THREADS) {
      const bool in = c0 + i < L;
      mrow[i] = in ? st_head[c0 + i] : 0.f;
      lrow[i] = in ? st_head[plane + c0 + i] : 1.f;
      drow[i] = in ? st_head[2 * plane + c0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = qi + 32 * half;          // query within the chunk
      const float* qr = qc + i * STRIDE;
      const float* dor = dc + i * STRIDE;
      float sacc[4] = {0.f, 0.f, 0.f, 0.f};
      float pacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float qd = qr[d];
        const float dd = dor[d];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          sacc[u] = fmaf(qd, ks[(4 * jg + u) * STRIDE + d], sacc[u]);
          pacc[u] = fmaf(dd, vs[(4 * jg + u) * STRIDE + d], pacc[u]);
        }
      }
      const int row = c0 + i;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (dropout)
        w = dropout_words(sd, bh, (unsigned)row, (unsigned)(j0 + 4 * jg));
      const float m = mrow[i], l = lrow[i], delta = drow[i];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float pd = 0.f, ds = 0.f;
        if (row < L && j0 + 4 * jg + u < L) {
          const float s = sacc[u] * scale + bj[u];
          const float p = expf(s - m) / l;
          const float mk =
              dropout ? (word_at(w, u) >= threshold ? keep_scale : 0.f) : 1.f;
          pd = round_to<T>(dropout ? p * mk : p);
          const float dpv = dropout ? pacc[u] * mk : pacc[u];
          ds = round_to<T>((p * (dpv - delta)) * scale);
        }
        pt[i * PS + 4 * jg + u] = pd;
        st[i * PS + 4 * jg + u] = ds;
      }
    }
    __syncthreads();

    // dV += (P∘M)ᵀ dO, dK += dSᵀ Q over the chunk's queries
    for (int i = 0; i < QC; ++i) {
      const float dd = dc[i * STRIDE + dcol];
      const float qd = qc[i * STRIDE + dcol];
#pragma unroll
      for (int u = 0; u < KT / 4; ++u) {
        acc_v[u] = fmaf(pt[i * PS + kr0 + 4 * u], dd, acc_v[u]);
        acc_k[u] = fmaf(st[i * PS + kr0 + 4 * u], qd, acc_k[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < KT / 4; ++u) {
    const int j = j0 + kr0 + 4 * u;
    if (j < L) {
      dv[head + (size_t)j * D + dcol] = from_f32<T>(acc_v[u]);
      dk[head + (size_t)j * D + dcol] = from_f32<T>(acc_k[u]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* seed, const void* dout,
                   void* dq, void* dk, void* dv, void* stats, int B, int H,
                   int L, float scale, int dropout, unsigned threshold,
                   float keep_scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_rows(MAX_L));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_cols_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_cols());
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* bt = static_cast<const float*>(bias);
  const int* sp = static_cast<const int*>(seed);
  float* stt = static_cast<float*>(stats);
  bwd_rows_kernel<T><<<dim3((L + BQ - 1) / BQ, H, B), THREADS, smem_rows(L),
                       stream>>>(qt, kt, vt, bt, sp, dot, static_cast<T*>(dq),
                                 stt, B, H, L, scale, dropout, threshold,
                                 keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_cols_kernel<T><<<dim3((L + KT - 1) / KT, H, B), THREADS, smem_cols(),
                       stream>>>(qt, kt, vt, bt, sp, dot, stt,
                                 static_cast<T*>(dk), static_cast<T*>(dv), B,
                                 H, L, scale, dropout, threshold, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, dout, dq, dk, dv: (B, H, L, D)
// contiguous; bias: (B, L) float32; seed: one int32 on the device, read only
// when dropout != 0; stats: 3·B·H·L float32 scratch.  Returns a cudaError_t.
extern "C" int mimm_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* seed, const void* dout, void* dq, void* dk, void* dv,
    void* stats, int B, int H, int L, int head_dim, float scale, int dropout,
    unsigned threshold, float keep_scale, int dtype, void* stream) {
  if (head_dim != D || L < 1 || L > MAX_L || B < 1 || B > 65535 || H < 1 ||
      H > 65535 || (dropout && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, bias, seed, dout, dq, dk, dv, stats, B,
                              H, L, scale, dropout, threshold, keep_scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, bias, seed, dout, dq, dk, dv,
                                      stats, B, H, L, scale, dropout,
                                      threshold, keep_scale, st);
  return (int)cudaErrorInvalidValue;
}
