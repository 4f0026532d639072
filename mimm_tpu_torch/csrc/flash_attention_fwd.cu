// Flash-attention forward for Hopper (sm_90a):
//   ctx = dropout(softmax(Q Kᵀ/√D + bias)) V.
//
// Replaces the TPU kernels mimm_tpu/ops/flash_attention.py _ws_fwd_kernel
// (whole-sample grid, pallas_call at :242) and _fwd_kernel ((b,h) grid,
// pallas_call at :252).  Both TPU grids compute one function; the grid was
// a TPU schedule, so one kernel serves both.  Numerics follow the TPU
// kernel (_probs, flash_attention.py:36-47, and _fwd_kernel :63-74):
//   S = Q·Kᵀ accumulated in f32, S = S*scale + bias (bias per key, f32),
//   row max, exp, sum and divide in f32 over the WHOLE row (no online
//   rescaling), then at rate > 0 P *= keep ? 1/(1-rate) : 0 in f32, P
//   rounded to the input dtype, P·V accumulated in f32, output stored in
//   the input dtype.  The keep bits are Philox4x32-10 (philox.cuh), a pure
//   function of (seed, b*H + h, i, j), so flash_attention_bwd.cu and the
//   plain PyTorch version regenerate the same mask.
//
// Bound at the serving shape (B,H,L,D) = (64,12,320,64): 2·2·B·H·L²·D =
// 20.1 GFLOP.  In bf16 the four (B,H,L,D) tensors are 125.8 MB: 37.6 µs at
// 3.35 TB/s against 20 µs of tensor-core time, so memory bounds it.  In f32
// they are 251.7 MB (75 µs) against 300 µs at the 67 TFLOP/s non-tensor-core
// f32 rate, so operations bound it.  Dropout adds one Philox call per four
// probabilities (B·H·L²/4 = 19.7 M calls of ~70 integer instructions).
//
// Design: one block of 256 threads per (tile of 32 query rows, head, sample).
// The tile's f32 score rows stay in shared memory (32 x L x 4 B, 64 KB at
// L=512, hence dynamic shared memory), so scores, probabilities and the
// dropout mask never reach device memory and each input is read from HBM
// about once (K and V re-reads for the L/32 query tiles of a head hit L2).
// K, then V, stream through shared memory in chunks of 64 keys, padded to a
// 65-float row stride so the column walks are free of bank conflicts.
// Products are f32 FMAs on the CUDA cores for both input types (bf16
// products are exact in f32): a simple first version whose rate is bounded
// by the 67 TFLOP/s f32 peak, so in bf16 it cannot reach the memory bound.
// Tensor-core products (mma.sync / wgmma), TMA loads and an online softmax
// are later work.
//
// Interface: plain extern "C", raw device pointers and the stream, returns
// the cudaError_t of the launch (cudaErrorInvalidValue for shapes it does
// not take: D != 64, L outside [1, 512]).  The seed is read on the device
// (an int32 tensor of one element), so a training step never syncs for it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int D = 64;
constexpr int BQ = 32;             // query rows per block
constexpr int BK = 64;             // keys per streamed K / V chunk
constexpr int THREADS = 256;
constexpr int MAX_L = 512;         // BERT max_position_embeddings
constexpr int KV_STRIDE = D + 1;   // padded row: conflict-free column walks
constexpr int ROW_GROUPS = THREADS / BK;   // 4
constexpr int RPT = BQ / ROW_GROUPS;       // 8 rows per thread

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

size_t smem_bytes(int L) {
  return sizeof(float) * (size_t)(BQ * D + BK * KV_STRIDE + BQ * L);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               const int* __restrict__ seed, T* __restrict__ out, int H,
               int L, float scale, int dropout, unsigned threshold,
               float keep_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][D]
  float* kv = qs + BQ * D;           // [BK][KV_STRIDE], K then V chunks
  float* s = kv + BK * KV_STRIDE;    // [BQ][L] scores, then probabilities

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)L * D;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;
  const float* bias_row = bias + (size_t)b * L;

  // A thread owns one column (a key in phase 1, a d in phase 3) and the
  // rows row0, row0+4, ..., row0+28.  A warp shares row0, so its reads of
  // qs and s are broadcasts.
  const int col = tid % BK;
  const int row0 = tid / BK;

  for (int i = tid; i < BQ * D; i += THREADS)
    qs[i] = (q0 + i / D < L) ? to_f32(qh[(size_t)q0 * D + i]) : 0.f;

  // ---- phase 1: S = Q Kᵀ * scale + bias ---------------------------------
  for (int k0 = 0; k0 < L; k0 += BK) {
    const int nk = min(BK, L - k0);
    __syncthreads();  // qs written / previous chunk consumed
    for (int i = tid; i < nk * D; i += THREADS)
      kv[(i / D) * KV_STRIDE + i % D] = to_f32(kh[(size_t)k0 * D + i]);
    __syncthreads();
    if (col < nk) {
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
      const float* kr = kv + col * KV_STRIDE;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          acc[i] = fmaf(qs[(row0 + ROW_GROUPS * i) * D + d], kd, acc[i]);
      }
      const float bj = bias_row[k0 + col];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        s[(row0 + ROW_GROUPS * i) * L + k0 + col] = acc[i] * scale + bj;
    }
  }
  __syncthreads();

  // ---- phase 2: whole-row softmax in f32, P rounded to T ----------------
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float* sr = s + r * L;
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
    if (!dropout) {
      for (int j = lane; j < L; j += 32)
        sr[j] = to_f32(from_f32<T>(sr[j] / sum));
      continue;
    }
    // dropout: each lane draws the words of four consecutive keys
    const unsigned bh = (unsigned)(b * H + h);
    const unsigned row = (unsigned)(q0 + r);
    const unsigned sd = (unsigned)__ldg(seed);
    for (int j4 = 4 * lane; j4 < L; j4 += 128) {
      const uint4 w = dropout_words(sd, bh, row, (unsigned)j4);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j4 + t;
        if (j < L) {
          const float p = sr[j] / sum;
          sr[j] = to_f32(from_f32<T>(word_at(w, t) >= threshold
                                         ? p * keep_scale : 0.f));
        }
      }
    }
  }

  // ---- phase 3: O = P V, f32 accumulation -------------------------------
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < L; k0 += BK) {
    const int nk = min(BK, L - k0);
    __syncthreads();  // softmax done / previous chunk consumed
    for (int i = tid; i < nk * D; i += THREADS)
      kv[(i / D) * KV_STRIDE + i % D] = to_f32(vh[(size_t)k0 * D + i]);
    __syncthreads();
    const float* vc = kv + col;
    const float* pc = s + k0;
    for (int j = 0; j < nk; ++j) {
      const float vj = vc[j * KV_STRIDE];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(pc[(row0 + ROW_GROUPS * i) * L + j], vj, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + row0 + ROW_GROUPS * i;
    if (r < L) out[head + (size_t)r * D + col] = from_f32<T>(acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* seed, void* out, int B,
                   int H, int L, float scale, int dropout,
                   unsigned threshold, float keep_scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(MAX_L));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  fwd_kernel<T><<<grid, THREADS, smem_bytes(L), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<T*>(out), H, L, scale,
      dropout, threshold, keep_scale);
  return cudaGetLastError();
}

__global__ void philox_kernel(const unsigned* __restrict__ in,
                              unsigned* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned* a = in + 6 * (size_t)i;
  const uint4 w = philox4x32_10(make_uint4(a[0], a[1], a[2], a[3]),
                                make_uint2(a[4], a[5]));
  out[4 * (size_t)i + 0] = w.x;
  out[4 * (size_t)i + 1] = w.y;
  out[4 * (size_t)i + 2] = w.z;
  out[4 * (size_t)i + 3] = w.w;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, out: (B, H, L, D) contiguous;
// bias: (B, L) float32 contiguous; seed: one int32 on the device, read only
// when dropout != 0 (keep iff Philox word >= threshold, kept probabilities
// times keep_scale).  Returns a cudaError_t.
extern "C" int mimm_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        const void* seed, void* out, int B,
                                        int H, int L, int head_dim,
                                        float scale, int dropout,
                                        unsigned threshold, float keep_scale,
                                        int dtype, void* stream) {
  if (head_dim != D || L < 1 || L > MAX_L || B < 1 || B > 65535 || H < 1 ||
      H > 65535 || (dropout && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, bias, seed, out, B, H, L, scale,
                              dropout, threshold, keep_scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, bias, seed, out, B, H, L,
                                      scale, dropout, threshold, keep_scale,
                                      st);
  return (int)cudaErrorInvalidValue;
}

// Philox4x32-10 on n (counter[4], key[2]) rows of uint32 -> n x 4 words:
// the generator of the dropout mask, exposed for its known-answer check.
extern "C" int mimm_philox4x32_10(const void* in, void* out, int n,
                                  void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  philox_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(in), static_cast<unsigned*>(out), n);
  return (int)cudaGetLastError();
}
