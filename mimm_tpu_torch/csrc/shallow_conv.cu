// The ResNet stem's shallow 3x3 convolution for Hopper (sm_90a): one input
// channel, C = 8 output channels, stride 1, zero padding 1, and its two
// gradients.
//
//   forward  y[b,c,r,s] = Σ_{dr,dc} w[c,dr,dc] · x[b, r+dr-1, s+dc-1]
//   dW       dw[c,dr,dc] = Σ_{b,r,s} x[b, r+dr-1, s+dc-1] · dy[b,c,r,s]
//   dx       dx[b,i,j]  = Σ_{dr,dc,c} w[c,dr,dc] · dy[b, c, i+1-dr, j+1-dc]
//
// with x zero outside (H, W) and dy zero outside (H, W).  x is (B, H, W)
// (the NHWC image of one channel), y and dy (B, C, H, W) NCHW, w (C, 3, 3)
// float32 as torch.nn.Conv2d keeps conv1.weight, dw (C, 3, 3) float32.
//
// Replaces the TPU kernels of mimm_tpu/ops/shallow_conv.py: _fwd_kernel
// (:54, pallas_call :119), _dw_kernel (:73, :147) and _dx_kernel (:99,
// :160).  What carries over: every product and sum in float32, the image
// widened to float32 before it is used, the forward's taps summed in the
// order k = dr·3 + dc (:66-69) and the input gradient's in the order (dr,
// dc, c) from zero (:104-110), each output rounded once.  What does not:
// the zero-padded copies of x (JAX pads by 1, :187) and of dy (by 2, :159)
// in device memory: the tiles here are loaded with bounds checks; the
// sequential grid of the dW kernel, which adds every image into one (9, C)
// block: here each block writes a partial row of 72 sums and a second
// pass adds the partials in a fixed order (no atomics, so a rerun, remat
// and GradCache give the same bits).
//
// Bound at (B, H, W) = (64, 256, 256): 4.2 M pixels x 72 multiply-adds =
// 0.60 GFLOP, 9.0 us at 67 TFLOP/s, against the bytes each kernel must
// move: the forward reads x and writes y, 75.5 MB in bfloat16 (22.5 us at
// 3.35 TB/s) or 151 MB in float32 (45.1 us); dW reads x and dy, dx reads
// dy and writes dx, the same bytes.  Bytes bound all three; tensor cores
// have nothing to do here.  The design is about coalesced traffic:
// 64 x 4 threads, neighbouring threads on neighbouring columns, so each
// channel plane of y and dy is read or written in whole rows of 64 pixels;
// the 72 weights in registers; the forward and dx tiles ((16+2) x (64+2)
// pixels, of one channel or of all 8) staged in shared memory, so each
// input pixel is read from device memory about once.
//
// Interface: plain extern "C", raw device pointers and the stream; each
// entry point returns the cudaError_t of its launches
// (cudaErrorInvalidValue for shapes or dtype codes it does not take).
// Dtype codes: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace shallow_conv {

constexpr int C = 8;          // the stem's output channels
constexpr int K = 9;          // taps
constexpr int TW = 64;        // tile columns = threads in x
constexpr int TY = 4;         // threads in y
constexpr int TH = 16;        // forward / dx tile rows
constexpr int DW_TH = 64;     // dW rows per block
constexpr int THREADS = TW * TY;
constexpr int RED_STRIDE = THREADS + 1;   // dW reduction rows, no conflicts
constexpr int RED_THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// y (B, C, H, W) from x (B, H, W).  Block (TW, TY) threads owns a TH x TW
// tile of one image; each thread its column and every TY-th row, all C
// channels.  The sums round as the plain version's do: each product, then
// each running sum (no fused multiply-add), in tap order.
template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const TI* __restrict__ x, const float* __restrict__ w,
           TO* __restrict__ y, int H, int W) {
  __shared__ float tile[TH + 2][TW + 2];
  const int b = blockIdx.z, r0 = blockIdx.y * TH, s0 = blockIdx.x * TW;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const TI* xb = x + (size_t)b * H * W;
  for (int i = tid; i < (TH + 2) * (TW + 2); i += THREADS) {
    const int rr = i / (TW + 2), cc = i % (TW + 2);
    const int r = r0 - 1 + rr, s = s0 - 1 + cc;
    tile[rr][cc] = (r >= 0 && r < H && s >= 0 && s < W)
                       ? to_f(xb[(size_t)r * W + s]) : 0.f;
  }
  float wr[C * K];
#pragma unroll
  for (int j = 0; j < C * K; ++j) wr[j] = w[j];
  __syncthreads();
  const int s = s0 + threadIdx.x;
  const size_t plane = (size_t)H * W;
  TO* yb = y + (size_t)b * C * plane;
  for (int rr = threadIdx.y; rr < TH; rr += TY) {
    const int r = r0 + rr;
    if (r >= H || s >= W) continue;
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = tile[rr + k / 3][threadIdx.x + k % 3];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float acc = __fmul_rn(v[0], wr[c * K]);
#pragma unroll
      for (int k = 1; k < K; ++k)
        acc = __fadd_rn(acc, __fmul_rn(v[k], wr[c * K + k]));
      store(yb + c * plane + (size_t)r * W + s, acc);
    }
  }
}

// dx (B, H, W) from dy (B, C, H, W): the transposed stencil, summed over
// (dr, dc, c) in that order from zero, with the forward's tiling; the tile
// holds dy rows r0-1 .. r0+TH and columns s0-1 .. s0+TW of every channel.
template <typename TG, typename TO>
__global__ void __launch_bounds__(THREADS)
dx_kernel(const TG* __restrict__ dy, const float* __restrict__ w,
          TO* __restrict__ dx, int H, int W) {
  __shared__ float tile[C][TH + 2][TW + 2];
  const int b = blockIdx.z, r0 = blockIdx.y * TH, s0 = blockIdx.x * TW;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const size_t plane = (size_t)H * W;
  const TG* gb = dy + (size_t)b * C * plane;
  for (int i = tid; i < C * (TH + 2) * (TW + 2); i += THREADS) {
    const int c = i / ((TH + 2) * (TW + 2));
    const int rem = i % ((TH + 2) * (TW + 2));
    const int rr = rem / (TW + 2), cc = rem % (TW + 2);
    const int r = r0 - 1 + rr, s = s0 - 1 + cc;
    tile[c][rr][cc] = (r >= 0 && r < H && s >= 0 && s < W)
                          ? to_f(gb[c * plane + (size_t)r * W + s]) : 0.f;
  }
  float wr[C * K];
#pragma unroll
  for (int j = 0; j < C * K; ++j) wr[j] = w[j];
  __syncthreads();
  const int j = s0 + threadIdx.x;
  for (int ii = threadIdx.y; ii < TH; ii += TY) {
    const int i = r0 + ii;
    if (i >= H || j >= W) continue;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int dr = k / 3, dc = k % 3;
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc = __fadd_rn(acc, __fmul_rn(tile[c][ii + 2 - dr][threadIdx.x + 2 - dc],
                                       wr[c * K + k]));
    }
    store(dx + (size_t)b * plane + (size_t)i * W + j, acc);
  }
}

// dW, pass 1: block (TW, TY) threads owns DW_TH x TW pixels of one image;
// each thread adds its pixels' 72 products in registers (the 9 shifted x
// values through the cache, 8 dy values of one column), then the block adds
// its threads' sums through shared memory in a fixed order and writes one
// partial row of C·K floats, [c·K + k], to part[block].
template <typename TI, typename TG>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const TI* __restrict__ x, const TG* __restrict__ dy,
          float* __restrict__ part, int H, int W) {
  extern __shared__ __align__(16) float red[];   // [C·K][RED_STRIDE]
  const int b = blockIdx.z, r0 = blockIdx.y * DW_TH, s = blockIdx.x * TW
                                                         + threadIdx.x;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const size_t plane = (size_t)H * W;
  const TI* xb = x + (size_t)b * plane;
  const TG* gb = dy + (size_t)b * C * plane;
  float acc[C * K];
#pragma unroll
  for (int j = 0; j < C * K; ++j) acc[j] = 0.f;
  for (int rr = threadIdx.y; rr < DW_TH; rr += TY) {
    const int r = r0 + rr;
    if (r >= H || s >= W) continue;
    float v[K], g[C];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int rx = r + k / 3 - 1, sx = s + k % 3 - 1;
      v[k] = (rx >= 0 && rx < H && sx >= 0 && sx < W)
                 ? to_f(xb[(size_t)rx * W + sx]) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) g[c] = to_f(gb[c * plane + (size_t)r * W + s]);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[c * K + k] = fmaf(v[k], g[c], acc[c * K + k]);
  }
#pragma unroll
  for (int j = 0; j < C * K; ++j) red[j * RED_STRIDE + tid] = acc[j];
  __syncthreads();
  if (tid < C * K) {
    float sum = 0.f;
    for (int t = 0; t < THREADS; ++t) sum += red[tid * RED_STRIDE + t];
    const size_t blk = ((size_t)blockIdx.z * gridDim.y + blockIdx.y)
                       * gridDim.x + blockIdx.x;
    part[blk * (C * K) + tid] = sum;
  }
}

// dW, pass 2: block j adds column j of the (n, C·K) partials in a fixed
// order (each thread a strided run, then a tree over the threads).
__global__ void __launch_bounds__(RED_THREADS)
dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                 int n) {
  __shared__ float sums[RED_THREADS];
  const int j = blockIdx.x, t = threadIdx.x;
  float sum = 0.f;
  for (int i = t; i < n; i += RED_THREADS) sum += part[(size_t)i * (C * K) + j];
  sums[t] = sum;
  __syncthreads();
  for (int half = RED_THREADS / 2; half > 0; half /= 2) {
    if (t < half) sums[t] += sums[t + half];
    __syncthreads();
  }
  if (t == 0) dw[j] = sums[0];
}

inline bool shape_ok(int B, int H, int W, int Cout) {
  return B >= 1 && H >= 1 && W >= 1 && Cout == C
         && (long long)B * C * H * W < (1LL << 31);
}

inline dim3 tiles(int B, int H, int W, int rows) {
  return dim3((W + TW - 1) / TW, (H + rows - 1) / rows, B);
}

template <typename A, typename Bt>
cudaError_t launch_fwd(const void* x, const void* w, void* y, int B, int H,
                       int W, cudaStream_t st) {
  fwd_kernel<A, Bt><<<tiles(B, H, W, TH), dim3(TW, TY), 0, st>>>(
      (const A*)x, (const float*)w, (Bt*)y, H, W);
  return cudaGetLastError();
}

template <typename A, typename Bt>
cudaError_t launch_dx(const void* dy, const void* w, void* dx, int B, int H,
                      int W, cudaStream_t st) {
  dx_kernel<A, Bt><<<tiles(B, H, W, TH), dim3(TW, TY), 0, st>>>(
      (const A*)dy, (const float*)w, (Bt*)dx, H, W);
  return cudaGetLastError();
}

template <typename A, typename Bt>
cudaError_t launch_dw(const void* x, const void* dy, void* part, void* dw,
                      int B, int H, int W, cudaStream_t st) {
  const size_t smem = sizeof(float) * C * K * RED_STRIDE;
  cudaError_t err = cudaFuncSetAttribute(
      dw_kernel<A, Bt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = tiles(B, H, W, DW_TH);
  dw_kernel<A, Bt><<<grid, dim3(TW, TY), smem, st>>>(
      (const A*)x, (const Bt*)dy, (float*)part, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_reduce_kernel<<<C * K, RED_THREADS, 0, st>>>(
      (const float*)part, (float*)dw, (int)(grid.x * grid.y * grid.z));
  return cudaGetLastError();
}

// the four (input, output) dtype pairs of a launcher
#define SHALLOW_CONV_DISPATCH(LAUNCH, ta, tb, ...)                         \
  if ((ta) == 0 && (tb) == 0) return (int)LAUNCH<float, float>(__VA_ARGS__); \
  if ((ta) == 0 && (tb) == 1)                                              \
    return (int)LAUNCH<float, __nv_bfloat16>(__VA_ARGS__);                 \
  if ((ta) == 1 && (tb) == 0)                                              \
    return (int)LAUNCH<__nv_bfloat16, float>(__VA_ARGS__);                 \
  if ((ta) == 1 && (tb) == 1)                                              \
    return (int)LAUNCH<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);         \
  return (int)cudaErrorInvalidValue;

}  // namespace shallow_conv

using namespace shallow_conv;

// x (B, H, W) of dtype code x_dt; w (C, 3, 3) float32; y (B, C, H, W) of
// y_dt.  C must be 8.
extern "C" int mimm_shallow_conv_fwd(const void* x, const void* w, void* y,
                                     int B, int H, int W, int Cout, int x_dt,
                                     int y_dt, void* stream) {
  if (!shape_ok(B, H, W, Cout)) return (int)cudaErrorInvalidValue;
  SHALLOW_CONV_DISPATCH(launch_fwd, x_dt, y_dt, x, w, y, B, H, W,
                        (cudaStream_t)stream)
}

// The number of partial rows the dW entry point needs in ``part`` (each of
// C·K floats).
extern "C" int mimm_shallow_conv_dw_blocks(int B, int H, int W) {
  const dim3 grid = tiles(B, H, W, DW_TH);
  return (int)(grid.x * grid.y * grid.z);
}

// x (B, H, W) of x_dt; dy (B, C, H, W) of dy_dt; part: scratch of
// mimm_shallow_conv_dw_blocks(B, H, W) · C · 9 floats; dw (C, 3, 3) float32.
extern "C" int mimm_shallow_conv_dw(const void* x, const void* dy, void* part,
                                    void* dw, int B, int H, int W, int Cout,
                                    int x_dt, int dy_dt, void* stream) {
  if (!shape_ok(B, H, W, Cout)) return (int)cudaErrorInvalidValue;
  SHALLOW_CONV_DISPATCH(launch_dw, x_dt, dy_dt, x, dy, part, dw, B, H, W,
                        (cudaStream_t)stream)
}

// dy (B, C, H, W) of dy_dt; w (C, 3, 3) float32; dx (B, H, W) of dx_dt.
extern "C" int mimm_shallow_conv_dx(const void* dy, const void* w, void* dx,
                                    int B, int H, int W, int Cout, int dy_dt,
                                    int dx_dt, void* stream) {
  if (!shape_ok(B, H, W, Cout)) return (int)cudaErrorInvalidValue;
  SHALLOW_CONV_DISPATCH(launch_dx, dy_dt, dx_dt, dy, w, dx, B, H, W,
                        (cudaStream_t)stream)
}
