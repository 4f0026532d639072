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
// have nothing to do here.  The design is about coalesced traffic.  The
// forward and dW: 64 x 4 threads, neighbouring threads on neighbouring
// columns, so each channel plane of y and dy is read or written in whole
// rows of 64 pixels; the 72 weights in registers; the forward's tile
// ((16+2) x (64+2) pixels) staged in shared memory, so each input pixel is
// read from device memory about once.  dx reads 8 channels for every pixel
// it writes, and its 8-channel tile with a division and a modulus per
// staged value made it instruction-bound (2.1 x cuDNN's time in bfloat16);
// it now keeps a rolling 3-row window in registers instead: each lane owns
// 4 adjacent pixels, loads them with one 16- or 8-byte vector load per
// channel and row, takes the halo columns from its neighbours by shuffle,
// and walks up the rows (see dx_kernel), reading each dy row once but for
// two halo rows per 16.
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
constexpr int TH = 16;        // forward tile rows
constexpr int DW_TH = 64;     // dW rows per block
constexpr int THREADS = TW * TY;
constexpr int RED_STRIDE = THREADS + 1;   // dW reduction rows, no conflicts
constexpr int RED_THREADS = 256;
constexpr int DX_PX = 4;              // dx: adjacent pixels a lane owns
constexpr int DX_COLS = 32 * DX_PX;   // a warp's strip of columns
constexpr int DX_ROWS = 16;           // output rows a warp walks
constexpr int DX_WARPS = 4;           // warps of a block, stacked in rows
constexpr int DX_THREADS = 32 * DX_WARPS;

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
// (dr, dc, c) in that order from zero.  A warp owns a strip of DX_COLS
// columns and DX_ROWS output rows of one image; each lane owns DX_PX
// adjacent pixels.  The warp walks dy UP its rows (r from the strip's last
// row + 1 to its first row − 1), one vector load per channel and lane
// (16 bytes in float32, 8 in bfloat16), the two halo columns from the
// neighbouring lanes by shuffle (the strip's edge lanes load theirs).  Row
// r is the dr = 0 row of output r − 1, the dr = 1 row of output r and the
// dr = 2 row of output r + 1, so walking upwards each output receives its
// terms in the plain version's order; three accumulators a pixel (outputs
// r + 1, r, r − 1) roll down as r does, and output r + 1 is stored when row
// r is in.  dy rows are read once but for the two halo rows per strip; no
// division, no shared tile.
// A lane's DX_PX = 4 pixels of one dy row and its halo pixel, kept as the
// raw 32-bit words they were loaded as (one aligned 16- or 8-byte vector
// load where the group lies inside and ``vec``: W and the base multiples of
// the vector; else element by element, zero past the edges), so that a
// prefetched row costs no instruction until it is used.
template <typename T>
struct RawPx;

template <>
struct RawPx<float> {
  static constexpr int WORDS = 4;
  __device__ static void load(const float* row, int j0, int W, bool vec,
                              unsigned (&w)[WORDS]) {
    if (vec && j0 + DX_PX <= W) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + j0);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < DX_PX; ++q)
        w[q] = j0 + q < W ? __float_as_uint(row[j0 + q]) : 0u;
    }
  }
  __device__ static unsigned one(const float* row, int j) {
    return __float_as_uint(row[j]);
  }
  __device__ static float px(const unsigned (&w)[WORDS], int q) {
    return __uint_as_float(w[q]);
  }
  __device__ static float halo(unsigned h) { return __uint_as_float(h); }
};

template <>
struct RawPx<__nv_bfloat16> {  // two pixels a word, the lower one low
  static constexpr int WORDS = 2;
  __device__ static void load(const __nv_bfloat16* row, int j0, int W,
                              bool vec, unsigned (&w)[WORDS]) {
    if (vec && j0 + DX_PX <= W) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + j0);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(row);
      w[0] = w[1] = 0u;
#pragma unroll
      for (int q = 0; q < DX_PX; ++q)
        if (j0 + q < W) w[q / 2] |= (unsigned)s[j0 + q] << (16 * (q % 2));
    }
  }
  __device__ static unsigned one(const __nv_bfloat16* row, int j) {
    return reinterpret_cast<const unsigned short*>(row)[j];
  }
  __device__ static float px(const unsigned (&w)[WORDS], int q) {
    return __uint_as_float(q % 2 ? w[q / 2] & 0xFFFF0000u : w[q / 2] << 16);
  }
  __device__ static float halo(unsigned h) { return __uint_as_float(h << 16); }
};

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
                 bf16_bits(v[2]) | bf16_bits(v[3]) << 16);
}

template <typename T>
__device__ __forceinline__ void store_px(T* row, int j0, int W, bool vec,
                                         const float (&val)[DX_PX]) {
  if (vec && j0 + DX_PX <= W) {
    store_vec(row + j0, val);
  } else {
#pragma unroll
    for (int q = 0; q < DX_PX; ++q)
      if (j0 + q < W) store(row + j0 + q, val[q]);
  }
}

template <typename TG, typename TO>
__global__ void __launch_bounds__(DX_THREADS)
dx_kernel(const TG* __restrict__ dy, const float* __restrict__ w,
          TO* __restrict__ dx, int H, int W, int vec_in, int vec_out) {
  using Raw = RawPx<TG>;
  __shared__ __align__(16) float ws[K][C];     // w[c, dr, dc] at [dr·3+dc][c]
  const int tid = threadIdx.x, lane = tid % 32;
  if (tid < C * K) ws[tid % K][tid / K] = w[tid];
  __syncthreads();
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * DX_COLS + lane * DX_PX;
  const int i0 = (blockIdx.y * DX_WARPS + tid / 32) * DX_ROWS;
  if (i0 >= H) return;                         // the whole warp
  const int i1 = min(i0 + DX_ROWS, H);
  const size_t plane = (size_t)H * W;
  const TG* gb = dy + (size_t)b * C * plane;
  TO* xb = dx + (size_t)b * plane;
  // the halo column an edge lane loads itself: lane 0 the strip's left
  // neighbour, lane 31 its right one; the others take theirs by shuffle
  const int jh = lane == 0 ? j0 - 1 : j0 + DX_PX;
  const bool edge = (lane == 0 || lane == 31) && jh >= 0 && jh < W;

  // row r: raw words of the lane's pixels and its halo pixel, per channel
  unsigned cur[C][Raw::WORDS], nxt[C][Raw::WORDS], hcur[C], hnxt[C];
  auto load_row = [&](int r, unsigned (&dst)[C][Raw::WORDS],
                      unsigned (&hal)[C]) {
    const bool in = r >= 0 && r < H;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const TG* row = gb + c * plane + (size_t)(in ? r : 0) * W;
      if (in) {
        Raw::load(row, j0, W, vec_in, dst[c]);
      } else {
#pragma unroll
        for (int e = 0; e < Raw::WORDS; ++e) dst[c][e] = 0u;
      }
      hal[c] = in && edge ? Raw::one(row, jh) : 0u;
    }
  };
  float acc[3][DX_PX];                         // outputs r + 1, r, r − 1
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int q = 0; q < DX_PX; ++q) acc[a][q] = 0.f;
  load_row(i1, cur, hcur);
  for (int r = i1; r >= i0 - 1; --r) {
    if (r > i0 - 1) load_row(r - 1, nxt, hnxt);  // in flight during the sums
    // v[c][1 + q]: pixel j0 + q, v[c][0] and v[c][DX_PX + 1] the halo
    // columns j0 − 1 and j0 + DX_PX
    float v[C][DX_PX + 2];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int q = 0; q < DX_PX; ++q) v[c][1 + q] = Raw::px(cur[c], q);
      const float left = __shfl_up_sync(0xffffffffu, v[c][DX_PX], 1);
      const float right = __shfl_down_sync(0xffffffffu, v[c][1], 1);
      const float own = Raw::halo(hcur[c]);
      v[c][0] = lane == 0 ? own : left;
      v[c][DX_PX + 1] = lane == 31 ? own : right;
    }
    // acc[2 - dr] receives its dr terms: (dc, c) in order
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float wk = ws[dr * 3 + dc][c];
#pragma unroll
          for (int q = 0; q < DX_PX; ++q)
            acc[2 - dr][q] =
                __fadd_rn(acc[2 - dr][q], __fmul_rn(v[c][q + 2 - dc], wk));
        }
    if (r + 1 >= i0 && r + 1 < i1)
      store_px(xb + (size_t)(r + 1) * W, j0, W, vec_out, acc[0]);
#pragma unroll
    for (int q = 0; q < DX_PX; ++q) {
      acc[0][q] = acc[1][q];
      acc[1][q] = acc[2][q];
      acc[2][q] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int e = 0; e < Raw::WORDS; ++e) cur[c][e] = nxt[c][e];
      hcur[c] = hnxt[c];
    }
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
  // vector loads and stores need W and the base a multiple of the vector
  const bool vec = W % DX_PX == 0;
  const int vec_in = vec && (size_t)dy % (DX_PX * sizeof(A)) == 0;
  const int vec_out = vec && (size_t)dx % (DX_PX * sizeof(Bt)) == 0;
  const dim3 grid((W + DX_COLS - 1) / DX_COLS,
                  (H + DX_WARPS * DX_ROWS - 1) / (DX_WARPS * DX_ROWS), B);
  dx_kernel<A, Bt><<<grid, DX_THREADS, 0, st>>>(
      (const A*)dy, (const float*)w, (Bt*)dx, H, W, vec_in, vec_out);
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
