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
// in device memory: the rows here are loaded with bounds checks; the
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
// have nothing to do here, so each design is about feeding the memory
// system with few instructions.  All three walk rows with a rolling 3-row
// window in registers: a warp owns a strip of 32 x P adjacent columns,
// each lane P adjacent pixels, loaded with aligned vector loads (the next
// row in flight during the sums) and kept as the raw words they came in
// until used; the two halo columns come from the neighbouring lanes by
// shuffle, the strip's edge lanes load their own.  No shared tile, no
// division per value; ragged or unaligned widths take the same code's
// element-by-element path.
//
// The forward (fwd_kernel): P = 16 bytes of y (8 pixels in bfloat16, 4 in
// float32), so a lane writes each channel row as one 16-byte store, and y
// is 8/9 of the bytes.  To agree with the plain version to the bit it
// rounds each product and each running sum in tap order (__fmul_rn,
// __fadd_rn: no FMA), 72 FMUL + 64 FADD = 136 float32 instructions a
// pixel: 0.57 G lane operations at (64, 256, 256), 17-19 us of issue on 132
// SMs x 128 lanes at 1.75-1.98 GHz.  That issue floor of the unfused
// forward lies just under its 22.5 us byte bound in bfloat16, and every
// load, conversion, shuffle and address takes an issue slot from it; in
// float32 the bytes bind alone.  What binds it on the card is that the
// sums and the stores overlap: with the 72 weights in registers (105-142
// registers, 3-4 blocks an SM) an H100 took 62 / 32 us (float32 /
// bfloat16), about the issue time plus the time the card takes to write y
// alone (fill_: 3.2 TB/s); so the weights are read from shared memory as
// broadcasts, one read a tap and channel for P products, the registers are
// capped at 80 for FWD_BLOCKS = 6 blocks an SM, and the stores carry the
// streaming hint (58 / 28 us).  The grid is one wave (the blocks the card
// holds at once, asked of the runtime), each warp an equal share of the
// row strips, so no block waits on a tail.
//
// dW (dw_kernel + dw_reduce_kernel): the same walk over x, with dy read as
// one P-pixel vector a channel row (P = 16 bytes of dy), prefetched a row
// ahead like x; 72 FMA accumulators a lane (dW's tolerance allows FMA and
// another order of sums): 72 FMA a pixel, about half the byte bound's time
// in issue, so bytes bind it.  A fixed grid of DW_GRID blocks walks equal
// shares of the row strips; each warp adds its lanes' sums in a fixed
// shuffle tree, the block its warps' in a fixed order through shared
// memory, and writes one partial row of 72; a second pass adds those rows
// in a fixed order.  The grid does not depend on the card.
//
// dx (dx_kernel) reads 8 channels for every pixel it writes: P = 4, and
// its warp walks dy UP its rows so that each output receives its terms in
// the plain version's order, reading each dy row once but for two halo
// rows per 16.
//
// Interface: plain extern "C", raw device pointers and the stream; each
// entry point returns the cudaError_t of its launches
// (cudaErrorInvalidValue for shapes or dtype codes it does not take).
// Dtype codes: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "warp_mma.cuh"   // pack_bf16

namespace shallow_conv {

constexpr int C = 8;          // the stem's output channels
constexpr int K = 9;          // taps
constexpr unsigned FULL = 0xffffffffu;
constexpr int WALK_WARPS = 4;  // warps of a forward or dW block
constexpr int WALK_THREADS = 32 * WALK_WARPS;
constexpr int MIN_ROWS = 4;    // fewest row strips a warp gets on small shapes
constexpr int FWD_BLOCKS = 6;  // forward blocks an SM holds: <= 80 registers
constexpr int DW_GRID = 2 * 132;   // dW blocks: two on each SM of an H100
constexpr int RED_THREADS = 256;
constexpr int DX_PX = 4;              // dx: adjacent pixels a lane owns
constexpr int DX_COLS = 32 * DX_PX;   // a warp's strip of columns
constexpr int DX_ROWS = 16;           // output rows a warp walks
constexpr int DX_WARPS = 4;           // warps of a block, stacked in rows
constexpr int DX_THREADS = 32 * DX_WARPS;

// the pixels a lane owns in the forward (of y) and in dW (of dy): 16 bytes
template <typename T>
constexpr int VEC_PX = 16 / (int)sizeof(T);

// strips of 32·P columns across W
template <int P>
__host__ __device__ constexpr int strips(int W) {
  return (W + 32 * P - 1) / (32 * P);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// A lane's P adjacent pixels of one row, kept as the raw 32-bit words they
// were loaded as (aligned 16-byte vector loads, or one 8-byte load for 4
// bfloat16 pixels, where the group lies inside and ``vec``: W and the base
// multiples of the vector; else element by element, zero past the edges),
// so that a prefetched row costs no instruction until it is used.
template <typename T, int P>
struct RawPx;

template <int P>
struct RawPx<float, P> {
  static constexpr int WORDS = P;
  __device__ static void load(const float* row, int j0, int W, bool vec,
                              unsigned (&w)[WORDS]) {
    if (vec && j0 + P <= W) {
#pragma unroll
      for (int i = 0; i < P / 4; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(row + j0)[i];
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < P; ++q)
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

template <int P>
struct RawPx<__nv_bfloat16, P> {  // two pixels a word, the lower one low
  static constexpr int WORDS = P / 2;
  __device__ static void load(const __nv_bfloat16* row, int j0, int W,
                              bool vec, unsigned (&w)[WORDS]) {
    if (vec && j0 + P <= W) {
      if constexpr (P == 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(row + j0);
        w[0] = v.x;
        w[1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < P / 8; ++i) {
          const uint4 v = reinterpret_cast<const uint4*>(row + j0)[i];
          w[4 * i] = v.x;
          w[4 * i + 1] = v.y;
          w[4 * i + 2] = v.z;
          w[4 * i + 3] = v.w;
        }
      }
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
      for (int e = 0; e < WORDS; ++e) w[e] = 0u;
#pragma unroll
      for (int q = 0; q < P; ++q)
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

// vector stores with the streaming hint (__stcs: evict first), since no
// kernel here reads what it writes
template <int P>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[P]) {
#pragma unroll
  for (int i = 0; i < P / 4; ++i)
    __stcs(reinterpret_cast<float4*>(p) + i,
           make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]));
}
template <int P>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[P]) {
  if constexpr (P == 4) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])));
  } else {
#pragma unroll
    for (int i = 0; i < P / 8; ++i)
      __stcs(reinterpret_cast<uint4*>(p) + i,
             make_uint4(pack_bf16(v[8 * i], v[8 * i + 1]),
                        pack_bf16(v[8 * i + 2], v[8 * i + 3]),
                        pack_bf16(v[8 * i + 4], v[8 * i + 5]),
                        pack_bf16(v[8 * i + 6], v[8 * i + 7])));
  }
}

template <typename T, int P>
__device__ __forceinline__ void store_px(T* row, int j0, int W, bool vec,
                                         const float (&val)[P]) {
  if (vec && j0 + P <= W) {
    store_vec(row + j0, val);
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (j0 + q < W) store(row + j0 + q, val[q]);
  }
}

// ---- the forward and dW: a rolling window down the rows --------------------

// A lane's place in strip s of 32·P columns: its first column j0, and the
// halo column jh it loads itself if it is an edge lane (``edge``: lane 0
// loads the strip's left neighbour, lane 31 its right one, where they lie
// inside; the other lanes take theirs by shuffle).
template <int P>
struct StripLane {
  int j0, jh;
  bool edge;
  __device__ StripLane(int s, int lane, int W)
      : j0(s * 32 * P + lane * P), jh(lane == 0 ? j0 - 1 : j0 + P),
        edge((lane == 0 || lane == 31) && jh >= 0 && jh < W) {}
};

// One x row of a lane: its P pixels' raw words and its halo pixel's.
template <typename T, int P>
struct XRow {
  unsigned w[RawPx<T, P>::WORDS];
  unsigned h;
};

// x row r of one image, zeros outside [0, H).
template <typename T, int P>
__device__ __forceinline__ void load_x(const T* xb, int r, int H, int W,
                                       const StripLane<P>& at, bool vec,
                                       XRow<T, P>& d) {
  const bool in = r >= 0 && r < H;
  const T* row = xb + (size_t)(in ? r : 0) * W;
  if (in) {
    RawPx<T, P>::load(row, at.j0, W, vec, d.w);
  } else {
#pragma unroll
    for (int e = 0; e < RawPx<T, P>::WORDS; ++e) d.w[e] = 0u;
  }
  d.h = in && at.edge ? RawPx<T, P>::one(row, at.jh) : 0u;
}

// The row as P + 2 floats: v[1 + q] is pixel j0 + q, v[0] and v[P + 1] the
// halo columns j0 − 1 and j0 + P.  All 32 lanes take part (the shuffles).
template <typename T, int P>
__device__ __forceinline__ void unpack_x(const XRow<T, P>& d, int lane,
                                         float (&v)[P + 2]) {
#pragma unroll
  for (int q = 0; q < P; ++q) v[1 + q] = RawPx<T, P>::px(d.w, q);
  const float left = __shfl_up_sync(FULL, v[P], 1);
  const float right = __shfl_down_sync(FULL, v[1], 1);
  const float own = RawPx<T, P>::halo(d.h);
  v[0] = lane == 0 ? own : left;
  v[P + 1] = lane == 31 ? own : right;
}

// window[0..2] = window[1..2], then the next row in window[2]
template <typename T, int P>
__device__ __forceinline__ void roll(float (&v)[3][P + 2],
                                     const XRow<T, P>& next, int lane) {
#pragma unroll
  for (int q = 0; q < P + 2; ++q) {
    v[0][q] = v[1][q];
    v[1][q] = v[2][q];
  }
  unpack_x(next, lane, v[2]);
}

// The row strips of all images form one sequence, i = (s·B + b)·H + r
// (strip s, image b, row r).  Warp w of the grid's n takes [w·N / n, (w +
// 1)·N / n) of its N strips and walks them as runs of rows of one image and
// strip: run(s, b, first row, end row).  Neighbouring warps walk
// neighbouring rows, so the halo rows they both read are mostly L2 hits.
template <typename F>
__device__ __forceinline__ void walk_rows(long long N, int B, int H,
                                          F&& run) {
  const long long n = (long long)gridDim.x * WALK_WARPS;
  const long long w = (long long)blockIdx.x * WALK_WARPS + threadIdx.x / 32;
  long long i = w * N / n;
  const long long end = (w + 1) * N / n;
  while (i < end) {
    const long long sb = i / H;
    const int r = (int)(i - sb * H);
    const int rows = (int)(end - i < H - r ? end - i : H - r);
    run((int)(sb / B), (int)(sb % B), r, r + rows);
    i += rows;
  }
}

// y (B, C, H, W) from x (B, H, W).  At output row r a warp's window holds x
// rows r − 1, r and r + 1 as floats while row r + 2 is in flight.  Each
// channel's P outputs are summed as the plain version sums them, each
// product and then each running sum rounded (no fused multiply-add), in
// tap order k = dr·3 + dc, and stored as one vector.  The weights are read
// from shared memory as broadcasts, one a tap and channel for P products,
// so the kernel fits FWD_BLOCKS blocks an SM.
template <typename TI, typename TO>
__global__ void __launch_bounds__(WALK_THREADS, FWD_BLOCKS)
fwd_kernel(const TI* __restrict__ x, const float* __restrict__ w,
           TO* __restrict__ y, int B, int H, int W, int vec_in,
           int vec_out) {
  constexpr int P = VEC_PX<TO>;
  __shared__ float ws[C * K];                 // w[c, dr, dc] at [c·K + k]
  if (threadIdx.x < C * K) ws[threadIdx.x] = w[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const size_t plane = (size_t)H * W;
  walk_rows((long long)strips<P>(W) * B * H, B, H,
            [&](int s, int b, int ra, int rb) {
    const StripLane<P> at(s, lane, W);
    const TI* xb = x + (size_t)b * plane;
    TO* yb = y + (size_t)b * C * plane;
    XRow<TI, P> above, mid, next;
    load_x(xb, ra - 1, H, W, at, vec_in, above);
    load_x(xb, ra, H, W, at, vec_in, mid);
    load_x(xb, ra + 1, H, W, at, vec_in, next);
    float v[3][P + 2];                       // x rows r − 1, r, r + 1
    unpack_x(above, lane, v[0]);
    unpack_x(mid, lane, v[1]);
    unpack_x(next, lane, v[2]);
    for (int r = ra; r < rb; ++r) {
      if (r + 1 < rb) load_x(xb, r + 2, H, W, at, vec_in, next);
      TO* yr = yb + (size_t)r * W;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float o[P];
        const float w0 = ws[c * K];
#pragma unroll
        for (int q = 0; q < P; ++q) o[q] = __fmul_rn(v[0][q], w0);
#pragma unroll
        for (int k = 1; k < K; ++k) {
          const float wk = ws[c * K + k];
#pragma unroll
          for (int q = 0; q < P; ++q)
            o[q] = __fadd_rn(o[q], __fmul_rn(v[k / 3][q + k % 3], wk));
        }
        store_px(yr + c * plane, at.j0, W, vec_out, o);
      }
      if (r + 1 < rb) roll(v, next, lane);
    }
  });
}

template <typename TG, typename TO>
__global__ void __launch_bounds__(DX_THREADS)
dx_kernel(const TG* __restrict__ dy, const float* __restrict__ w,
          TO* __restrict__ dx, int H, int W, int vec_in, int vec_out) {
  using Raw = RawPx<TG, DX_PX>;
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

// Lanes l and l ^ M trade the halves of their first N sums that the other
// keeps, and add: lane l keeps the upper half where bit M of l is set.
template <int N, int M>
__device__ __forceinline__ void halve(float (&a)[C * K], int lane) {
  const bool upper = lane & M;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float give = upper ? a[i] : a[i + N / 2];
    const float keep = upper ? a[i + N / 2] : a[i];
    a[i] = keep + __shfl_xor_sync(FULL, give, M);
  }
}

// A warp's C·K sums over its 32 lanes, in a fixed order: three halvings
// (lanes 16, 8 and 4 apart) leave lane l with channel l / 4's K sums over
// the 8 lanes l ^ {0, 4, .., 28}, then two butterflies add the quad's.
// a[0..K) of lane l is then channel l / 4's total, the same bits in the
// four lanes of the quad (a + b = b + a).  81 shuffles, not 5 · 72.
__device__ __forceinline__ void warp_sum(float (&a)[C * K], int lane) {
  halve<C * K, 16>(a, lane);
  halve<C * K / 2, 8>(a, lane);
  halve<C * K / 4, 4>(a, lane);
#pragma unroll
  for (int m = 2; m >= 1; m /= 2)
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] += __shfl_xor_sync(FULL, a[k], m);
}

// dW, pass 1: each warp walks its share of the row strips as the forward
// does, and at row r adds the products of its window with dy row r (C
// channels, one P-pixel vector each, in flight a row ahead with x row r +
// 2) into C·K accumulators [c·K + k] by FMA.  Then warp_sum, the block's
// warps added in warp order through shared memory, and one partial row of
// C·K floats to part[block].
template <typename TI, typename TG>
__global__ void __launch_bounds__(WALK_THREADS)
dw_kernel(const TI* __restrict__ x, const TG* __restrict__ dy,
          float* __restrict__ part, int B, int H, int W, int vec_x,
          int vec_g) {
  constexpr int P = VEC_PX<TG>;
  using G = RawPx<TG, P>;
  __shared__ float red[WALK_WARPS][C * K];
  const int lane = threadIdx.x % 32;
  const size_t plane = (size_t)H * W;
  float acc[C * K];
#pragma unroll
  for (int j = 0; j < C * K; ++j) acc[j] = 0.f;
  walk_rows((long long)strips<P>(W) * B * H, B, H,
            [&](int s, int b, int ra, int rb) {
    const StripLane<P> at(s, lane, W);
    const TI* xb = x + (size_t)b * plane;
    const TG* gb = dy + (size_t)b * C * plane;
    auto load_g = [&](int r, unsigned (&dst)[C][G::WORDS]) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        G::load(gb + c * plane + (size_t)r * W, at.j0, W, vec_g, dst[c]);
    };
    XRow<TI, P> above, mid, next;
    unsigned g[C][G::WORDS], g_next[C][G::WORDS];   // dy rows r, r + 1
    load_x(xb, ra - 1, H, W, at, vec_x, above);
    load_x(xb, ra, H, W, at, vec_x, mid);
    load_x(xb, ra + 1, H, W, at, vec_x, next);
    load_g(ra, g);
    float v[3][P + 2];                       // x rows r − 1, r, r + 1
    unpack_x(above, lane, v[0]);
    unpack_x(mid, lane, v[1]);
    unpack_x(next, lane, v[2]);
    for (int r = ra; r < rb; ++r) {
      if (r + 1 < rb) {
        load_x(xb, r + 2, H, W, at, vec_x, next);
        load_g(r + 1, g_next);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float d[P];
#pragma unroll
        for (int q = 0; q < P; ++q) d[q] = G::px(g[c], q);
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int q = 0; q < P; ++q)
            acc[c * K + k] = fmaf(v[k / 3][q + k % 3], d[q], acc[c * K + k]);
      }
      if (r + 1 < rb) {
        roll(v, next, lane);
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int e = 0; e < G::WORDS; ++e) g[c][e] = g_next[c][e];
      }
    }
  });
  warp_sum(acc, lane);
  const int warp = threadIdx.x / 32;
  if (lane % 4 == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp][K * (lane / 4) + k] = acc[k];
  __syncthreads();
  if (threadIdx.x < C * K) {
    float sum = red[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < WALK_WARPS; ++i) sum += red[i][threadIdx.x];
    part[(size_t)blockIdx.x * (C * K) + threadIdx.x] = sum;
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

// whether a row of T at base p can move as P-pixel vectors: W a multiple
// of P and p aligned to the vector (16 bytes; 8 for 4 bfloat16 pixels)
template <typename T, int P>
int vec_ok(const void* p, int W) {
  constexpr size_t bytes = P * sizeof(T) < 16 ? P * sizeof(T) : 16;
  return W % P == 0 && (size_t)p % bytes == 0;
}

// blocks for ``strips`` row strips: ``most``, or fewer where a warp would
// get fewer than MIN_ROWS
inline int walk_blocks(long long strips, int most) {
  const long long want = (strips + WALK_WARPS * MIN_ROWS - 1)
                         / (WALK_WARPS * MIN_ROWS);
  return (int)(want < most ? want : most);
}

// the blocks of one wave of ``kernel`` on the current card: its SMs times
// the WALK_THREADS blocks an SM holds; 0 (a launch that fails) if the
// runtime cannot say
template <typename Kern>
int wave_blocks(Kern kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       WALK_THREADS, 0)
             != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// dW's blocks: DW_GRID, fewer on small shapes; counted in 128-column
// strips, so that the count needs no dtype
inline int dw_blocks(int B, int H, int W) {
  return walk_blocks((long long)strips<4>(W) * B * H, DW_GRID);
}

template <typename A, typename Bt>
cudaError_t launch_fwd(const void* x, const void* w, void* y, int B, int H,
                       int W, cudaStream_t st) {
  constexpr int P = VEC_PX<Bt>;
  static const int wave = wave_blocks(fwd_kernel<A, Bt>);
  const int grid = walk_blocks((long long)strips<P>(W) * B * H, wave);
  fwd_kernel<A, Bt><<<grid, WALK_THREADS, 0, st>>>(
      (const A*)x, (const float*)w, (Bt*)y, B, H, W, vec_ok<A, P>(x, W),
      vec_ok<Bt, P>(y, W));
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
  constexpr int P = VEC_PX<Bt>;
  const int grid = dw_blocks(B, H, W);
  dw_kernel<A, Bt><<<grid, WALK_THREADS, 0, st>>>(
      (const A*)x, (const Bt*)dy, (float*)part, B, H, W, vec_ok<A, P>(x, W),
      vec_ok<Bt, P>(dy, W));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_reduce_kernel<<<C * K, RED_THREADS, 0, st>>>(
      (const float*)part, (float*)dw, grid);
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
  return dw_blocks(B, H, W);
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
