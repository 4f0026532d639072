// Fused BERT FFN backward for Hopper (sm_90a), three kernels:
//
//   A   dg = dy·w2ᵀ, dh = T(dg ∘ gelu_tanh'(h_saved)), dx = dh·w1ᵀ
//       replaces mimm_tpu/ops/fused_ffn.py _bwd_a_kernel (:95, pallas_call
//       :180); dg never reaches device memory, dh is stored rounded to the
//       compute type and that rounded value feeds dx, as on the TPU.
//       bfloat16 (the production preset's type): csrc/fused_ffn_tc.cuh
//       tc_kernel<NJ, true>, the bf16 forward's tensor-core kernel
//       (mma.sync m16n8k16 fed by ldmatrix, 32 rows a block, 256-column
//       chunks of f with dh passed through shared memory, a two-slot
//       cp.async ring of weight stages) with both weights summed along
//       their rows (ldmatrix .trans).  Bound at (T, d, f) = (20480, 768,
//       3072): two products of 96.6 GFLOP at 989 TFLOP/s, 0.195 ms.
//       float32: csrc/fused_ffn.cuh row_tile_kernel<NJ, true> on
//       the CUDA cores, one block per 32 rows (TF32 keeps too few bits for
//       the f32 tolerance).
//   B1  dw1 = dhᵀ·x (f, d), db1 = Σ_rows dh, f32 sums
//       replaces _bwd_b1_kernel (:107, pallas_call :196).
//   B2  dw2 = (gᵀ·dy)ᵀ (d, f) with g = T(gelu_tanh(h_saved)) recomputed
//       from the saved h, never stored, f32 sums
//       replaces _bwd_b2_kernel (:120, pallas_call :208).
//
// The TPU kernels B1 and B2 add into one resident output across a
// sequential grid of row tiles.  Here both are one product C (f x d) = Aᵀ·B
// summed over K = T, A = dh or g (T, f) and B = x or dy (T, d), both
// row-major as the forward and backward A left them.
//
// bfloat16 (the production preset's type): wgrad_kernel<GELU_A, SUM_A>,
// on Hopper's wgmma
// (csrc/wgmma_bf16.cuh: m64n256k16, both operands MN-major from shared
// memory through the transpose bits, so the row-major tiles are used as
// they lie and no transposed copy is made).
//   * A block of two warpgroups owns a 128 (f) x 256 (d) tile of C, 64
//     rows of it a warpgroup (128 f32 accumulators a thread), and sums one
//     contiguous range of T: a split of T, so that the 72 tiles of
//     (20480, 768, 3072) become 360 blocks, 2.7 waves of the H100's 132
//     SMs (wg::splits: the fewest splits from two waves up whose waves
//     are at least 90 % full, at most one a 4 stages of T, so that a T of
//     fewer than 512 rows is one range).  Each block writes its f32
//     partial tile into a workspace the wrapper allocates;
//     wgrad_reduce_kernel adds the S partials in a fixed order into dw1 /
//     dw2 (and db1's partials likewise).  No atomics: two
//     calls give the same bits.  One range (S = 1) writes the outputs
//     directly and launches no reduce.
//   * The range is walked in stages of 64 rows of T: the A tile (2 panels
//     of 64 columns) and the B tile (4 panels) as 2-D TMA boxes in the
//     128-byte swizzle (hopper.cuh tma_load_2d: rows past T come as zeros,
//     so the ragged tail needs no mask), 48 KB a stage, into a ring of
//     RING = 4 stages on mbarriers.  Thread 0 issues the copies, and
//     refills a slot once all 256 threads have released it, a stage after
//     they did (the critic forward's scheme, csrc/pairwise_critic_fwd.cu:
//     a producer warp of its own would cap every thread's registers); the
//     copies run RING - 1 stages ahead.  A warpgroup issues a stage's 4
//     wgmma as one group and waits for the group before it, so the tensor
//     cores work on one stage while the threads wait for, and in B2
//     rewrite, the next.
//   * B2's GELU: each warpgroup rewrites its own A panel of a landed stage
//     in shared memory, h -> T(gelu_tanh(h)) with fused_ffn::gelu_tanh and
//     the round to nearest even of bwd_b2_plain, then fence.proxy.async
//     and the warpgroup's named barrier before its wgmma read the panel.
//     The round is pack_bf16's cvt.rn.bf16x2, to nearest even as
//     __float2bfloat16 and the plain version's .to(bfloat16).  Chosen over
//     an A operand in registers because the operand keeps B1's one
//     shared-memory layout and descriptor; the register form was not
//     tried.  The GELU runs d
//     / 256 times an element of h (3 at d = 768): at (20480, 768, 3072) B2
//     takes 0.357 device ms against B1's 0.201 (H100 80GB HBM3, 700 W,
//     chip_smoke.py time_ffn).
//   * B1's db1: the blocks of the first column tile sum their A panels'
//     columns while the stage is resident (each thread 8 columns of 4 rows
//     a stage), then the 16 row groups in order through shared memory.
//   * A tile past d (d % 256 = 128) loads only its panels inside d and
//     masks the columns past it when it stores.
// Bound at (20480, 768, 3072): one product of 96.6 GFLOP at 989 TFLOP/s,
// 0.0977 ms; the bytes (A and B once, 157 MB; C in f32, 9.4 MB) take
// 0.050 ms, so operations bound both.
//
// float32: acc_kernel<float, GELU_B, SUM_A> on the CUDA cores (TF32
// keeps too few bits for the f32 tolerance): each block one 128 x 128
// tile of the weight gradient walks all T rows in slices of 8, the next
// slice's global loads issued before the current slice's FMAs; no split
// of T.  db1 is the column sum of dh, taken by the blocks of the first
// tile column while they load it.  Bound 1.442 ms at the f32 CUDA-core
// rate (67 TFLOP/s).
//
// The gradients are written where torch.nn.Linear keeps the weights: dw1
// as (f, d), dw2 as (d, f).
//
// Interface: plain extern "C", raw device pointers and the stream; returns
// the cudaError_t of the launches.

#include "fused_ffn.cuh"
#include "fused_ffn_tc.cuh"
#include "hopper.cuh"
#include "wgmma_bf16.cuh"

namespace {

using fused_ffn::load4;
using fused_ffn::store4;

constexpr int THREADS = 256;
constexpr int TILE = 128;  // rows and columns of an output tile
constexpr int BK = 8;      // rows of T per staged slice

// c (M, N) = Σ_k a[k, :]ᵀ · b'[k, :] over the t rows of a (t, M) and b
// (t, N), with b' = T(gelu_tanh(b)) if GELU_B; colsum (M) = Σ_k a[k, :] if
// SUM_A.  M and N are multiples of 128; grid (N / 128, M / 128).
template <typename T, bool GELU_B, bool SUM_A>
__global__ void __launch_bounds__(THREADS)
    acc_kernel(const T* __restrict__ a, const T* __restrict__ b,
               float* __restrict__ c, float* __restrict__ colsum, int t,
               int M, int N) {
  __shared__ __align__(16) float as[BK * TILE];   // [k][m]
  __shared__ __align__(16) float bs[BK * TILE];   // [k][n]
  __shared__ float red[BK * TILE];

  const int tid = threadIdx.x;
  const int ty = tid / 16;          // rows ty*8 .. ty*8+7 of the tile
  const int tx = tid % 16;          // columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int lk = tid / 32;          // the slice row this thread loads
  const int lc = (tid % 32) * 4;    // ... and its 4 columns
  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;
  const bool sums = SUM_A && blockIdx.x == 0;

  float ra[4], rb[4];
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
  auto load = [&](int k0) {
    const int row = k0 + lk;
    if (row < t) {
      load4(a + (size_t)row * M + m0 + lc, ra);
      load4(b + (size_t)row * N + n0 + lc, rb);
      if (GELU_B) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rb[e] = fused_ffn::round_to<T>(fused_ffn::gelu_tanh(rb[e]));
      }
      if (sums) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cs[e] += ra[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) ra[e] = rb[e] = 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;

  load(0);
  for (int k0 = 0; k0 < t; k0 += BK) {
    store4(as + lk * TILE + lc, ra);
    store4(bs + lk * TILE + lc, rb);
    __syncthreads();
    if (k0 + BK < t) load(k0 + BK);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(as + kk * TILE + ty * 8);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * TILE + ty * 8 + 4);
      const float4 b0 =
          *reinterpret_cast<const float4*>(bs + kk * TILE + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * TILE + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float* row = c + (size_t)(m0 + ty * 8 + r) * N + n0;
    const float lo[4] = {acc[r][0], acc[r][1], acc[r][2], acc[r][3]};
    const float hi[4] = {acc[r][4], acc[r][5], acc[r][6], acc[r][7]};
    store4(row + tx * 4, lo);
    store4(row + 64 + tx * 4, hi);
  }

  if (sums) {  // the 8 loaders of each column, added in a fixed order
    store4(red + lk * TILE + lc, cs);
    __syncthreads();
    if (tid < TILE) {
      float s = 0.f;
      for (int q = 0; q < BK; ++q) s += red[q * TILE + tid];
      colsum[m0 + tid] = s;
    }
  }
}

template <typename T, bool GELU_B, bool SUM_A>
int launch_acc(const void* a, const void* b, void* c, void* colsum, int t,
               int M, int N, void* stream) {
  if (t < 1 || M < TILE || M % TILE || N < TILE || N % TILE ||
      (long long)t * (M > N ? M : N) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  acc_kernel<T, GELU_B, SUM_A><<<dim3(N / TILE, M / TILE), dim3(THREADS), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(c), static_cast<float*>(colsum), t, M, N);
  return (int)cudaGetLastError();
}

// ---- bfloat16: wgrad_kernel on wgmma ----------------------------------------

namespace wg {

constexpr int THREADS = 256;     // two warpgroups
constexpr int BM = 128;          // rows of C (f) a block: 64 a warpgroup
constexpr int BN = 256;          // columns of C (d) a block
constexpr int BK = 64;           // rows of T a stage
constexpr int RING = 4;          // stages in shared memory
constexpr int MIN_STAGES = 4;    // a range of T is at least 4 stages
constexpr unsigned PANEL_BYTES = BK * wgmma_bf16::ROW_BYTES;  // 8 KB
constexpr unsigned A_BYTES = (BM / wgmma_bf16::PANEL) * PANEL_BYTES;
constexpr unsigned STAGE_BYTES = A_BYTES + (BN / wgmma_bf16::PANEL) *
                                               PANEL_BYTES;  // 48 KB
constexpr size_t SMEM = 1024 + RING * STAGE_BYTES + 2 * RING * 8;
static_assert(2 * 16 * 64 * sizeof(float) <= STAGE_BYTES,
              "db1's row-group sums fit in the ring");

// the splits of T for (t, d, f) on a card of `sms` SMs: from two waves of
// one block an SM up, the fewest whose waves are at least 90 % full (else
// the fullest of up to twice as many), at most one a MIN_STAGES stages;
// then as many as ranges of ceil(stages / splits) stages take
int splits(int t, int d, int f, int sms) {
  const int stages = (t + BK - 1) / BK;
  const int tiles = f / BM * ((d + BN - 1) / BN);
  const int most = stages / MIN_STAGES > 1 ? stages / MIN_STAGES : 1;
  int s = 1;
  if (most > 1) {
    const int lo = (2 * sms + tiles - 1) / tiles;
    double fullest = 0.0;
    for (int c = lo; c <= 2 * lo; ++c) {
      const long long blocks = (long long)tiles * c;
      const double fill =
          (double)blocks / (double)((blocks + sms - 1) / sms * sms);
      if (fill > fullest) s = c, fullest = fill;
      if (fill >= 0.9) break;
    }
    s = s < most ? s : most;
  }
  const int per = (stages + s - 1) / s;
  return (stages + per - 1) / per;
}

// C (m_dim x n_dim) = Σ over one range of T of A[t, :]ᵀ · B[t, :], A (t x
// m_dim) and B (t x n_dim) bf16 by their tensor maps (boxes of BK rows x
// 64 columns); A' = T(gelu_tanh(A)) if GELU_A; colsum (m_dim) = Σ A[t, :]
// if SUM_A (the blocks of the first column tile).  Block (x, y, z): rows
// 128x of C, columns 256y, range z (stages [z·per, (z + 1)·per) of T).
// C element (m, n) is stored at out[z·m_dim·n_dim + m·ld_m + n·ld_n],
// colsum's at colsum[z·m_dim + m].
template <bool GELU_A, bool SUM_A>
__global__ void __launch_bounds__(THREADS, 1)
    wgrad_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b,
                 float* __restrict__ out, float* __restrict__ colsum, int t,
                 int m_dim, int n_dim, int per, int ld_m, int ld_n) {
  extern __shared__ __align__(16) float smem[];
  // the ring at a 1024-byte boundary, as the swizzled boxes need
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem) +
                        ((1024 - (smem_addr(smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING * STAGE_BYTES);
  uint64_t* empty = full + RING;
  const int tid = threadIdx.x, wgi = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int first = blockIdx.z * per;
  const int stages_t = (t + BK - 1) / BK;
  const int steps = stages_t - first < per ? stages_t - first : per;
  const int panels_b = (n_dim - n0) / wgmma_bf16::PANEL < 4
                           ? (n_dim - n0) / wgmma_bf16::PANEL
                           : 4;
  const unsigned bytes = A_BYTES + panels_b * PANEL_BYTES;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // stage j of the range into its slot, completing the slot's full barrier
  auto issue = [&](int j) {
    unsigned char* st = ring + (j % RING) * STAGE_BYTES;
    uint64_t* bar = &full[j % RING];
    const int row = (first + j) * BK;
    mbar_arrive_expect_tx(bar, bytes);
    for (int p = 0; p < BM / wgmma_bf16::PANEL; ++p)
      tma_load_2d(st + p * PANEL_BYTES, &tm_a, m0 + wgmma_bf16::PANEL * p,
                  row, bar);
    for (int p = 0; p < panels_b; ++p)
      tma_load_2d(st + A_BYTES + p * PANEL_BYTES, &tm_b,
                  n0 + wgmma_bf16::PANEL * p, row, bar);
  };
  if (tid == 0)
    for (int j = 0; j < steps && j < RING; ++j) issue(j);

  float acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  const bool sums = SUM_A && blockIdx.y == 0;
  const int cc = wt % 8, rg = wt / 8;  // db1: chunk cc of rows rg + 16i
  float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < steps; ++it) {
    const int slot = it % RING;
    unsigned char* st = ring + slot * STAGE_BYTES;
    unsigned char* a = st + wgi * PANEL_BYTES;  // this warpgroup's A panel
    mbar_wait(&full[slot], (it / RING) & 1);
    if (GELU_A) {  // h -> T(gelu_tanh(h)), 4 chunks of 8 a thread
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint4* p = reinterpret_cast<uint4*>(a + 16 * (wt + 128 * i));
        const uint4 v = *p;
        unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = pack_bf16(fused_ffn::gelu_tanh(__uint_as_float(w[e] << 16)),
                           fused_ffn::gelu_tanh(
                               __uint_as_float(w[e] & 0xFFFF0000u)));
        *p = make_uint4(w[0], w[1], w[2], w[3]);
      }
      fence_proxy_async();
      named_bar_sync(1 + wgi, 128);
    }
    if (sums) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i;
        const uint4 v = *reinterpret_cast<const uint4*>(
            a + r * wgmma_bf16::ROW_BYTES + ((cc ^ (r & 7)) << 4));
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cs[2 * e] += __uint_as_float(w[e] << 16);
          cs[2 * e + 1] += __uint_as_float(w[e] & 0xFFFF0000u);
        }
      }
    }
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16_bf16_mn(
          acc,
          wgmma_bf16::desc_mn_sw128(a + 16 * wgmma_bf16::ROW_BYTES * kk,
                                    PANEL_BYTES),
          wgmma_bf16::desc_mn_sw128(
              st + A_BYTES + 16 * wgmma_bf16::ROW_BYTES * kk, PANEL_BYTES));
    wgmma_commit();
    wgmma_wait<1>();  // the stage before this one is read
    if (it >= 1) {
      const int done = it - 1;
      mbar_arrive(&empty[done % RING]);
      // thread 0 refills that slot once all threads have released it
      if (tid == 0 && done + RING < steps) {
        mbar_wait(&empty[done % RING], (done / RING) & 1);
        issue(done + RING);
      }
    }
  }
  wgmma_wait<0>();
  wgmma_fence_acc(acc);

  // acc[4j + e]: row 16·warp + g + 8(e / 2) of this warpgroup's 64,
  // column 8j + 2q + e % 2; columns past n_dim are not stored
  float* dst = out + (size_t)blockIdx.z * m_dim * n_dim;
  const int row = m0 + 64 * wgi + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int n = n0 + 8 * j + 2 * q;
    if (n < n_dim) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[(size_t)(row + 8 * (e / 2)) * ld_m +
            (size_t)(n + e % 2) * ld_n] = acc[4 * j + e];
    }
  }
  if (sums) {  // the 16 row groups of each column, added in order
    __syncthreads();  // every warpgroup is done with the ring
    float* red = reinterpret_cast<float*>(ring);  // [2][16][64]
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(wgi * 16 + rg) * 64 + 8 * cc + e] = cs[e];
    __syncthreads();
    if (tid < 128) {
      const int w = tid / 64, col = tid % 64;
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += red[(w * 16 + r) * 64 + col];
      colsum[(size_t)blockIdx.z * m_dim + m0 + 64 * w + col] = s;
    }
  }
}

// out[i] = Σ_s ws[s·n + i] for i < n, then colsum_out[i] = Σ_s ws[S·n + s·c
// + i] for i < c (if colsum_out), s = 0 .. S - 1 in order; n, c in float4s
__global__ void wgrad_reduce_kernel(const float4* __restrict__ ws,
                                    float4* __restrict__ out,
                                    float4* __restrict__ colsum_out,
                                    long long n, int c, int splits) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* src = ws;
  float4* dst = out;
  long long stride = n;
  if (i >= n) {
    i -= n;
    if (colsum_out == nullptr || i >= c) return;
    src = ws + splits * n, dst = colsum_out, stride = c;
  }
  float4 s = src[i];
  for (int k = 1; k < splits; ++k) {
    const float4 v = src[k * stride + i];
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  dst[i] = s;
}

// floats of the workspace a launch at (t, d, f) takes: S partial tiles of
// C and of colsum, none for one range
long long workspace(int t, int d, int f, int sms) {
  const int s = splits(t, d, f, sms);
  return s > 1 ? (long long)s * ((long long)f * d + f) : 0;
}

// C (f x d) over the t rows of a (t, f) and b (t, d), bf16: C (m, n) to
// out[m·ld_m + n·ld_n]; colsum (f) = Σ a if SUM_A; ws of workspace(t, d,
// f, sms) floats
template <bool GELU_A, bool SUM_A>
int launch_wgrad(const void* a, const void* b, void* out, void* colsum,
                 void* ws, int t, int d, int f, int sms, int ld_m, int ld_n,
                 void* stream) {
  if (t < 1 || d < BM || d % BM || f < BM || f % BM || sms < 1 ||
      (long long)t * (d > f ? d : f) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int s = splits(t, d, f, sms);
  if (s > 1 && (ws == nullptr || reinterpret_cast<uintptr_t>(ws) % 16))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;
  int err = tmap_2d_bf16(&tm_a, a, t, f, BK);
  if (err == 0) err = tmap_2d_bf16(&tm_b, b, t, d, BK);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_kernel<GELU_A, SUM_A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const int per = ((t + BK - 1) / BK + s - 1) / s;
  float* c_out = static_cast<float*>(s > 1 ? ws : out);
  float* c_sum = s > 1 ? c_out + (size_t)s * f * d
                       : static_cast<float*>(colsum);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  wgrad_kernel<GELU_A, SUM_A><<<dim3(f / BM, (d + BN - 1) / BN, s), THREADS,
                                 SMEM, cs>>>(tm_a, tm_b, c_out, c_sum, t, f,
                                             d, per, ld_m, ld_n);
  e = cudaGetLastError();
  if (e != cudaSuccess || s == 1) return (int)e;
  const long long n4 = (long long)f * d / 4;
  const int c4 = SUM_A ? f / 4 : 0;
  wgrad_reduce_kernel<<<(unsigned)((n4 + c4 + 255) / 256), 256, 0, cs>>>(
      static_cast<const float4*>(ws), static_cast<float4*>(out),
      SUM_A ? static_cast<float4*>(colsum) : nullptr, n4, c4, s);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dy: (t, d); h: (t, f) as the forward saved it; w1: (f, d); w2: (d, f);
// dx: (t, d); dh: (t, f); contiguous, 16-byte aligned, all float32 (bf16 =
// 0) or all bfloat16 (bf16 = 1).  d = 128·n <= 1024, f a multiple of 128.
extern "C" int mimm_fused_ffn_bwd_a(const void* dy, const void* h,
                                    const void* w1, const void* w2, void* dx,
                                    void* dh, int t, int d, int f, int bf16,
                                    void* stream) {
  if (bf16)
    return fused_ffn_tc::dispatch<true>(dy, w2, w1, nullptr, nullptr, h, dx,
                                        dh, t, d, f, stream);
  return fused_ffn::dispatch_row_tile<true>(dy, w2, w1, nullptr, nullptr, h,
                                            dx, dh, t, d, f, stream);
}

// floats of the workspace that mimm_fused_ffn_bwd_b1 and _b2 take in
// bfloat16 on a card of `sms` SMs (0: one range of T, no workspace)
extern "C" long long mimm_fused_ffn_bwd_b_workspace(int t, int d, int f,
                                                    int sms) {
  return wg::workspace(t, d, f, sms);
}

// x: (t, d), dh: (t, f) in float32 or bfloat16; dw1: (f, d) and db1: (f),
// float32; ws: mimm_fused_ffn_bwd_b_workspace(t, d, f, sms) floats,
// 16-byte aligned (bfloat16 only).  d and f multiples of 128.
extern "C" int mimm_fused_ffn_bwd_b1(const void* x, const void* dh, void* dw1,
                                     void* db1, void* ws, int t, int d, int f,
                                     int bf16, int sms, void* stream) {
  if (bf16)
    return wg::launch_wgrad<false, true>(dh, x, dw1, db1, ws, t, d, f, sms, d,
                                         1, stream);
  return launch_acc<float, false, true>(dh, x, dw1, db1, t, f, d, stream);
}

// dy: (t, d), h: (t, f) in float32 or bfloat16; dw2: (d, f), float32; ws
// as for mimm_fused_ffn_bwd_b1.
extern "C" int mimm_fused_ffn_bwd_b2(const void* dy, const void* h, void* dw2,
                                     void* ws, int t, int d, int f, int bf16,
                                     int sms, void* stream) {
  if (bf16)
    return wg::launch_wgrad<true, false>(h, dy, dw2, nullptr, ws, t, d, f,
                                         sms, 1, f, stream);
  return launch_acc<float, true, false>(dy, h, dw2, nullptr, t, d, f, stream);
}
