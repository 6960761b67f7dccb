// Dense-layout f-gradient of the gossip objective, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel masked_factor_grad_pallas (body _kernel) in
// repro/kernels/masked_factor_grad/kernel.py.  For each block b of a stack
// of B blocks, X and mask (B, M, N), U (B, M, r), W (B, N, r):
//   R    = mask * (X - U W^T)
//   loss = ||R||^2,  gU = -2 R W,  gW = -2 R^T U
// The TPU kernel walks a sequential (M-tile, N-tile) grid on one core and
// carries gW in a VMEM-resident accumulator from one grid step to the
// next.  CTAs on this card run in parallel and in no order, so nothing can
// carry over between them.
//
// Bound on this card: bytes.  X and mask are 8 B per matrix entry and are
// read for 6r flops per entry (residual dot, gU, gW); at r = 15 that is
// ~11 flop/B, below the ~20 flop/B at which 67 TFLOP/s of f32 would bind
// before 3.35 TB/s.  The factors are small and stay in L2.
//
// Design: one launch, both sides, no atomics (deterministic).
//   side U  CTA (b, 32-row tile): keeps its U rows in shared memory,
//           streams 32-column tiles of W through shared memory, forms the
//           32x32 residual tile, accumulates gU rows in registers and a
//           fixed-order loss partial.
//   side W  CTA (b, 32-column tile): the mirror image -- keeps its W rows,
//           streams row tiles of U, accumulates gW rows in registers.
// This is the "second deterministic pass over column tiles" for the
// cross-tile gW reduction: X and mask are read twice (once per side),
// in exchange for no atomics and no scratch gradient.  Side U and side W
// CTAs of one block are adjacent in the grid, which gives the second read
// of a block's X and mask (7 MB at 1208x742) a chance to hit L2.  A last
// small kernel sums the loss partials in a fixed order.  Loads of X and mask have neighbouring lanes on
// neighbouring columns, and the next tile's X and mask are loaded into
// registers while the current tile is worked on; shared-memory factor rows
// use an odd stride so the strided reads of the dot products are free of
// bank conflicts.  The accumulator count a thread holds is a template
// parameter picked from r at launch, so a small rank keeps registers low
// and occupancy high.  Measured on an H100 80GB HBM3 at 700 W (PERF.md) it
// runs at about 10x its bound: the dot products and the tile products read
// their operands from shared memory, about two loads per multiply-add, and
// by count that traffic alone takes ~0.4 ms at these shapes.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxRank = 256;

// Fixed-order sum over a kThreads-wide CTA; the total lands in thread 0.
__device__ float block_sum(float v) {
  __shared__ float warp_tot[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kThreads / 32; ++i) t += warp_tot[i];
  }
  return t;
}

constexpr int kRows = kThreads / 32;                 // warps of a CTA
constexpr int kPer = kTile / kRows;                    // residuals a thread

// X and mask of one 32x32 tile into registers; lanes run along X's
// contiguous (column) axis.  Out-of-range elements read as 0.
__device__ __forceinline__ void load_tile(
    const float* __restrict__ Xb, const float* __restrict__ Mb, bool side_u,
    int o0, int s0, int own_n, int str_n, int N, int lane, int wy,
    float* xv, float* mv) {
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int a = wy + kRows * t;
    const int o = side_u ? a : lane;
    const int s = side_u ? lane : a;
    float xx = 0.f, mm = 0.f;
    if (o0 + o < own_n && s0 + s < str_n) {
      const long long xi = side_u ? (long long)(o0 + o) * N + (s0 + s)
                                  : (long long)(s0 + s) * N + (o0 + o);
      xx = Xb[xi];
      mm = Mb[xi];
    }
    xv[t] = xx;
    mv[t] = mm;
  }
}

// grid (ceil(M / kTile) + ceil(N / kTile), B): side-U CTAs first.
// SLOTS >= kTile * r / kThreads accumulators a thread (r <= 8 * SLOTS).
template <int SLOTS>
__global__ void __launch_bounds__(kThreads) masked_grad_kernel(
    const float* __restrict__ X, const float* __restrict__ Mk,
    const float* __restrict__ U, const float* __restrict__ W,
    float* __restrict__ gU, float* __restrict__ gW,
    float* __restrict__ partials, int M, int N, int r, int row_tiles) {
  extern __shared__ float smem[];
  const int rs = r | 1;                  // odd stride: no bank conflicts
  float* own = smem;                     // kTile x rs  this CTA's factor rows
  float* str = own + kTile * rs;         // kTile x rs  streamed factor rows
  float* R = str + kTile * rs;           // kTile x (kTile + 1)  R[own][str]

  const int b = blockIdx.y;
  const bool side_u = (int)blockIdx.x < row_tiles;
  const int o0 = (side_u ? blockIdx.x : blockIdx.x - row_tiles) * kTile;
  const int own_n = side_u ? M : N;
  const int str_n = side_u ? N : M;
  const float* A = (side_u ? U : W) + (long long)b * own_n * r;
  const float* S = (side_u ? W : U) + (long long)b * str_n * r;
  const float* Xb = X + (long long)b * M * N;
  const float* Mb = Mk + (long long)b * M * N;
  const int tid = threadIdx.x, lane = tid & 31, wy = tid >> 5;

  for (int f = tid; f < kTile * r; f += kThreads) {
    const int o = f / r, j = f % r;
    own[o * rs + j] = (o0 + o < own_n) ? A[(long long)(o0 + o) * r + j] : 0.f;
  }
  float acc[SLOTS];
#pragma unroll
  for (int t = 0; t < SLOTS; ++t) acc[t] = 0.f;
  float sq = 0.f;
  float xr[kPer], mr[kPer], xn[kPer] = {}, mn[kPer] = {};
  load_tile(Xb, Mb, side_u, o0, 0, own_n, str_n, N, lane, wy, xr, mr);

  for (int s0 = 0; s0 < str_n; s0 += kTile) {
    __syncthreads();                     // last tile's readers are done
    for (int f = tid; f < kTile * r; f += kThreads) {
      const int s = f / r, j = f % r;
      str[s * rs + j] = (s0 + s < str_n) ? S[(long long)(s0 + s) * r + j] : 0.f;
    }
    __syncthreads();
    // the next tile's X and mask are in flight while this one is worked on
    if (s0 + kTile < str_n)
      load_tile(Xb, Mb, side_u, o0, s0 + kTile, own_n, str_n, N, lane, wy,
                xn, mn);
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int a = wy + kRows * t;
      const int o = side_u ? a : lane;
      const int s = side_u ? lane : a;
      float rv = 0.f;
      if (o0 + o < own_n && s0 + s < str_n) {
        float pred = 0.f;
        for (int j = 0; j < r; ++j)
          pred = fmaf(own[o * rs + j], str[s * rs + j], pred);
        rv = mr[t] * (xr[t] - pred);
      }
      R[o * (kTile + 1) + s] = rv;
      sq = fmaf(rv, rv, sq);
    }
    __syncthreads();
    // g[o][j] += sum_s R[o][s] * str[s][j]
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int f = tid + kThreads * t;
      if (f < kTile * r) {
        const int o = f / r, j = f % r;
        float v = acc[t];
#pragma unroll 8
        for (int s = 0; s < kTile; ++s)
          v = fmaf(R[o * (kTile + 1) + s], str[s * rs + j], v);
        acc[t] = v;
      }
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      xr[t] = xn[t];
      mr[t] = mn[t];
    }
  }

  float* G = (side_u ? gU : gW) + (long long)b * own_n * r;
#pragma unroll
  for (int t = 0; t < SLOTS; ++t) {
    const int f = tid + kThreads * t;
    if (f < kTile * r) {
      const int o = f / r, j = f % r;
      if (o0 + o < own_n) G[(long long)(o0 + o) * r + j] = -2.f * acc[t];
    }
  }
  if (side_u) {                          // uniform per CTA
    const float tot = block_sum(sq);
    if (tid == 0) partials[(long long)b * row_tiles + blockIdx.x] = tot;
  }
}

// One CTA per block: loss[b] = fixed-order sum of its n partials.
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    float* __restrict__ loss, int n) {
  const int b = blockIdx.x;
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads)
    v += partials[(long long)b * n + i];
  const float t = block_sum(v);
  if (threadIdx.x == 0) loss[b] = t;
}

}  // namespace

#define RETURN_IF_ERROR()                        \
  do {                                           \
    const cudaError_t err_ = cudaGetLastError(); \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

extern "C" int mfg_num_partials(int M) { return (M + kTile - 1) / kTile; }

extern "C" int masked_factor_grad(
    const float* X, const float* Mk, const float* U, const float* W,
    float* loss, float* gU, float* gW, float* partials,
    int B, int M, int N, int r, void* stream) {
  if (B <= 0) return 0;
  if (B > 65535 || M <= 0 || N <= 0 || r < 1 || r > kMaxRank)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = mfg_num_partials(M);
  const int col_tiles = (N + kTile - 1) / kTile;
  const int rs = r | 1;
  const size_t smem = sizeof(float) * (2 * kTile * rs + kTile * (kTile + 1));
  const dim3 grid(row_tiles + col_tiles, B);
  const int slots = (kTile * r + kThreads - 1) / kThreads;
#define LAUNCH(SL)                                                          \
  if (slots <= SL) {                                                        \
    if (smem > 48 * 1024) {                                                 \
      cudaFuncSetAttribute(masked_grad_kernel<SL>,                          \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,     \
                           (int)smem);                                      \
      RETURN_IF_ERROR();                                                    \
    }                                                                       \
    masked_grad_kernel<SL><<<grid, kThreads, smem, st>>>(                   \
        X, Mk, U, W, gU, gW, partials, M, N, r, row_tiles);                 \
  } else
  LAUNCH(1) LAUNCH(2) LAUNCH(4) LAUNCH(8) LAUNCH(16) LAUNCH(32)
  return (int)cudaErrorInvalidValue;
#undef LAUNCH
  RETURN_IF_ERROR();
  sum_partials_kernel<<<B, kThreads, 0, st>>>(partials, loss, row_tiles);
  RETURN_IF_ERROR();
  return 0;
}
