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
// before 3.35 TB/s: 185 MB, 0.055 ms, for the 5 x 5 stack of 1208 x 742
// blocks.  The factors are small and stay in L2.
//
// Design: one launch, both sides, no atomics (deterministic).
//   side U  CTA (b, tile of own rows): walks 32-column tiles of X, mask and
//           W, accumulates its gU rows and a fixed-order loss partial.
//   side W  CTA (b, 32-column tile): the mirror image -- walks 32-row
//           tiles of X, mask and U, accumulates its gW rows.
// This is the "second deterministic pass over column tiles" for the
// cross-tile gW reduction: X and mask are still read twice (once per
// side), in exchange for no atomics and no scratch gradient; reading them
// once would need a cross-CTA reduction of gW, which is left for later.
// Side U and side W CTAs of one block are adjacent in the grid, which
// gives the second read of a block's X and mask (7 MB at 1208x742) a
// chance to hit L2.  A last small kernel sums the loss partials in a fixed
// order.  Loads of X and mask have neighbouring lanes on neighbouring
// columns, and the next tile's X and mask (and, for r <= 32, the next
// streamed factor rows) are loaded into registers while the current tile
// is worked on.
//
// Which kernel runs is chosen by r in the C entry:
//   r <= 32       reg_grad_kernel<RK>, RK = 4, 8, 16 or 32 (components from
//                 r to RK are zero in registers and never stored).  The
//                 factors sit in registers:
//                 - side U: warp w owns rows w + 8t (t < ROWS, ROWS = 4,
//                   4, 2, 1 for RK = 4, 8, 16, 32, so an own tile has 32,
//                   32, 16 or 8 rows and no thread holds more than ~100
//                   values); a thread keeps its ROWS U rows and their gU
//                   partials in registers for the whole walk.  Per column
//                   tile, lane l reads W row s0 + l from shared memory
//                   once (RK/4 float4 loads), then forms pred, R, R^2 and
//                   the gU update for each own row in registers.  After the
//                   walk a transposing butterfly over the warp's lanes
//                   (fixed order) leaves each lane one sum to write.
//                 - side W: lane l keeps W row c0 + l and its gW partial in
//                   registers; warp w reads U rows s0 + w + 8t as broadcast
//                   float4 loads, each feeding two FMAs (dot and gradient).
//                   The 8 warps' partials are added through shared memory
//                   in warp order.
//   32 < r <= 256 masked_grad_kernel<SLOTS>: the factor rows of both
//                 operands in shared memory, a 32x32 residual tile in
//                 shared memory, accumulators spread over the CTA.
// Shared-memory loads per 32x32 tile of one side at r = 15 (warp
// instructions): masked_grad_kernel reads both operands of every FMA,
// 2 x 2 x 1024 x 15 = 61,440 scalar loads, ~1,920 instructions;
// reg_grad_kernel<16> reads 4 float4 a streamed row: side U 2 x 8 x 4 = 64
// (two 16-row tiles), side W 8 x 4 x 4 = 128 (broadcast), 15-30x fewer.
// Measured times are in PERF.md.

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

// X and mask of one (kRows * PER) x 32 tile into registers (32x32 at the
// default PER); lanes run along X's contiguous (column) axis.  Out-of-range
// elements read as 0.
template <int PER = kPer>
__device__ __forceinline__ void load_tile(
    const float* __restrict__ Xb, const float* __restrict__ Mb, bool side_u,
    int o0, int s0, int own_n, int str_n, int N, int lane, int wy,
    float* xv, float* mv) {
#pragma unroll
  for (int t = 0; t < PER; ++t) {
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

// ---- r <= 32: factors in registers ---------------------------------------

// Own rows a side-U thread holds at rank template RK: at most ~100 values a
// thread (U rows, gU partials, the streamed row).
__host__ __device__ constexpr int own_rows(int rk) {
  return rk <= 8 ? 4 : rk <= 16 ? 2 : 1;
}
constexpr int kMinOwnTile = kRows * own_rows(32);     // smallest own tile

// Stride of a staged factor row in floats: a multiple of 4 for float4
// loads, with an odd count of 16-byte units so that the lanes' rows of a
// quarter warp fall in distinct bank groups.
template <int RK>
__host__ __device__ constexpr int stage_stride() {
  return ((RK / 4) & 1) ? RK : RK + 4;
}

// Streamed factor rows s0..s0+31 (components 0..RK-1, zero past r and past
// str_n), a share of kTile * RK values a thread, into registers ...
template <int RK>
__device__ __forceinline__ void fetch_rows(
    const float* __restrict__ S, int s0, int str_n, int r, int tid,
    float* sv) {
  constexpr int kShare = (kTile * RK + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < kShare; ++i) {
    const int f = tid + kThreads * i, s = f / RK, k = f % RK;
    sv[i] = (f < kTile * RK && s0 + s < str_n && k < r)
                ? S[(long long)(s0 + s) * r + k] : 0.f;
  }
}

// ... and from there into shared memory.
template <int RK>
__device__ __forceinline__ void stage_rows(const float* sv, int tid,
                                           float* str) {
  constexpr int kShare = (kTile * RK + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < kShare; ++i) {
    const int f = tid + kThreads * i;
    if (f < kTile * RK) str[(f / RK) * stage_stride<RK>() + f % RK] = sv[i];
  }
}

// One staged row into registers, RK / 4 float4 loads.
template <int RK>
__device__ __forceinline__ void read_row(const float* str, int s, float* v) {
  const float4* p =
      reinterpret_cast<const float4*>(str + s * stage_stride<RK>());
#pragma unroll
  for (int q = 0; q < RK / 4; ++q) {
    const float4 f = p[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

// Transposing butterfly over a warp's lanes: v[0..N) of every lane are
// summed lane-wise in a fixed order.  Each step halves the values a lane
// keeps, so after it lane l holds in v[i] (i < max(N / 32, 1)) the total of
// value index (l / max(32 / N, 1)) * max(N / 32, 1) + i.
template <int N, int OFF>
__device__ __forceinline__ void lane_reduce_scatter(float* v, int lane) {
  if constexpr (N > 1) {
    constexpr int H = N / 2;
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    if constexpr (OFF > 1) lane_reduce_scatter<H, OFF / 2>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
    if constexpr (OFF > 1) lane_reduce_scatter<1, OFF / 2>(v, lane);
  }
}

// Side U: this CTA owns rows o0..o0+kRows*ROWS-1 of block b.
template <int RK, int ROWS>
__device__ __forceinline__ void reg_side_u(
    const float* __restrict__ Xb, const float* __restrict__ Mb,
    const float* __restrict__ A, const float* __restrict__ S,
    float* __restrict__ G, float* __restrict__ partial, float* str, int o0,
    int M, int N, int r) {
  const int tid = threadIdx.x, lane = tid & 31, wy = tid >> 5;
  constexpr int kShare = (kTile * RK + kThreads - 1) / kThreads;
  float a[ROWS][RK], acc[ROWS][RK];
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    const int o = o0 + wy + kRows * t;
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      a[t][k] = (o < M && k < r) ? A[(long long)o * r + k] : 0.f;
      acc[t][k] = 0.f;
    }
  }
  float sq = 0.f;
  float xr[ROWS], mr[ROWS], xn[ROWS] = {}, mn[ROWS] = {}, sv[kShare];
  load_tile<ROWS>(Xb, Mb, true, o0, 0, M, N, N, lane, wy, xr, mr);
  fetch_rows<RK>(S, 0, N, r, tid, sv);

  for (int s0 = 0; s0 < N; s0 += kTile) {
    __syncthreads();                     // last tile's readers are done
    stage_rows<RK>(sv, tid, str);
    __syncthreads();
    // the next tile's X, mask and W rows are in flight meanwhile
    if (s0 + kTile < N) {
      load_tile<ROWS>(Xb, Mb, true, o0, s0 + kTile, M, N, N, lane, wy, xn,
                      mn);
      fetch_rows<RK>(S, s0 + kTile, N, r, tid, sv);
    }
    float w[RK];
    read_row<RK>(str, lane, w);          // W row s0 + lane
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      float pred = 0.f;
#pragma unroll
      for (int k = 0; k < RK; ++k) pred = fmaf(a[t][k], w[k], pred);
      const float rv = mr[t] * (xr[t] - pred);   // 0 outside the block
      sq = fmaf(rv, rv, sq);
#pragma unroll
      for (int k = 0; k < RK; ++k) acc[t][k] = fmaf(rv, w[k], acc[t][k]);
    }
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      xr[t] = xn[t];
      mr[t] = mn[t];
    }
  }

  // acc[t][k] is this lane's share (columns = lane mod 32) of gU; value
  // index t * RK + k
  constexpr int V = ROWS * RK;
  constexpr int kKeep = V >= 32 ? V / 32 : 1, kDup = V >= 32 ? 1 : 32 / V;
  float* v = &acc[0][0];
  lane_reduce_scatter<V, 16>(v, lane);
  if (lane % kDup == 0) {
#pragma unroll
    for (int i = 0; i < kKeep; ++i) {
      const int j = (lane / kDup) * kKeep + i, t = j / RK, k = j % RK;
      const int o = o0 + wy + kRows * t;
      if (o < M && k < r) G[(long long)o * r + k] = -2.f * v[i];
    }
  }
  const float tot = block_sum(sq);
  if (tid == 0) *partial = tot;
}

// Side W: this CTA owns columns c0..c0+31 of block b (rows of W).
template <int RK>
__device__ __forceinline__ void reg_side_w(
    const float* __restrict__ Xb, const float* __restrict__ Mb,
    const float* __restrict__ A, const float* __restrict__ S,
    float* __restrict__ G, float* str, int c0, int M, int N, int r) {
  const int tid = threadIdx.x, lane = tid & 31, wy = tid >> 5;
  constexpr int kShare = (kTile * RK + kThreads - 1) / kThreads;
  const int c = c0 + lane;
  float a[RK], acc[RK];
#pragma unroll
  for (int k = 0; k < RK; ++k) {
    a[k] = (c < N && k < r) ? A[(long long)c * r + k] : 0.f;
    acc[k] = 0.f;
  }
  float xr[kPer], mr[kPer], xn[kPer] = {}, mn[kPer] = {}, sv[kShare];
  load_tile(Xb, Mb, false, c0, 0, N, M, N, lane, wy, xr, mr);
  fetch_rows<RK>(S, 0, M, r, tid, sv);

  for (int s0 = 0; s0 < M; s0 += kTile) {
    __syncthreads();
    stage_rows<RK>(sv, tid, str);
    __syncthreads();
    if (s0 + kTile < M) {
      load_tile(Xb, Mb, false, c0, s0 + kTile, N, M, N, lane, wy, xn, mn);
      fetch_rows<RK>(S, s0 + kTile, M, r, tid, sv);
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      float u[RK];
      read_row<RK>(str, wy + kRows * t, u);   // broadcast: one row a warp
      float pred = 0.f;
#pragma unroll
      for (int k = 0; k < RK; ++k) pred = fmaf(a[k], u[k], pred);
      const float rv = mr[t] * (xr[t] - pred);
#pragma unroll
      for (int k = 0; k < RK; ++k) acc[k] = fmaf(rv, u[k], acc[k]);
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      xr[t] = xn[t];
      mr[t] = mn[t];
    }
  }

  // the 8 warps' partials, added in warp order
  __syncthreads();                       // the walk's readers are done
  float* red = str;                      // kRows x 32 x (RK + 1)
#pragma unroll
  for (int k = 0; k < RK; ++k) red[(wy * 32 + lane) * (RK + 1) + k] = acc[k];
  __syncthreads();
  for (int f = tid; f < kTile * RK; f += kThreads) {
    const int l = f / RK, k = f % RK;
    float g = 0.f;
#pragma unroll
    for (int w = 0; w < kRows; ++w) g += red[(w * 32 + l) * (RK + 1) + k];
    if (c0 + l < N && k < r) G[(long long)(c0 + l) * r + k] = -2.f * g;
  }
}

// grid (row_tiles + ceil(N / kTile), B): side-U CTAs first; row_tiles =
// ceil(M / (kRows * own_rows(RK))).  Two CTAs an SM up to RK = 16; at
// RK = 32 a side-W thread holds three 32-value rows (W row, gW partial,
// streamed U row), which spills under 128 registers, so it takes one.
template <int RK>
__global__ void __launch_bounds__(kThreads, RK <= 16 ? 2 : 1) reg_grad_kernel(
    const float* __restrict__ X, const float* __restrict__ Mk,
    const float* __restrict__ U, const float* __restrict__ W,
    float* __restrict__ gU, float* __restrict__ gW,
    float* __restrict__ partials, int M, int N, int r, int row_tiles) {
  constexpr int kStage = kTile * stage_stride<RK>();
  constexpr int kRed = kRows * 32 * (RK + 1);
  __shared__ __align__(16) float str[kStage > kRed ? kStage : kRed];
  const int b = blockIdx.y;
  const float* Xb = X + (long long)b * M * N;
  const float* Mb = Mk + (long long)b * M * N;
  const float* Ub = U + (long long)b * M * r;
  const float* Wb = W + (long long)b * N * r;
  if ((int)blockIdx.x < row_tiles) {     // uniform per CTA
    constexpr int ROWS = own_rows(RK);
    reg_side_u<RK, ROWS>(Xb, Mb, Ub, Wb, gU + (long long)b * M * r,
                         partials + (long long)b * row_tiles + blockIdx.x,
                         str, blockIdx.x * kRows * ROWS, M, N, r);
  } else {
    reg_side_w<RK>(Xb, Mb, Wb, Ub, gW + (long long)b * N * r, str,
                   (blockIdx.x - row_tiles) * kTile, M, N, r);
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

// loss partials a block: one per side-U CTA, at most one per smallest own
// tile
extern "C" int mfg_num_partials(int M) {
  return (M + kMinOwnTile - 1) / kMinOwnTile;
}

extern "C" int masked_factor_grad(
    const float* X, const float* Mk, const float* U, const float* W,
    float* loss, float* gU, float* gW, float* partials,
    int B, int M, int N, int r, void* stream) {
  if (B <= 0) return 0;
  if (B > 65535 || M <= 0 || N <= 0 || r < 1 || r > kMaxRank)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int col_tiles = (N + kTile - 1) / kTile;
  int row_tiles;
  if (r <= 32) {                         // factors in registers
    const int rk = r <= 4 ? 4 : r <= 8 ? 8 : r <= 16 ? 16 : 32;
    const int own = kRows * own_rows(rk);
    row_tiles = (M + own - 1) / own;
    const dim3 grid(row_tiles + col_tiles, B);
#define LAUNCH_REG(RK)                                                      \
  case RK:                                                                  \
    reg_grad_kernel<RK><<<grid, kThreads, 0, st>>>(                         \
        X, Mk, U, W, gU, gW, partials, M, N, r, row_tiles);                 \
    break;
    switch (rk) { LAUNCH_REG(4) LAUNCH_REG(8) LAUNCH_REG(16) LAUNCH_REG(32) }
#undef LAUNCH_REG
  } else {                               // factor rows in shared memory
    row_tiles = (M + kTile - 1) / kTile;
    const int rs = r | 1;
    const size_t smem =
        sizeof(float) * (2 * kTile * rs + kTile * (kTile + 1));
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
    LAUNCH(8) LAUNCH(16) LAUNCH(32)
    return (int)cudaErrorInvalidValue;
#undef LAUNCH
  }
  RETURN_IF_ERROR();
  sum_partials_kernel<<<B, kThreads, 0, st>>>(partials, loss, row_tiles);
  RETURN_IF_ERROR();
  return 0;
}
