// Sparse f-gradient of the gossip objective, hand-written for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   sddmm_segment_grad  <- repro/kernels/sddmm/segment_kernel.py
//                          sddmm_segment_grad_pallas (body _make_kernel)
//   sddmm_factor_grad   <- repro/kernels/sddmm/kernel.py
//                          sddmm_factor_grad_pallas (body _kernel)
//
// Both compute, for each block b of a stack of B blocks of padded COO
// entries (rows, cols, vals, valid: (B, E)) and factors U (B, M, r),
// W (B, N, r):
//   e_k    = valid_k * (vals_k - <U[rows_k], W[cols_k]>)
//   loss   = sum_k e_k^2
//   gU[m]  = -2 sum_{k: rows_k = m} e_k W[cols_k]
//   gW[n]  = -2 sum_{k: cols_k = n} e_k U[rows_k]
// The TPU kernels gather and scatter with one-hot matmuls on the MXU and
// scan the sorted stream with a triangular matmul, one block per call,
// vmapped.  Here entries are indexed directly and the whole stack goes in
// one call.
//
// Bound on this card: bytes.  Each real entry moves its 5 index/value
// words (20 B) and does about 6r+3 flops; at r = 15 that is ~5 flop/B,
// far below the ~20 flop/B at which 67 TFLOP/s of f32 would bind before
// 3.35 TB/s.  The factors are a few MB and stay in the 50 MB L2, so the
// entry streams are what has to come from HBM.  The design reads each
// entry stream with neighbouring threads on neighbouring slots, keeps the
// factor-row gathers in L2, and writes each gradient row once (segment) or
// accumulates it in L2 with atomics (scatter).  Measured on an H100 80GB
// HBM3 at 700 W (PERF.md), both run far above that bound while moving
// ~0.1 TB/s, so HBM is not what holds them; the likely cost is the latency
// of each entry's dependent index -> factor-row loads.
//
// Entry groups (phase one and scatter): an entry is handled by a group of
// lg lanes, lg the least power of two >= r (at most 32), so a factor row
// is read as one coalesced segment and the dot product is a shuffle
// reduction; a warp holds 32/lg groups (two at r = 15).  Above r = 32 a
// lane takes every 32nd component (r <= 256).
//
// sddmm_segment_grad is deterministic: no atomics anywhere.
//   phase one  ~1024 CTAs over the stack loop over the entry slots, one
//              group per slot: e -> scratch, fixed-order per-CTA sums of
//              e^2 -> partials
//   phase two  one warp per output row, both sides in one launch: warps
//              [0, M) of block b walk the CSR segment [row_ptr[m],
//              row_ptr[m+1]) summing -2 e W[cols]; warps [M, M+N) walk the
//              CSC segment of col_ptr through col_perm summing -2 e U[rows].
//              Lane i takes entries i, i+32, ... of the segment, so 32
//              entries are in flight at once and their index loads are
//              coalesced; each lane keeps the row's partial sum in
//              registers (up to 32 components at a time) and one
//              fixed-order warp reduction finishes it.  Segment lengths
//              follow item and user popularity (a hot item's column in a
//              1208-row block can hold most of its rows), so a long
//              segment is walked 32 entries at a time.
//   phase three one CTA per block sums its partials in a fixed order.
// Padding slots (valid = 0, rows = mb-1) give e = 0 and lie outside every
// segment (row_ptr[M] = col_ptr[N] = nnz), so they add exactly nothing.
//
// sddmm_factor_grad is order-agnostic (no sorted aux needed): one group
// per entry computes e and atomicAdds -2 e W[col] into gU[row] and
// -2 e U[row] into gW[col], neighbouring lanes on neighbouring addresses.
// The gradient sums land in no fixed order, so it is held to a tolerance,
// not bit for bit; its loss uses the same fixed-order partials as above.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 256;
constexpr int kEntryCtas = 1024;   // entry-phase CTAs over the whole stack
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Lanes per entry group: the least power of two >= r, at most 32.
int group_lanes(int r) {
  int lg = 1;
  while (lg < r && lg < 32) lg <<= 1;
  return lg;
}

// Fixed-order sum over a kThreads-wide CTA; the total lands in thread 0.
__device__ float block_sum(float v) {
  __shared__ float warp_tot[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kThreads / 32; ++i) t += warp_tot[i];
  }
  return t;
}

// Residual of entry slot `slot` of block b, computed by the lg lanes of a
// group (lane j of the group); every lane of the group gets the result.
// Called by all 32 lanes of the warp (it shuffles).
__device__ __forceinline__ float group_residual(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const float* __restrict__ vals, const float* __restrict__ valid,
    const float* __restrict__ U, const float* __restrict__ W,
    long long slot, int b, int M, int N, int r, int j, int lg,
    const float** u_row, const float** w_row) {
  const int row = clampi(rows[slot], 0, M - 1);
  const int col = clampi(cols[slot], 0, N - 1);
  *u_row = U + ((long long)b * M + row) * r;
  *w_row = W + ((long long)b * N + col) * r;
  float part = 0.f;
  for (int c = j; c < r; c += lg) part = fmaf((*u_row)[c], (*w_row)[c], part);
  for (int off = lg >> 1; off > 0; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off);
  return valid[slot] * (vals[slot] - part);
}

// grid (sddmm_num_partials(B, E, r), B): a grid-stride loop over the slots;
// the loop bound is the warp's first slot, so every lane of a warp runs
// the same iterations (the group shuffles take the full warp mask).
__global__ void __launch_bounds__(kThreads) residual_kernel(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const float* __restrict__ vals, const float* __restrict__ valid,
    const float* __restrict__ U, const float* __restrict__ W,
    float* __restrict__ e, float* __restrict__ partials,
    int E, int M, int N, int r, int lg) {
  const int b = blockIdx.y;
  const int j = threadIdx.x % lg;
  const int per_cta = kThreads / lg;
  const int first = blockIdx.x * per_cta + (threadIdx.x >> 5) * (32 / lg);
  float sq = 0.f;
#pragma unroll 2
  for (int kw = first; kw < E; kw += gridDim.x * per_cta) {
    const int k = kw + (threadIdx.x & 31) / lg;
    const bool live = k < E;
    const long long slot = (long long)b * E + (live ? k : E - 1);
    const float *u_row, *w_row;
    const float ek = group_residual(rows, cols, vals, valid, U, W, slot, b,
                                    M, N, r, j, lg, &u_row, &w_row);
    if (live && j == 0) {
      e[slot] = ek;
      sq = fmaf(ek, ek, sq);
    }
  }
  const float tot = block_sum(sq);
  if (threadIdx.x == 0) partials[(long long)b * gridDim.x + blockIdx.x] = tot;
}

// One warp per output row; B * (M + N) warps in all.  Each lane takes
// every 32nd entry of the segment and sums -2 e * (factor row) into RK
// registers; one fixed-order warp reduction per component finishes the
// row.  Ranks above RK (= 32) are done RK components at a time.
template <int RK>
__global__ void __launch_bounds__(kThreads) segment_kernel(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const int* __restrict__ col_perm, const int* __restrict__ row_ptr,
    const int* __restrict__ col_ptr, const float* __restrict__ U,
    const float* __restrict__ W, const float* __restrict__ e,
    float* __restrict__ gU, float* __restrict__ gW,
    int B, int E, int M, int N, int r) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per_block = (long long)M + N;
  if (warp >= (long long)B * per_block) return;   // warp-uniform
  const int b = (int)(warp / per_block);
  const int s = (int)(warp % per_block);
  const bool side_u = s < M;
  const int own = side_u ? s : s - M;
  const int* ptr = side_u ? row_ptr + (long long)b * (M + 1) + own
                          : col_ptr + (long long)b * (N + 1) + own;
  const int lo = clampi(ptr[0], 0, E);
  const int hi = clampi(ptr[1], lo, E);
  const int other_n = side_u ? N : M;
  const float* other = side_u ? W + (long long)b * N * r
                              : U + (long long)b * M * r;
  const long long base = (long long)b * E;
  float* out = side_u ? gU + ((long long)b * M + own) * r
                      : gW + ((long long)b * N + own) * r;

  for (int cb = 0; cb < r; cb += RK) {
    const int rc = min(RK, r - cb);
    float acc[RK];
#pragma unroll
    for (int c = 0; c < RK; ++c) acc[c] = 0.f;
    for (int k = lo + lane; k < hi; k += 32) {
      const long long slot =
          base + (side_u ? k : clampi(col_perm[base + k], 0, E - 1));
      const int o = clampi(side_u ? cols[slot] : rows[slot], 0, other_n - 1);
      const float d = -2.f * e[slot];
      const float* orow = other + (long long)o * r + cb;
#pragma unroll
      for (int c = 0; c < RK; ++c)
        if (c < rc) acc[c] = fmaf(d, orow[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      float v = acc[c];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
      if (lane == c && c < rc) out[cb + c] = v;
    }
  }
}

// grid (sddmm_num_partials(B, E, r), B), looping like residual_kernel; gU
// and gW zeroed beforehand.
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const float* __restrict__ vals, const float* __restrict__ valid,
    const float* __restrict__ U, const float* __restrict__ W,
    float* __restrict__ gU, float* __restrict__ gW,
    float* __restrict__ partials, int E, int M, int N, int r, int lg) {
  const int b = blockIdx.y;
  const int j = threadIdx.x % lg;
  const int per_cta = kThreads / lg;
  const int first = blockIdx.x * per_cta + (threadIdx.x >> 5) * (32 / lg);
  float sq = 0.f;
#pragma unroll 2
  for (int kw = first; kw < E; kw += gridDim.x * per_cta) {
    const int k = kw + (threadIdx.x & 31) / lg;
    const bool live = k < E;
    const long long slot = (long long)b * E + (live ? k : E - 1);
    const float *u_row, *w_row;
    const float ek = group_residual(rows, cols, vals, valid, U, W, slot, b,
                                    M, N, r, j, lg, &u_row, &w_row);
    if (live && ek != 0.f) {   // a zero residual adds exactly zero: skip it
      const float d = -2.f * ek;
      float* gu = gU + (u_row - U);
      float* gw = gW + (w_row - W);
      for (int c = j; c < r; c += lg) {
        atomicAdd(gu + c, d * w_row[c]);
        atomicAdd(gw + c, d * u_row[c]);
      }
    }
    if (live && j == 0) sq = fmaf(ek, ek, sq);
  }
  const float tot = block_sum(sq);
  if (threadIdx.x == 0) partials[(long long)b * gridDim.x + blockIdx.x] = tot;
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

bool bad_shape(int B, int E, int M, int N, int r) {
  return B > 65535 || E <= 0 || M <= 0 || N <= 0 || r < 1 || r > kMaxRank;
}

}  // namespace

#define RETURN_IF_ERROR()                        \
  do {                                           \
    const cudaError_t err_ = cudaGetLastError(); \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

// Loss partials per block = the entry phase's CTAs per block: enough for
// the slots, but about kEntryCtas over the whole stack, so a large stack
// loops and a small one (a structure's 3 blocks) still fills the card.
extern "C" int sddmm_num_partials(int B, int E, int r) {
  const int per_cta = kThreads / group_lanes(r < 1 ? 1 : r);
  const int need = (E + per_cta - 1) / per_cta;
  const int share = B > 0 ? (kEntryCtas + B - 1) / B : 1;
  return need < share ? need : share;
}

extern "C" int sddmm_segment_grad(
    const int* rows, const int* cols, const float* vals, const float* valid,
    const int* col_perm, const int* row_ptr, const int* col_ptr,
    const float* U, const float* W, float* loss, float* gU, float* gW,
    float* e, float* partials, int B, int E, int M, int N, int r,
    void* stream) {
  if (B <= 0) return 0;
  if (bad_shape(B, E, M, N, r)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lg = group_lanes(r);
  const dim3 entry_grid(sddmm_num_partials(B, E, r), B);
  residual_kernel<<<entry_grid, kThreads, 0, st>>>(
      rows, cols, vals, valid, U, W, e, partials, E, M, N, r, lg);
  RETURN_IF_ERROR();
  const long long threads = (long long)B * (M + N) * 32;
  const unsigned row_blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (r <= 8) {
    segment_kernel<8><<<row_blocks, kThreads, 0, st>>>(
        rows, cols, col_perm, row_ptr, col_ptr, U, W, e, gU, gW, B, E, M, N,
        r);
  } else if (r <= 16) {
    segment_kernel<16><<<row_blocks, kThreads, 0, st>>>(
        rows, cols, col_perm, row_ptr, col_ptr, U, W, e, gU, gW, B, E, M, N,
        r);
  } else {
    segment_kernel<32><<<row_blocks, kThreads, 0, st>>>(
        rows, cols, col_perm, row_ptr, col_ptr, U, W, e, gU, gW, B, E, M, N,
        r);
  }
  RETURN_IF_ERROR();
  sum_partials_kernel<<<B, kThreads, 0, st>>>(partials, loss, entry_grid.x);
  RETURN_IF_ERROR();
  return 0;
}

extern "C" int sddmm_factor_grad(
    const int* rows, const int* cols, const float* vals, const float* valid,
    const float* U, const float* W, float* loss, float* gU, float* gW,
    float* partials, int B, int E, int M, int N, int r, void* stream) {
  if (B <= 0) return 0;
  if (bad_shape(B, E, M, N, r)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(gU, 0, sizeof(float) * (size_t)B * M * r, st);
  RETURN_IF_ERROR();
  cudaMemsetAsync(gW, 0, sizeof(float) * (size_t)B * N * r, st);
  RETURN_IF_ERROR();
  const int lg = group_lanes(r);
  const dim3 entry_grid(sddmm_num_partials(B, E, r), B);
  scatter_kernel<<<entry_grid, kThreads, 0, st>>>(
      rows, cols, vals, valid, U, W, gU, gW, partials, E, M, N, r, lg);
  RETURN_IF_ERROR();
  sum_partials_kernel<<<B, kThreads, 0, st>>>(partials, loss, entry_grid.x);
  RETURN_IF_ERROR();
  return 0;
}
