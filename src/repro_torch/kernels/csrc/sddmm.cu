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
// words (20 B) and does about 6r+4 flops; at r = 15 that is ~5 flop/B,
// far below the ~20 flop/B at which 67 TFLOP/s of f32 would bind before
// 3.35 TB/s.  The factors are a few MB and stay in the 50 MB L2, so the
// entry streams are what has to come from HBM: at the MovieLens-1M cell
// (5 x 5 blocks of 1208 x 742, r = 15, 800k entries) 22.0 MB, 6.6 us.
// What a kernel can reach instead is set by the latency of its dependent
// loads (index -> factor row, from L2) and by how many it keeps in flight.
//
// sddmm_segment_grad walks the sorted store's CSR and CSC views, as the
// TPU kernel does: one side per output row, the residual recomputed on
// each side (segment_kernel.py: "one pallas_call produces one side"), so
// no e goes back to memory and the two sides are independent.  It is one
// walk launch over the whole stack plus one small loss launch, and it is
// deterministic: no atomics, every sum in a fixed order.
//
//   Groups.  A group of lg lanes holds one factor row, two components a
//   lane (c and c + lg; lg the least power of two >= r / 2, so 8 at
//   r = 15); above r = 32 a warp holds a row, a lane every 32nd component
//   (r <= 256).  A CTA of G = 256 / lg groups owns G consecutive output
//   rows of one side of one block: CTAs [0, ceil(M/G)) of block b the CSR
//   side (own U[b, m], segment [row_ptr[m], row_ptr[m+1]), gathered
//   W[cols]), the rest the CSC side (own W[b, n], segment [col_ptr[n],
//   col_ptr[n+1]) through col_perm, gathered U[rows]).  The own rows are
//   contiguous: the CTA stages them in shared memory once, with their
//   segment offsets.
//   Long segments.  Segment lengths follow user and item popularity: at
//   the cell above rows hold 26.5 entries on average (p99 135, max 513),
//   columns 43.1 (p99 358, max 978, 20 empty).  The G rows' segments are
//   one contiguous range of the sorted stream, so the CTA splits that range
//   evenly between its groups, whatever the rows' lengths: a 978-entry
//   column is walked by all 32 groups of its CTA (at most 76 entries a
//   group at that cell, 42 on average), never by one.  A group's first row
//   may have begun in an earlier group; its part goes to a shared-memory
//   slot and is added, after a barrier and in group order, to the part of
//   the group where the row begins.  Every other row is complete in one
//   group.
//   Entries in flight.  A group takes lg entries at a time: lane j loads
//   entry j's index, value and valid with one coalesced load each (on the
//   CSC side behind a coalesced col_perm load), one chunk ahead of use
//   (col_perm two chunks ahead), and the lg gathers of the other factor's
//   rows are issued back to back, lanes on neighbouring components.
//   Residual and sums.  Each lane forms own * gathered over its components
//   for the lg entries; a transposing butterfly (lg - 1 shuffles, not
//   lg log lg) leaves entry j's dot product on lane j, next to its value,
//   so lane j computes e_j; one shuffle an entry broadcasts it and each
//   lane adds e * gathered into its own components.  The output needs no
//   cross-lane reduction and is written once, -2 * acc.
//   Tuning (H100 80GB HBM3 at 700 W): two components a lane issue about
//   half the shuffles and address arithmetic an entry of one, and at most
//   85 registers keep three CTAs on an SM; one component a lane (16 lanes
//   at r = 15) and four (4 lanes) both ran slower at the cell's stacks.
//   Loss.  Only the CSR side adds e^2: each group in walk order, the CTA's
//   groups in a fixed order into one partial per CTA; the second launch
//   sums each block's partials in a fixed order.  Padding slots lie
//   outside every segment (row_ptr[M] = col_ptr[N] = nnz) and add nothing.
//   Indices are clamped into range, so a malformed store cannot read
//   outside the arrays.
//
// The design this one replaced (0.189 ms at that cell on the same card)
// was three launches: a residual pass with ~16k entries in flight on the
// whole card writing e to scratch, a warp per output row with lanes over
// entries ending in an r x 5-step shuffle reduction per row (80 shuffles
// for ~1 entry a lane), and a launch that summed the loss partials.
//
// sddmm_factor_grad is order-agnostic (no sorted aux needed).  The TPU
// kernel keeps gU and gW resident on chip and adds into them tile by tile;
// here they are summed in shared memory, and nothing is added in global
// memory.  One launch, cluster_scatter_kernel, grid (K, B), a thread-block
// cluster of K CTAs of 1024 threads a block:
//
//   Copies.  Each CTA holds its own copy of the block's whole gU and gW as
//   f32 accumulators in its dynamic shared memory, (M + N) * r * 4 bytes
//   (117 KB at the cell above), zeroed at the start.
//   Entries in flight.  The cluster's CTAs split the block's E slots
//   evenly, and a CTA's groups split its share evenly.  The lanes and
//   components are the segment walk's (lg lanes a group, two components a
//   lane up to r = 32, a warp a row above), and so is the walk: a group
//   takes lg entries a trip, lane j loads entry j's row, col, val and valid
//   with coalesced loads one trip ahead of use, the 2 lg gathers of the
//   entries' U and W rows go back to back, and the transposing butterfly
//   leaves entry j's dot product on lane j, which forms e_j.  A padding
//   slot (valid = 0) gathers nothing and gives e = 0.
//   Adds.  For each entry i with e_i != 0 (a zero residual adds exactly
//   zero), each lane adds e_i W[col_i][c] into row row_i of its CTA's gU
//   copy and e_i U[row_i][c] into row col_i of its gW copy, by atomicAdd
//   on its own shared memory.  Up to r = 16 the gathered components stay
//   in registers from the dot product to the adds; above, they are read
//   again (L1).  No atomic touches global memory, and there is no memset.
//   Write-out.  cluster.sync(), then rank c sums rows [c*mu, c*mu + mu) of
//   the cluster's K copies of gU (mu = ceil(M / K)) in rank order through
//   distributed shared memory and writes them once, scaled by -2, and gW
//   likewise; rank 0 sums the CTAs' loss partials in rank order into
//   loss[b].  A last cluster.sync() keeps every CTA resident while a peer
//   may still read it.
//   K.  A CTA takes a whole SM's registers (1024 threads at <= 64), so the
//   C entry picks the largest K <= 8 (the portable cluster size) at which
//   all B clusters are resident at once (cudaOccupancyMaxActiveClusters):
//   one wave on as many SMs as that allows.
//   Shapes beyond the budget.  Where a block's gU and gW exceed kCopyBytes,
//   (M + N) * r * 4 > 220 KiB (at the cell's M + N = 1950 from r = 29 on),
//   the C entry launches the first design instead (kept below as
//   scatter_kernel): gU and gW zeroed by two memsets, one group an entry
//   over a grid-stride loop, its 2r adds as atomicAdd into global memory,
//   then the loss launch.  That is a choice by shape; a cluster launch that
//   the card refuses returns its error.  The C entry
//   sddmm_factor_grad_first launches the first design at any shape, for
//   comparison.
//   Measured (H100 80GB HBM3 at 700 W, chip_smoke.py at the cell): 0.090
//   ms at B = 25 (K = 4, 100 CTAs) against the first design's 0.120, and
//   0.055 ms at B = 3 (K = 8, 24 CTAs) against 0.023: with so few CTAs
//   the first design, spread over the whole card, is faster.  The float
//   adds into shared memory compile to ATOMS.CAST.SPIN loops (cuobjdump
//   -sass); at B = 25 the kernel takes 10.5 ns a slot on each SM it uses.
//   A cluster of 8 whose CTA c owned only rows [c*mu, c*mu + mu) of gU
//   and [c*nu, ...) of gW, every add going by atomicAdd through
//   cluster.map_shared_rank() to the owner, took 0.425 ms at B = 25 and
//   0.210 ms at B = 3; adds to owned rows cost no less than the others
//   (the row-sorted store, whose gU adds mostly stay in their CTA, took
//   0.425 ms, the permuted one 0.446).
//
// Repeatability: the adds land in shared memory in arrival order, so the
// gradients are held to a tolerance, not bit for bit; the loss is a
// fixed-order sum (each group's lanes, the CTA's groups, the cluster's
// ranks, in order) and repeats bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 256;
constexpr int kEntryCtas = 1024;   // first scatter design: CTAs over the stack
constexpr int kMaxSide = 1 << 23;  // rows a side: 23 bits + an 8-bit offset
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWalkCpl = 2;       // walk: components a lane up to r = 32
constexpr int kClusterThreads = 1024;     // a cluster scatter CTA
constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr int kCopyBytes = 220 * 1024;    // a CTA's gU and gW copy, at most

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

// Transposing butterfly over a group of LG lanes, lane j: on entry v[i] is
// this lane's part of entry i's dot product; on return v[0] is the whole
// dot product of entry j.  LG - 1 shuffles, not LG log LG.  Called by all
// 32 lanes of the warp (the shuffles take the full mask).
template <int LG>
__device__ __forceinline__ float transpose_sum(float (&v)[LG], int j) {
#pragma unroll
  for (int h = LG / 2; h >= 1; h >>= 1) {
    const bool upper = j & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, h);
    }
  }
  return v[0];
}

// Segment walk: grid (ceil(M / G) + ceil(N / G), B), G = kThreads / LG
// groups of LG lanes a CTA, CPL components a lane.  See the note at the
// top.  Every loop that shuffles runs the same iterations on all 32 lanes
// of a warp (the shuffles take the full mask); what differs between the
// groups of a warp is predicated.  While the gathered rows fit in
// registers, three CTAs stay on an SM (at most 85 registers a thread).
template <int LG, int CPL>
__global__ void __launch_bounds__(kThreads, LG * CPL <= 32 ? 3 : 1)
segment_walk_kernel(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const float* __restrict__ vals, const float* __restrict__ valid,
    const int* __restrict__ col_perm, const int* __restrict__ row_ptr,
    const int* __restrict__ col_ptr, const float* __restrict__ U,
    const float* __restrict__ W, float* __restrict__ gU,
    float* __restrict__ gW, float* __restrict__ partials, int E, int M,
    int N, int r, int ctas_u) {
  constexpr int G = kThreads / LG;      // groups, and output rows, a CTA
  constexpr int SPAN = kThreads * CPL;  // >= G * r floats
  constexpr bool kKeep = LG * CPL <= 32;  // keep gathered rows in registers
  __shared__ int ptr_s[G + 1];
  __shared__ float own_s[SPAN];         // the CTA's own rows, (G, r)
  __shared__ float out_s[SPAN];         // rows complete in one group
  __shared__ float cont_s[SPAN];        // each group's continued first row
  __shared__ int cont_row[G];
  __shared__ float sq_s[G];

  const int b = blockIdx.y;
  const bool side_u = (int)blockIdx.x < ctas_u;
  const int S = side_u ? M : N;
  const int other_n = side_u ? N : M;
  const int s0 = (side_u ? (int)blockIdx.x : (int)blockIdx.x - ctas_u) * G;
  const int nrows = min(G, S - s0);
  const int* ptr = side_u ? row_ptr + (long long)b * (M + 1) + s0
                          : col_ptr + (long long)b * (N + 1) + s0;
  const float* own = (side_u ? U + (long long)b * M * r
                             : W + (long long)b * N * r) + (long long)s0 * r;
  const float* other = side_u ? W + (long long)b * N * r
                              : U + (long long)b * M * r;
  float* out = (side_u ? gU + (long long)b * M * r
                       : gW + (long long)b * N * r) + (long long)s0 * r;
  const long long base = (long long)b * E;
  const int grp = threadIdx.x / LG;
  const int j = threadIdx.x % LG;

  for (int i = threadIdx.x; i <= nrows; i += kThreads)
    ptr_s[i] = clampi(ptr[i], 0, E);
  for (int i = threadIdx.x; i < nrows * r; i += kThreads) {
    own_s[i] = own[i];
    out_s[i] = 0.f;
  }
  if (threadIdx.x < G) cont_row[threadIdx.x] = -1;
  __syncthreads();

  // this group's even share [a, z) of the CTA's entry range
  const int A = ptr_s[0];
  const long long T = max(ptr_s[nrows] - A, 0);
  const int a = A + (int)(T * grp / G);
  const int z = A + (int)(T * (grp + 1) / G);
  const int trips = __reduce_max_sync(kFull, (z - a + LG - 1) / LG);

  // entry k's slot (stage one) and its packed (other row << 8 | own row
  // offset), value and valid (stage two); nothing for k outside [a, z)
  auto slot_of = [&](int k) -> int {
    if (k >= z) return 0;
    return side_u ? k : clampi(col_perm[base + k], 0, E - 1);
  };
  auto fetch = [&](int k, int slot, int& pk, float& val, float& vld) {
    pk = 0;
    val = vld = 0.f;
    if (k >= z) return;
    const int o = clampi(side_u ? cols[base + slot] : rows[base + slot], 0,
                         other_n - 1);
    val = vals[base + slot];
    vld = valid[base + slot];
    int l = 0;                   // the row whose segment holds k
#pragma unroll
    for (int step = G / 2; step >= 1; step >>= 1)
      if (l + step < nrows && ptr_s[l + step] <= k) l += step;
    pk = (o << 8) | l;
  };

  int pk1, slot1 = slot_of(a + j);
  float val1, vld1;
  fetch(a + j, slot1, pk1, val1, vld1);
  slot1 = slot_of(a + LG + j);

  float acc[CPL];
#pragma unroll
  for (int q = 0; q < CPL; ++q) acc[q] = 0.f;
  int cur = -1;                  // own row offset acc belongs to
  float sq = 0.f;
  auto flush = [&]() {
    if (cur < 0) return;
    float* dst = out_s + cur * r;
    if (ptr_s[cur] < a) {        // begun in an earlier group
      dst = cont_s + grp * r;
      cont_row[grp] = cur;
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q)
      if (j + q * LG < r) dst[j + q * LG] = acc[q];
  };

  for (int t = 0, k0 = a; t < trips; ++t, k0 += LG) {
    const int pk = pk1;
    const float val = val1, vld = vld1;
    fetch(k0 + LG + j, slot1, pk1, val1, vld1);
    slot1 = slot_of(k0 + 2 * LG + j);
    const int n = clampi(z - k0, 0, LG);   // this group's live entries

    float g[kKeep ? LG : 1][kKeep ? CPL : 1];
    float v[LG];
    int pks[LG];
#pragma unroll
    for (int i = 0; i < LG; ++i) {
      pks[i] = __shfl_sync(kFull, pk, i, LG);
      const float* orow = other + (long long)(pks[i] >> 8) * r;
      const float* wrow = own_s + (pks[i] & 255) * r;
      float d = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = j + q * LG;
        const float x = (i < n && c < r) ? orow[c] : 0.f;
        if constexpr (kKeep) g[i][q] = x;
        d = fmaf(c < r ? wrow[c] : 0.f, x, d);
      }
      v[i] = d;
    }
    const float dot = transpose_sum<LG>(v, j);
    const float e = j < n ? vld * (val - dot) : 0.f;
    if (side_u) sq = fmaf(e, e, sq);
#pragma unroll
    for (int i = 0; i < LG; ++i) {
      const float ei = __shfl_sync(kFull, e, i, LG);
      if (i < n) {
        if ((pks[i] & 255) != cur) {
          flush();
          cur = pks[i] & 255;
#pragma unroll
          for (int q = 0; q < CPL; ++q) acc[q] = 0.f;
        }
        const float* orow = other + (long long)(pks[i] >> 8) * r;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c = j + q * LG;
          float x;
          if constexpr (kKeep) x = g[i][q];
          else x = c < r ? orow[c] : 0.f;   // reread: hits L1
          acc[q] = fmaf(ei, x, acc[q]);
        }
      }
    }
  }
  flush();
  for (int off = LG >> 1; off > 0; off >>= 1)
    sq += __shfl_xor_sync(kFull, sq, off);
  if (j == 0) sq_s[grp] = sq;
  __syncthreads();

  // group grp finishes row grp: its complete part, then the continued
  // parts in group order
  if (grp < nrows) {
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = j + q * LG;
      if (c < r) {
        float s = out_s[grp * r + c];
        for (int g2 = 0; g2 < G; ++g2)
          if (cont_row[g2] == grp) s += cont_s[g2 * r + c];
        out[grp * r + c] = -2.f * s;
      }
    }
  }
  if (side_u && threadIdx.x == 0) {
    float tot = 0.f;
    for (int g2 = 0; g2 < G; ++g2) tot += sq_s[g2];
    partials[(long long)b * ctas_u + blockIdx.x] = tot;
  }
}

// The first scatter design, for shapes whose gU and gW exceed a CTA's
// copy budget and for sddmm_factor_grad_first.  grid
// (sddmm_num_partials(B, E, r), B): a grid-stride loop over the slots, one
// group a slot; the loop bound is the warp's first slot, so every lane of a
// warp runs the same iterations (the group shuffles take the full warp
// mask).  gU and gW zeroed beforehand.
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

// Cluster scatter: grid (K, B), clusters of (K, 1, 1), one cluster a block,
// G = kClusterThreads / LG groups of LG lanes a CTA, CPL components a
// lane; dynamic shared memory (M + N) * r floats, the CTA's own copy of the
// block's gU and gW.  See the note at the top.  As in the walk, every loop
// that shuffles runs the same iterations on all 32 lanes of a warp; what
// differs between its groups is predicated.  Held to 64 registers a thread
// (one CTA an SM).
template <int LG, int CPL>
__global__ void __launch_bounds__(kClusterThreads, 1)
cluster_scatter_kernel(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const float* __restrict__ vals, const float* __restrict__ valid,
    const float* __restrict__ U, const float* __restrict__ W,
    float* __restrict__ gU, float* __restrict__ gW,
    float* __restrict__ loss, int E, int M, int N, int r) {
  constexpr int G = kClusterThreads / LG;
  constexpr bool kKeep = LG * CPL <= 16;   // keep gathered rows in registers
  extern __shared__ float acc_s[];         // this CTA's gU (M, r), gW (N, r)
  __shared__ float sq_s[G];
  __shared__ float part_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int grp = threadIdx.x / LG;
  const int j = threadIdx.x % LG;
  float* acc_u = acc_s;
  float* acc_w = acc_s + M * r;
  const float* Ub = U + (long long)b * M * r;
  const float* Wb = W + (long long)b * N * r;
  const long long base = (long long)b * E;

  for (int i = threadIdx.x; i < (M + N) * r; i += kClusterThreads)
    acc_s[i] = 0.f;
  __syncthreads();

  // this CTA's even share [a0, a0 + T) of the block's slots, and this
  // group's even share [a, z) of that
  const int a0 = (int)((long long)E * c / K);
  const long long T = (long long)E * (c + 1) / K - a0;
  const int a = a0 + (int)(T * grp / G);
  const int z = a0 + (int)(T * (grp + 1) / G);
  const int trips = __reduce_max_sync(kFull, (z - a + LG - 1) / LG);

  // entry k's row and col, -1 for a slot outside [a, z) or with valid = 0
  auto fetch = [&](int k, int& row, int& col, float& val, float& vld) {
    row = col = -1;
    val = vld = 0.f;
    if (k >= z) return;
    const int rr = clampi(rows[base + k], 0, M - 1);
    const int cc = clampi(cols[base + k], 0, N - 1);
    val = vals[base + k];
    vld = valid[base + k];
    if (vld == 0.f) return;
    row = rr;
    col = cc;
  };

  int row1, col1;
  float val1, vld1;
  fetch(a + j, row1, col1, val1, vld1);
  float sq = 0.f;

  for (int t = 0, k0 = a; t < trips; ++t, k0 += LG) {
    const int row = row1, col = col1;
    const float val = val1, vld = vld1;
    fetch(k0 + LG + j, row1, col1, val1, vld1);

    float gu[kKeep ? LG : 1][kKeep ? CPL : 1];
    float gw[kKeep ? LG : 1][kKeep ? CPL : 1];
    float v[LG];
#pragma unroll
    for (int i = 0; i < LG; ++i) {
      const int ri = __shfl_sync(kFull, row, i, LG);
      const int ci = __shfl_sync(kFull, col, i, LG);
      const bool live = ri >= 0;
      const float* urow = Ub + (long long)(live ? ri : 0) * r;
      const float* wrow = Wb + (long long)(live ? ci : 0) * r;
      float d = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int cc = j + q * LG;
        const float x = (live && cc < r) ? urow[cc] : 0.f;
        const float y = (live && cc < r) ? wrow[cc] : 0.f;
        if constexpr (kKeep) {
          gu[i][q] = x;
          gw[i][q] = y;
        }
        d = fmaf(x, y, d);
      }
      v[i] = d;
    }
    const float dot = transpose_sum<LG>(v, j);
    const float e = row >= 0 ? vld * (val - dot) : 0.f;
    sq = fmaf(e, e, sq);

#pragma unroll
    for (int i = 0; i < LG; ++i) {
      const float ei = __shfl_sync(kFull, e, i, LG);
      const int ri = __shfl_sync(kFull, row, i, LG);
      const int ci = __shfl_sync(kFull, col, i, LG);
      if (ei != 0.f) {           // a zero residual adds exactly zero: skip it
        float* du = acc_u + ri * r;
        float* dw = acc_w + ci * r;
        const float* urow = Ub + (long long)ri * r;
        const float* wrow = Wb + (long long)ci * r;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int cc = j + q * LG;
          if (cc < r) {
            float x, y;
            if constexpr (kKeep) {
              x = gu[i][q];
              y = gw[i][q];
            } else {             // read again: hits L1
              x = urow[cc];
              y = wrow[cc];
            }
            atomicAdd(du + cc, ei * y);   // this CTA's shared memory
            atomicAdd(dw + cc, ei * x);
          }
        }
      }
    }
  }

  // the CTA's loss partial: each group's lanes, then its groups, in order
#pragma unroll
  for (int off = LG >> 1; off > 0; off >>= 1)
    sq += __shfl_xor_sync(kFull, sq, off);
  if (j == 0) sq_s[grp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int g2 = 0; g2 < G; ++g2) tot += sq_s[g2];
    part_s = tot;
  }
  cluster.sync();                // every copy complete, every partial written

  // rank c writes rows [c*mu, c*mu + mu) of gU and [c*nu, c*nu + nu) of
  // gW: the cluster's K copies summed in rank order, scaled by -2
  const int mu = (M + K - 1) / K, nu = (N + K - 1) / K;
  const int u0 = min(M, c * mu) * r, u1 = min(M, c * mu + mu) * r;
  const int w0 = min(N, c * nu) * r, w1 = min(N, c * nu + nu) * r;
  float* outu = gU + (long long)b * M * r;
  float* outw = gW + (long long)b * N * r;
  for (int i = u0 + threadIdx.x; i < u1; i += kClusterThreads) {
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += cluster.map_shared_rank(acc_u, k)[i];
    outu[i] = -2.f * s;
  }
  for (int i = w0 + threadIdx.x; i < w1; i += kClusterThreads) {
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += cluster.map_shared_rank(acc_w, k)[i];
    outw[i] = -2.f * s;
  }
  if (c == 0 && threadIdx.x == 0) {
    float tot = 0.f;
    for (int k = 0; k < K; ++k) tot += *cluster.map_shared_rank(&part_s, k);
    loss[b] = tot;
  }
  cluster.sync();                // no CTA leaves while a peer reads it
}

bool bad_shape(int B, int E, int M, int N, int r) {
  return B > 65535 || E <= 0 || M <= 0 || N <= 0 || r < 1 || r > kMaxRank;
}

template <int LG, int CPL>
void launch_walk(const int* rows, const int* cols, const float* vals,
                 const float* valid, const int* col_perm, const int* row_ptr,
                 const int* col_ptr, const float* U, const float* W,
                 float* gU, float* gW, float* partials, int B, int E, int M,
                 int N, int r, int ctas_u, cudaStream_t st) {
  constexpr int G = kThreads / LG;
  const dim3 grid(ctas_u + (N + G - 1) / G, B);
  segment_walk_kernel<LG, CPL><<<grid, kThreads, 0, st>>>(
      rows, cols, vals, valid, col_perm, row_ptr, col_ptr, U, W, gU, gW,
      partials, E, M, N, r, ctas_u);
}

// The cluster kernel's instances, by cluster_variant(r): the walk's lanes
// and components (lg = 1 ... 16 at two components a lane up to r = 32, a
// warp a row at 2, 4 or 8 components above).
using ClusterKernel = void (*)(const int*, const int*, const float*,
                               const float*, const float*, const float*,
                               float*, float*, float*, int, int, int, int);
constexpr int kNumVariants = 8;
const ClusterKernel kClusterKernels[kNumVariants] = {
    cluster_scatter_kernel<1, kWalkCpl>, cluster_scatter_kernel<2, kWalkCpl>,
    cluster_scatter_kernel<4, kWalkCpl>, cluster_scatter_kernel<8, kWalkCpl>,
    cluster_scatter_kernel<16, kWalkCpl>, cluster_scatter_kernel<32, 2>,
    cluster_scatter_kernel<32, 4>, cluster_scatter_kernel<32, 8>};

int cluster_variant(int r) {
  if (r > 32) return r <= 64 ? 5 : r <= 128 ? 6 : 7;
  int v = 0;
  for (int lg = group_lanes((r + kWalkCpl - 1) / kWalkCpl); lg > 1; lg >>= 1)
    ++v;
  return v;
}

// A CTA's copy of one block's gU and gW.
long long copy_bytes(int M, int N, int r) {
  return (long long)(M + N) * r * (long long)sizeof(float);
}

// What the C entries read of each device once per cluster kernel: whether
// its dynamic shared-memory limit has been raised to kCopyBytes, and how
// many clusters of each size K are resident at once (active[K], from
// cudaOccupancyMaxActiveClusters at kCopyBytes; a CTA takes a whole SM's
// registers, so that is what any copy size gets).  Writes race only with
// writes of the same values.
struct KernelState {
  bool ready;
  int active[kMaxCluster + 1];
};
constexpr int kMaxDevices = 16;
KernelState g_state[kMaxDevices][kNumVariants];

cudaError_t kernel_state(int v, KernelState** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  KernelState& ks = g_state[dev][v];
  if (!ks.ready) {
    err = cudaFuncSetAttribute(kClusterKernels[v],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kCopyBytes);
    if (err != cudaSuccess) return err;
    for (int K = 1; K <= kMaxCluster; ++K) {
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = K;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(K, 1);
      cfg.blockDim = dim3(kClusterThreads);
      cfg.dynamicSmemBytes = kCopyBytes;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&ks.active[K], kClusterKernels[v],
                                           &cfg);
      if (err != cudaSuccess) return err;
    }
    ks.ready = true;
  }
  *out = &ks;
  return cudaSuccess;
}

// The cluster size for a stack of B blocks: the largest K <= kMaxCluster at
// which all B clusters are resident at once, so that the stack runs in one
// wave on as many SMs as that allows (1 where even that is not so).
int pick_cluster(const KernelState& ks, int B) {
  for (int K = kMaxCluster; K > 1; --K)
    if (ks.active[K] >= B) return K;
  return 1;
}

// One launch: grid (K, B) in clusters of (K, 1, 1).  A launch the card
// refuses returns its error; nothing is retried.
int launch_cluster(const int* rows, const int* cols, const float* vals,
                   const float* valid, const float* U, const float* W,
                   float* loss, float* gU, float* gW, int B, int E, int M,
                   int N, int r, int K, cudaStream_t st) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = K;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, B);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = (size_t)copy_bytes(M, N, r);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kClusterKernels[cluster_variant(r)], rows, cols, vals, valid, U,
      W, gU, gW, loss, E, M, N, r);
  if (err != cudaSuccess) {
    cudaGetLastError();          // leave no error for the next launch
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define RETURN_IF_ERROR()                        \
  do {                                           \
    const cudaError_t err_ = cudaGetLastError(); \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

// The first scatter design's loss partials per block = its entry phase's
// CTAs per block: enough for the slots, but about kEntryCtas over the whole
// stack, so a large stack loops and a small one still fills the card.
extern "C" int sddmm_num_partials(int B, int E, int r) {
  const int per_cta = kThreads / group_lanes(r < 1 ? 1 : r);
  const int need = (E + per_cta - 1) / per_cta;
  const int share = B > 0 ? (kEntryCtas + B - 1) / B : 1;
  return need < share ? need : share;
}

// Two launches: the segment walk (both sides, gU and gW written whole, one
// loss partial per CSR CTA) and the fixed-order loss sum.  partials holds
// at least B * ceil(M / G) floats; (B, M) always does.
extern "C" int sddmm_segment_grad(
    const int* rows, const int* cols, const float* vals, const float* valid,
    const int* col_perm, const int* row_ptr, const int* col_ptr,
    const float* U, const float* W, float* loss, float* gU, float* gW,
    float* partials, int B, int E, int M, int N, int r, void* stream) {
  if (B <= 0) return 0;
  if (bad_shape(B, E, M, N, r) || M >= kMaxSide || N >= kMaxSide)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a row's lanes and a lane's components: up to r = 32, kWalkCpl
  // components a lane; above, a warp a row
  const int cpl = r <= 32 ? kWalkCpl : r <= 64 ? 2 : r <= 128 ? 4 : 8;
  const int lg = r <= 32 ? group_lanes((r + kWalkCpl - 1) / kWalkCpl) : 32;
  const int G = kThreads / lg;
  const int ctas_u = (M + G - 1) / G;
#define WALK(LG, CPL)                                                       \
  launch_walk<LG, CPL>(rows, cols, vals, valid, col_perm, row_ptr, col_ptr, \
                       U, W, gU, gW, partials, B, E, M, N, r, ctas_u, st)
  switch (lg) {
    case 1: WALK(1, kWalkCpl); break;
    case 2: WALK(2, kWalkCpl); break;
    case 4: WALK(4, kWalkCpl); break;
    case 8: WALK(8, kWalkCpl); break;
    case 16: WALK(16, kWalkCpl); break;
    default:
      if (cpl == 2) WALK(32, 2);
      else if (cpl == 4) WALK(32, 4);
      else WALK(32, 8);
  }
#undef WALK
  RETURN_IF_ERROR();
  sum_partials_kernel<<<B, kThreads, 0, st>>>(partials, loss, ctas_u);
  RETURN_IF_ERROR();
  return 0;
}

// The first scatter design: two memsets, the scatter launch, the loss
// launch.
static int launch_first(const int* rows, const int* cols, const float* vals,
                        const float* valid, const float* U, const float* W,
                        float* loss, float* gU, float* gW, float* partials,
                        int B, int E, int M, int N, int r, cudaStream_t st) {
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

// The cluster size sddmm_factor_grad picks for (B, M, N, r) on the current
// device: 1 ... 8, or 0 where it launches the first design; -cudaError on
// bad arguments or a failed device query.
extern "C" int sddmm_cluster_size(int B, int M, int N, int r) {
  if (bad_shape(B, 1, M, N, r) || B <= 0) return -(int)cudaErrorInvalidValue;
  if (copy_bytes(M, N, r) > kCopyBytes) return 0;
  KernelState* ks = nullptr;
  const cudaError_t err = kernel_state(cluster_variant(r), &ks);
  if (err != cudaSuccess) return -(int)err;
  return pick_cluster(*ks, B);
}

// One cluster launch where a block's gU and gW fit a CTA's shared memory
// (partials unused), else the first design.  partials holds at least
// B * sddmm_num_partials(B, E, r) floats.
extern "C" int sddmm_factor_grad(
    const int* rows, const int* cols, const float* vals, const float* valid,
    const float* U, const float* W, float* loss, float* gU, float* gW,
    float* partials, int B, int E, int M, int N, int r, void* stream) {
  if (B <= 0) return 0;
  if (bad_shape(B, E, M, N, r)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (copy_bytes(M, N, r) > kCopyBytes)
    return launch_first(rows, cols, vals, valid, U, W, loss, gU, gW,
                        partials, B, E, M, N, r, st);
  KernelState* ks = nullptr;
  const cudaError_t err = kernel_state(cluster_variant(r), &ks);
  if (err != cudaSuccess) return (int)err;
  return launch_cluster(rows, cols, vals, valid, U, W, loss, gU, gW, B, E,
                        M, N, r, pick_cluster(*ks, B), st);
}

// The first design at any shape, with sddmm_factor_grad's arguments: the
// kernel chip_smoke.py times beside the cluster kernel on the same inputs.
extern "C" int sddmm_factor_grad_first(
    const int* rows, const int* cols, const float* vals, const float* valid,
    const float* U, const float* W, float* loss, float* gU, float* gW,
    float* partials, int B, int E, int M, int N, int r, void* stream) {
  if (B <= 0) return 0;
  if (bad_shape(B, E, M, N, r)) return (int)cudaErrorInvalidValue;
  return launch_first(rows, cols, vals, valid, U, W, loss, gU, gW, partials,
                      B, E, M, N, r, static_cast<cudaStream_t>(stream));
}
