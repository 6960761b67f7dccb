// Fused int8 dequantize-score product of the serving path, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dequant_score_pallas (body _kernel) in
// src/repro/kernels/quant/kernel.py.  For a batch of B quantized users
// (codes Q_u (B, r) int8, scales s_u (B,) f32) against the quantized
// catalog (Q_w (n, r) int8, s_w (n,) f32) it writes the (B, n) f32 scores
//   acc[i, j] = <Q_u[i], Q_w[j]>               exact, int32
//   out[i, j] = ((float)acc[i, j] * s_u[i]) * s_w[j]
// in exactly that order, so the result equals the plain version
// (kernels/quant/ref.py::fused_score_ref) bit for bit.  The integer sum is
// exact for any rank below 2^31 / 127^2; (float)acc is exact below r ~ 1040.
//
// Bound on this card: bytes, and almost all of them the output.  Against
// n = 3706 items at r = 15 the bytes B*r + 4B + n*r + 4n + 4*B*n over
// 3.35 TB/s give, at the four serving buckets,
//   B = 16: 0.092 us   B = 64: 0.305 us   B = 256: 1.155 us
//   B = 1024: 4.558 us (15.18 MB of scores; the inputs are 0.09 MB).
// The 114 M int8 multiply-adds at B = 1024 take 0.06 us on the tensor
// cores and ~1.3 us as __dp4a over 132 SMs, both under the store bound, so
// the products stay on __dp4a from shared memory.
//
// Two kernels, chosen by rank in the C entry (a choice by shape):
//
// * r <= kStagedMaxRank (64): staged_score_kernel, one CTA for each output
//   tile.  The edge is 64 so that the largest tile's shared memory (58.6 KiB
//   at r = 64) still lets three CTAs share an SM; the serving ranks (15,
//   32) are far below it.  What held the first kernel (kept below for
//   larger r) back, and what this design does about it:
//   - Staging was a latency chain: every thread made ~10 one-byte global
//     loads per rank chunk, each behind a division and two branches, and
//     no product started before the slowest returned; at the small buckets
//     that chain is most of the kernel.  Here a tile's codes are
//     contiguous runs (Q_w[j0 : j0+BN) is BN*r bytes from byte j0*r,
//     16-byte aligned when BN is a multiple of 16 and the base is), so
//     they, and the tile's scales, arrive by 16-byte cp.async: one or two
//     copies a thread.  A head or tail off the 16-byte grid (a base such
//     as w_q[1:], the ragged last tile) goes by bytes.  One pass from
//     shared to shared memory then spreads the flat runs into zero-padded
//     word rows of an odd stride, which __dp4a reads without bank
//     conflicts.
//   - Scalar stores off the line grid: the output's row stride, n*4 =
//     14,824 bytes at n = 3706, is 104 bytes off a multiple of 128, so
//     most warp stores straddled two lines.  Here the tile's scores go to
//     shared memory first, each row placed at the same address modulo 16
//     as its destination, and each warp writes whole row segments as
//     float4 at 16-byte-aligned addresses, with at most 3 scalars at each
//     end.  Every output element is written once, by one thread: no
//     atomics, and two calls give the same bits.
//   - One wave in lockstep, stores from too few warps: at B = 1024 the
//     time is the store stream (a flat fill_ of the same 15.18 MB takes
//     ~6 us on this card, PERF.md), and it drains faster the more warps
//     have stores in flight.  The 64 x 128 tile's kernel is held to 64
//     registers a thread and takes 40.4 KiB of shared memory at r = 15, so
//     four 256-thread CTAs share an SM and all 464 tiles of the bucket are
//     in flight at once, each at its own phase of staging, products or
//     stores.  A persistent grid
//     (min(tiles, resident CTAs), each CTA walking tiles with the next
//     tile's copies in flight during this tile's stores) was built and
//     measured: at the four serving buckets every tile already has a
//     resident CTA, and capping the grid so that CTAs walk was 17-76%
//     slower at B = 1024 (PERF.md), since a CTA's stores then go out one
//     tile after another.  So the grid is a CTA for every tile; a catalog
//     larger than the card holds at once runs in waves.
//   - Small buckets did not fill the card (B = 16 launched 29 CTAs): the
//     tile shape is picked by (B, n) from kTiles, the largest tile that
//     still gives every SM a tile, else 32 x 64: the fastest shape measured
//     at each of the four buckets.  16-user tiles, and tiles of whole rows
//     against a catalog held in shared memory, were slower at every bucket,
//     and bulk (TMA) stores of the row bodies no faster than float4
//     (PERF.md).
// * r > 64, up to the wrapper's MAX_RANK: dequant_score_kernel, the first
//   kernel, unchanged: one CTA of 32 x 8 threads per 32 x 128 tile, the
//   rank walked in 32-byte chunks staged by byte loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --- the first kernel, for r > kStagedMaxRank ----------------------------

constexpr int kTX = 32;                 // threads along items
constexpr int kTY = 8;                  // threads along users
constexpr int kThreads = kTX * kTY;
constexpr int kRows = 4;                // users per thread
constexpr int kCols = 4;                // items per thread
constexpr int kBM = kTY * kRows;        // 32 users per CTA
constexpr int kBN = kTX * kCols;        // 128 items per CTA
constexpr int kChunk = 32;              // code bytes of the rank per step
constexpr int kStride = kChunk / 4 + 1; // words per staged row (odd)

__global__ void __launch_bounds__(kThreads) dequant_score_kernel(
    const int8_t* __restrict__ uq, const float* __restrict__ us,
    const int8_t* __restrict__ wq, const float* __restrict__ ws,
    float* __restrict__ out, int B, int n, int r) {
  __shared__ int su[kBM * kStride];
  __shared__ int sw[kBN * kStride];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  int acc[kRows][kCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b < kCols; ++b) acc[a][b] = 0;

  for (int k0 = 0; k0 < r; k0 += kChunk) {
    const int kc = min(kChunk, r - k0);   // code bytes in this chunk
    const int kp = (kc + 3) & ~3;         // padded to whole words
    for (int e = tid; e < (kBM + kBN) * kp; e += kThreads) {
      const int row = e / kp, kb = e - row * kp;
      int8_t v = 0;
      if (row < kBM) {
        const int i = i0 + row;
        if (i < B && kb < kc) v = uq[(size_t)i * r + k0 + kb];
        reinterpret_cast<int8_t*>(su + row * kStride)[kb] = v;
      } else {
        const int j = j0 + row - kBM;
        if (j < n && kb < kc) v = wq[(size_t)j * r + k0 + kb];
        reinterpret_cast<int8_t*>(sw + (row - kBM) * kStride)[kb] = v;
      }
    }
    __syncthreads();
    for (int w = 0; w < kp / 4; ++w) {
      int a[kRows], b[kCols];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) a[ii] = su[(ty + kTY * ii) * kStride + w];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) b[jj] = sw[(tx + kTX * jj) * kStride + w];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          acc[ii][jj] = __dp4a(a[ii], b[jj], acc[ii][jj]);
    }
    __syncthreads();
  }

  float sws[kCols];
#pragma unroll
  for (int jj = 0; jj < kCols; ++jj) {
    const int j = j0 + tx + kTX * jj;
    sws[jj] = j < n ? ws[j] : 0.f;
  }
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int i = i0 + ty + kTY * ii;
    if (i >= B) continue;
    const float s = us[i];
    float* row = out + (size_t)i * n;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int j = j0 + tx + kTX * jj;
      // the plain version's order: (float(acc) * s_u) * s_w, no contraction
      if (j < n)
        row[j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[ii][jj]), s), sws[jj]);
    }
  }
}

// --- the staged kernel, for r <= kStagedMaxRank ----------------------------

constexpr int kStagedMaxRank = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit_and_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Shared-memory room for a run of `len` bytes copied to the address that
// matches its source modulo 16: up to 15 bytes of offset, and 8 bytes past
// the end that the spread pass may read (and masks off).
__host__ __device__ constexpr int run_room(int len) {
  return ((len + 15) & ~15) + 32;
}

// Byte offsets of a tile's regions in dynamic shared memory: the scores
// tile first (BM rows of BN + 4 floats), then the rooms of the runs of Q_u,
// s_u, Q_w and s_w, then the word rows of both sides (users first).
struct Layout {
  int ld;                 // floats per row of the scores tile
  int stride;             // words per staged code row (odd)
  int qu, su, qw, sw;     // offsets of the four runs' rooms
  int words;              // offset of the word rows
  int total;
  __host__ __device__ Layout(int bm, int bn, int r) {
    ld = bn + 4;
    stride = ((r + 3) / 4) | 1;
    qu = 4 * bm * ld;
    su = qu + run_room(bm * r);
    qw = su + run_room(4 * bm);
    sw = qw + run_room(bn * r);
    words = sw + run_room(4 * bn);
    total = words + 4 * (bm + bn) * stride;
  }
};

// Issue the copies of `len` bytes from `src` into the room at `room`, so
// that they land at room + (src & 15): the 16-byte pieces by cp.async, a
// head or tail off the 16-byte grid by bytes.  Returns where they landed.
__device__ __forceinline__ const unsigned char* stage_run(
    const void* src, int len, unsigned char* room, int tid) {
  const unsigned char* g = static_cast<const unsigned char*>(src);
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  unsigned char* dst = room + off;
  const int head = min(len, (16 - off) & 15);
  const int body = (len - head) & ~15;
  for (int c = tid; c < body / 16; c += kThreads)
    cp_async16(dst + head + 16 * c, g + head + 16 * c);
  const int rest = len - head - body;
  for (int e = tid; e < head + rest; e += kThreads) {
    const int k = e < head ? e : head + body + (e - head);
    dst[k] = g[k];
  }
  return dst;
}

// Spread `rows` code rows of r bytes, flat at `flat`, into word rows of
// `stride` words at `words`; bytes past r and rows past `valid` are zeros.
__device__ __forceinline__ void spread(const unsigned char* flat, int valid,
                                       int rows, int r, int stride,
                                       int* words, int tid) {
  const int kw = (r + 3) / 4;
  const int base = static_cast<int>(reinterpret_cast<uintptr_t>(flat) & 3);
  const unsigned* aligned = reinterpret_cast<const unsigned*>(flat - base);
  for (int e = tid; e < rows * kw; e += kThreads) {
    const int row = e / kw, w = e - row * kw;
    unsigned v = 0;
    if (row < valid) {
      const int at = base + row * r + 4 * w;      // byte from `aligned`
      v = __funnelshift_r(aligned[at >> 2], aligned[(at >> 2) + 1],
                          8 * (at & 3));
      const int left = r - 4 * w;                 // this row's bytes here
      if (left < 4) v &= (1u << (8 * left)) - 1u;
    }
    words[row * stride + w] = static_cast<int>(v);
  }
}

// Tile shapes: BM = kTY * RM users x BN = kTX * RN items, one CTA of the
// first kernel's 32 x 8 threads, each with an RM x RN block of outputs
// (users ty + kTY*ii, items tx + kTX*jj).  BM and BN are multiples of 16,
// so a tile's code runs start 16-byte aligned whenever the tensors do.
// `ctas` is the CTAs an SM that the register budget must leave room for:
// four (64 registers a thread) for the shapes that can outnumber the SMs
// several times over, so that all 464 tiles of the B = 1024 bucket are in
// flight at once; two for 32 x 64, which pick_tile takes only when 32 x 128
// gives fewer tiles than there are SMs, so fewer than two an SM.
struct Tile {
  int rm, rn, ctas;
};
constexpr Tile kTiles[] = {
    {8, 4, 4},   // 64 x 128
    {4, 4, 4},   // 32 x 128
    {4, 2, 2},   // 32 x 64
};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

template <int RM, int RN, int CTAS>
__global__ void __launch_bounds__(kThreads, CTAS) staged_score_kernel(
    const int8_t* __restrict__ uq, const float* __restrict__ us,
    const int8_t* __restrict__ wq, const float* __restrict__ ws,
    float* __restrict__ out, int B, int n, int r) {
  constexpr int BM = kTY * RM, BN = kTX * RN;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(BM, BN, r);
  float* tile = reinterpret_cast<float*>(smem);
  int* wu = reinterpret_cast<int*>(smem + L.words);
  int* ww = wu + BM * L.stride;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int lane = tid & 31, warp = tid >> 5;
  const int tiles_n = (n + BN - 1) / BN;
  const int i0 = (blockIdx.x / tiles_n) * BM, j0 = (blockIdx.x % tiles_n) * BN;
  const int vu = min(BM, B - i0), vw = min(BN, n - j0);

  const unsigned char* cu =
      stage_run(uq + (size_t)i0 * r, vu * r, smem + L.qu, tid);
  const float* s_u = reinterpret_cast<const float*>(
      stage_run(us + i0, 4 * vu, smem + L.su, tid));
  const unsigned char* cw =
      stage_run(wq + (size_t)j0 * r, vw * r, smem + L.qw, tid);
  const float* s_w = reinterpret_cast<const float*>(
      stage_run(ws + j0, 4 * vw, smem + L.sw, tid));
  cp_async_commit_and_wait();
  __syncthreads();     // the tile's runs are in
  spread(cu, vu, BM, r, L.stride, wu, tid);
  spread(cw, vw, BN, r, L.stride, ww, tid);
  __syncthreads();     // the word rows are ready

  int acc[RM][RN];
#pragma unroll
  for (int ii = 0; ii < RM; ++ii)
#pragma unroll
    for (int jj = 0; jj < RN; ++jj) acc[ii][jj] = 0;
  for (int w = 0; w < (r + 3) / 4; ++w) {
    int a[RM], c[RN];
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) a[ii] = wu[(ty + kTY * ii) * L.stride + w];
#pragma unroll
    for (int jj = 0; jj < RN; ++jj) c[jj] = ww[(tx + kTX * jj) * L.stride + w];
#pragma unroll
    for (int ii = 0; ii < RM; ++ii)
#pragma unroll
      for (int jj = 0; jj < RN; ++jj)
        acc[ii][jj] = __dp4a(a[ii], c[jj], acc[ii][jj]);
  }

  // scores into the tile, row i at the float that matches its
  // destination's address modulo 16 bytes
#pragma unroll
  for (int ii = 0; ii < RM; ++ii) {
    const int i = ty + kTY * ii;
    const float s = s_u[i];                 // rows past vu: never stored
    const int pad = static_cast<int>(
        (reinterpret_cast<uintptr_t>(out + (size_t)(i0 + i) * n + j0) >> 2) &
        3);
    float* row = tile + i * L.ld + pad;
#pragma unroll
    for (int jj = 0; jj < RN; ++jj) {
      const int j = tx + kTX * jj;
      // the plain version's order: (float(acc) * s_u) * s_w
      row[j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[ii][jj]), s), s_w[j]);
    }
  }
  __syncthreads();     // the tile is complete

  // each warp writes whole row segments: scalars up to the first 16-byte
  // boundary, float4 bodies, scalars after the last
  for (int i = warp; i < vu; i += kWarps) {
    float* g = out + (size_t)(i0 + i) * n + j0;
    const int pad = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
    const float* s = tile + i * L.ld + pad;
    const int head = min(vw, (4 - pad) & 3);
    const int body = (vw - head) >> 2;
    const int tail = vw - head - 4 * body;
    for (int v = lane; v < body; v += 32)
      reinterpret_cast<float4*>(g + head)[v] =
          reinterpret_cast<const float4*>(s + head)[v];
    if (lane < head) g[lane] = s[lane];
    if (lane < tail) g[head + 4 * body + lane] = s[head + 4 * body + lane];
  }
}

using Kernel = void (*)(const int8_t*, const float*, const int8_t*,
                        const float*, float*, int, int, int);

const Kernel kKernels[kNumTiles] = {
    staged_score_kernel<kTiles[0].rm, kTiles[0].rn, kTiles[0].ctas>,
    staged_score_kernel<kTiles[1].rm, kTiles[1].rn, kTiles[1].ctas>,
    staged_score_kernel<kTiles[2].rm, kTiles[2].rn, kTiles[2].ctas>};

// What the C entry reads of each device once: its SM count, and whether
// each kernel's dynamic shared-memory limit has been raised to what its
// largest rank needs.  Writes race only with writes of the same values.
struct DeviceState {
  int sms;                                   // 0: not read yet
  bool smem_set[kNumTiles];
};
constexpr int kMaxDevices = 16;
DeviceState g_dev[kMaxDevices];

// What dequant_score returns after a launch that went through: the kernel
// it ran, as its tile shape BM << 16 | BN (read from the kTiles entry that
// instantiated it: kKernels[k] is staged_score_kernel<kTiles[k]...>), or
// kFirstKernel for the first kernel.  Both lie at or above 1 << 16, above
// every cudaError_t, so one return value carries the error or the kernel
// and the wrapper makes one call a launch.
constexpr int kFirstKernel = 1 << 16;

long long tile_count(int k, int B, int n) {
  const int bm = kTY * kTiles[k].rm, bn = kTX * kTiles[k].rn;
  return (long long)((B + bm - 1) / bm) * ((n + bn - 1) / bn);
}

// The tile shape for (B, n): the largest that still gives every SM a tile,
// else the smallest (from the four serving buckets' measurements, PERF.md).
int pick_tile(int B, int n, int sms) {
  for (int k = 0; k < kNumTiles; ++k)
    if (tile_count(k, B, n) >= sms) return k;
  return kNumTiles - 1;
}

int launch_first(const void* uq, const float* us, const void* wq,
                 const float* ws, float* out, int B, int n, int r,
                 cudaStream_t stream, int* kernel) {
  const dim3 grid((n + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  dequant_score_kernel<<<grid, dim3(kTX, kTY), 0, stream>>>(
      static_cast<const int8_t*>(uq), us, static_cast<const int8_t*>(wq), ws,
      out, B, n, r);
  *kernel = kFirstKernel;
  return (int)cudaGetLastError();
}

// One CTA for each tile of the shape pick_tile gives.
int launch_staged(const void* uq, const float* us, const void* wq,
                  const float* ws, float* out, int B, int n, int r,
                  cudaStream_t stream, int* kernel) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  DeviceState& d = g_dev[dev];
  if (d.sms == 0) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int k = pick_tile(B, n, d.sms);
  const int bm = kTY * kTiles[k].rm, bn = kTX * kTiles[k].rn;
  if (!d.smem_set[k]) {
    err = cudaFuncSetAttribute(kKernels[k],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout(bm, bn, kStagedMaxRank).total);
    if (err != cudaSuccess) return (int)err;
    d.smem_set[k] = true;
  }
  const long long tiles = tile_count(k, B, n);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kKernels[k]<<<(unsigned)tiles, kThreads, Layout(bm, bn, r).total,
                stream>>>(static_cast<const int8_t*>(uq), us,
                          static_cast<const int8_t*>(wq), ws, out, B, n, r);
  *kernel = bm << 16 | bn;
  return (int)cudaGetLastError();
}

}  // namespace

// A cudaError_t (below 1 << 16) if the launch failed, else the kernel it
// ran (kFirstKernel's comment).
extern "C" int dequant_score(const void* uq, const float* us, const void* wq,
                             const float* ws, float* out, int B, int n, int r,
                             void* stream) {
  if (B <= 0 || n <= 0 || r < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int kernel = 0;
  const int err =
      r > kStagedMaxRank
          ? launch_first(uq, us, wq, ws, out, B, n, r, s, &kernel)
          : launch_staged(uq, us, wq, ws, out, B, n, r, s, &kernel);
  return err != cudaSuccess ? err : kernel;
}

// The first kernel at any rank, with dequant_score's arguments: the old
// kernel that chip_smoke.py times beside the staged one on the same inputs.
// Returns cudaGetLastError().
extern "C" int dequant_score_first(const void* uq, const float* us,
                                   const void* wq, const float* ws,
                                   float* out, int B, int n, int r,
                                   void* stream) {
  if (B <= 0 || n <= 0 || r < 1) return (int)cudaErrorInvalidValue;
  int kernel = 0;
  return launch_first(uq, us, wq, ws, out, B, n, r,
                      static_cast<cudaStream_t>(stream), &kernel);
}
