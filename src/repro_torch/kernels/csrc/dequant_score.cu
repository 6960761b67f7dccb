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
// Bound on this card: bytes, and almost all of them the output.  At a
// serving bucket of B = 1024 users against n = 3706 items at r = 15 the
// scores are 15.18 MB and the inputs 0.09 MB (Q_w 56 KB, s_w 15 KB, Q_u
// 15 KB, s_u 4 KB): ~4.6 us at 3.35 TB/s.  The 114 M int8 multiply-adds
// take 0.06 us at the tensor cores' int8 rate, so the work is the store.
//
// Design, simple first: one CTA of 32 x 8 threads per tile of 32 users x
// 128 items.  The TPU kernel keeps the user batch resident in VMEM and
// streams item tiles through a sequential grid; here every tile is its own
// CTA and the codes (a few KB) come from L2.  The rank is walked in chunks
// of at most 32 code bytes: each chunk's code rows are staged in shared
// memory as int8, zero-padded to a multiple of 4 and at the ragged B and n
// edges, and consumed four at a time by __dp4a (signed int8 x 4 dot with
// int32 accumulate).  Each thread holds a 4 x 4 accumulator: users ty + 8i,
// items tx + 32j, so a warp stores 32 neighbouring floats of one output
// row (128 B, coalesced along n).  The shared-memory row stride is an odd
// number of words, so the 32 lanes' item rows fall in 32 distinct banks;
// the user rows are a broadcast.  Tensor cores (mma.sync int8) and TMA
// stores are for a later revision: the product is not what binds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

extern "C" int dequant_score(const void* uq, const float* us, const void* wq,
                             const float* ws, float* out, int B, int n, int r,
                             void* stream) {
  if (B <= 0 || n <= 0 || r < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  dequant_score_kernel<<<grid, dim3(kTX, kTY), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(uq), us, static_cast<const int8_t*>(wq), ws,
      out, B, n, r);
  return (int)cudaGetLastError();
}
