// Flash attention (tiled online softmax) of the LM prefill, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _kernel) in
// src/repro/kernels/flash_attention/kernel.py.  For q (B, Hq, Lq, D) and
// k (B, Hkv, Lk, D), v (B, Hkv, Lk, Dv), contiguous, it writes
//   o = softmax(softcap(q k^T / sqrt(D))) v        over the unmasked keys
// where key kpos is masked for query qpos = i + q_offset when kpos >= Lk,
// when causal and qpos < kpos, or when window > 0 and qpos - kpos >= window.
// Masked logits are -1e30 and their probabilities are zeroed; a row with no
// unmasked key gives 0, as the TPU kernel's _finalize does.  The math is
// float32 (inputs f32 or bf16, converted on load), softcap uses tanhf and
// the exponentials expf: no fast-math approximations.  The output has q's
// dtype.
//
// Bound on this card: operations.  At the gemma2-2b prefill (B = 4, Hq = 8,
// L = 8000, D = 256) a global layer does 4 D flops for each of its ~1.02e9
// live (q, k) pairs, 1.05 TFLOP, 15.7 ms at 67 TFLOP/s of f32; q, k, v and
// o are 786 MB, 0.23 ms at 3.35 TB/s.
//
// Design, simple and f32 on the CUDA cores:
// * One CTA of 256 threads (16 x 16) per (b*Hq + h, 64-row q tile); the
//   q tiles of one head are neighbours in the grid (their K/V stay in L2)
//   and the most expensive causal tiles are scheduled first.  The loop over
//   64-row key tiles runs inside the CTA, in place of the TPU's sequential
//   key grid axis; the running max, denominator and the 64 x Dv f32
//   accumulator live in registers and the output is written once.
// * The TPU's per-tile early-out becomes loop bounds: the first key tile
//   is the one holding max(0, q_lo - window + 1), the last the one holding
//   the causal diagonal of the tile's last row, so a local layer does
//   O(L * window) work.  The element masks still apply inside the edge
//   tiles and past Lk.
// * GQA by index: the KV head is (bh % Hq) / (Hq / Hkv); K/V are never
//   repeated.
// * Any D, Dv <= 256 and any Lq, Lk: no padding in the caller.  Rows past
//   Lq/Lk and columns past D are zero-filled in shared memory; the scale is
//   1/sqrt(D) of the true D.
// * Shared memory: the Q tile (64 x D), one K tile (64 x D), one V tile
//   (64 x DMAX) and the P tile (64 x 64), all f32: 211 KB at D = 256, one
//   CTA per SM, dynamic shared memory above 48 KB.  32-row K/V tiles would
//   halve the K/V buffers but not give a second CTA per SM (the f32 Q tile
//   alone is 65 KB), and a 64-row tile gives each thread a 4 x 4 block of
//   the logits and a 4 x (DMAX/16) block of the output: about four
//   multiply-adds for every shared-memory word it reads, which keeps the
//   FMA pipes, not shared memory, the limit.
// * f32 inputs whose rows are 16-byte aligned are copied with cp.async:
//   the V tile arrives while the logits are computed, the next K tile while
//   P.V is.  bf16 inputs (and f32 with D % 4 != 0) are loaded and converted
//   by the threads.
// Tensor cores (wgmma in bf16 or TF32) and TMA are later work; they also
// change the numerics of an f32 model.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // key rows per tile
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kPS = kBK + 4;   // P tile row stride (floats)
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile moves 64-row tiles of Q, K and V");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;          // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows [row0, row0 + 64) of a (L, width) matrix into smem rows of `stride`
// floats; rows >= L are zeros.  kAsync: cp.async in 16-byte pieces (f32,
// width % 4 == 0), otherwise the threads load, convert and store, and the
// columns [width, padded) are zeroed too.
template <typename T, bool kAsync>
__device__ __forceinline__ void load_tile(float* smem, int stride,
                                          const T* g, int row0, int L,
                                          int width, int padded) {
  const int tid = threadIdx.y * kTX + threadIdx.x;
  if constexpr (kAsync) {
    const int w4 = width / 4;
    for (int c = tid; c < kBK * w4; c += kThreads) {
      const int r = c / w4, d = (c - r * w4) * 4;
      const bool ok = row0 + r < L;
      const float* src = reinterpret_cast<const float*>(g) +
                         (ok ? (size_t)(row0 + r) * width + d : 0);
      cp_async16(smem + r * stride + d, src, ok);
    }
  } else {
    for (int e = tid; e < kBK * padded; e += kThreads) {
      const int r = e / padded, d = e - r * padded;
      float x = 0.f;
      if (row0 + r < L && d < width) x = to_f32(g[(size_t)(row0 + r) * width + d]);
      smem[r * stride + d] = x;
    }
  }
}

template <typename T, int DMAX, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Hq, int Hkv, int Lq, int Lk, int D, int Dv,
    int causal, int window, float softcap, float scale, int q_offset) {
  constexpr int NC = DMAX / 64;          // float4 column groups per thread
  const int DQ = (D + 3) & ~3;           // Q/K columns in smem
  const int QS = DQ + 4;                 // Q/K row stride: 16 B aligned,
                                         // quarter-warp conflict-free
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;             // row stride DMAX
  float* Ps = Vs + kBK * DMAX;           // row stride kPS

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int b = bh / Hq, kvh = (bh % Hq) / (Hq / Hkv);
  const T* qg = q + (size_t)bh * Lq * D;
  const T* kg = k + ((size_t)b * Hkv + kvh) * Lk * D;
  const T* vg = v + ((size_t)b * Hkv + kvh) * Lk * Dv;
  const int r0 = qt * kBQ;                    // first q row of the tile
  const int q_lo = r0 + q_offset;             // its absolute position
  const int q_hi = min(r0 + kBQ, Lq) - 1 + q_offset;

  // key tiles [kt0, kt1]: the TPU kernel's early-out as loop bounds
  int k_last = Lk - 1;
  if (causal) k_last = min(k_last, q_hi);
  int k_first = 0;
  if (window > 0) k_first = max(0, q_lo - window + 1);
  const int kt0 = k_first / kBK;
  const int kt1 = k_last < k_first ? kt0 - 1 : k_last / kBK;

  // V columns past Dv are never written by the loads: zero them once
  for (int e = tid; e < kBK * DMAX; e += kThreads)
    if (e % DMAX >= Dv) Vs[e] = 0.f;
  // Q tile (with the first K tile: one cp.async group), then the first V
  load_tile<T, kAsync>(Qs, QS, qg, r0, Lq, D, DQ);
  if (kt0 <= kt1) load_tile<T, kAsync>(Ks, QS, kg, kt0 * kBK, Lk, D, DQ);
  cp_async_commit();
  if (kt0 <= kt1) load_tile<T, kAsync>(Vs, DMAX, vg, kt0 * kBK, Lk, Dv, Dv);
  cp_async_commit();

  float acc[4][NC * 4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k_lo = kt * kBK;
    cp_async_wait_all_but_one();             // Q and this K tile are in
    __syncthreads();

    // logits: rows ty*4 + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < DQ; d += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bb[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bb[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bb[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bb[j].w, s[i][j]);
        }
    }

    // mask, online softmax; a row's 64 keys sit on the 16 lanes of one
    // half-warp
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + ty * 4 + i;
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_lo + tx + 16 * j;
        bool ok = kpos < Lk;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        live[j] = ok;
        float x = s[i][j] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();                         // P written, K tile consumed

    if (kt < kt1) load_tile<T, kAsync>(Ks, QS, kg, (kt + 1) * kBK, Lk, D, DQ);
    cp_async_commit();
    cp_async_wait_all_but_one();             // this V tile is in
    __syncthreads();

    // acc = acc * alpha + P V: rows ty*4 + i, columns 64 c + 4 tx + (0..3)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= alpha[i];
    for (int j = 0; j < kBK; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kPS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (j + jj) * DMAX + c * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pj = jj == 0 ? p[i].x : jj == 1 ? p[i].y
                           : jj == 2 ? p[i].z : p[i].w;
            acc[i][c * 4 + 0] = fmaf(pj, vv.x, acc[i][c * 4 + 0]);
            acc[i][c * 4 + 1] = fmaf(pj, vv.y, acc[i][c * 4 + 1]);
            acc[i][c * 4 + 2] = fmaf(pj, vv.z, acc[i][c * 4 + 2]);
            acc[i][c * 4 + 3] = fmaf(pj, vv.w, acc[i][c * 4 + 3]);
          }
        }
      }
    }
    __syncthreads();                         // V and P tiles consumed

    if (kt < kt1) load_tile<T, kAsync>(Vs, DMAX, vg, (kt + 1) * kBK, Lk, Dv, Dv);
    cp_async_commit();
  }
  cp_async_wait_all();                       // no copy outlives the CTA

  // finalize: a row with no live key (l == 0) gives 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= Lq) continue;
    const float inv = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((size_t)bh * Lq + r) * Dv;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 64 + tx * 4 + e;
        if (d < Dv) store(orow + d, acc[i][c * 4 + e] / inv);
      }
  }
}

template <int DMAX>
size_t smem_bytes(int D) {
  const int QS = ((D + 3) & ~3) + 4;
  return sizeof(float) *
         ((size_t)(kBQ + kBK) * QS + (size_t)kBK * DMAX + (size_t)kBQ * kPS);
}

template <typename T, int DMAX, bool kAsync>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int Lq, int Lk, int D, int Dv, int causal, int window,
           float softcap, int q_offset, cudaStream_t stream) {
  auto kern = flash_kernel<T, DMAX, kAsync>;
  const size_t bytes = smem_bytes<DMAX>(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, dim3(kTX, kTY), bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Lq, Lk, D, Dv,
      causal, window, softcap, 1.0f / sqrtf((float)D), q_offset);
  return (int)cudaGetLastError();
}

template <typename T, bool kAsync>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Lq, int Lk, int D, int Dv, int causal,
             int window, float softcap, int q_offset, cudaStream_t stream) {
  const int dmax = D > Dv ? D : Dv;
  if (dmax <= 64)
    return launch<T, 64, kAsync>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, Dv,
                                 causal, window, softcap, q_offset, stream);
  if (dmax <= 128)
    return launch<T, 128, kAsync>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, Dv,
                                  causal, window, softcap, q_offset, stream);
  return launch<T, 256, kAsync>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, Dv,
                                causal, window, softcap, q_offset, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  aligned: f32 rows of q, k and v start
// on 16-byte boundaries (the caller checks the pointers, D % 4 and Dv % 4).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int Lq, int Lk,
                               int D, int Dv, int causal, int window,
                               float softcap, int q_offset, int dtype,
                               int aligned, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Lq <= 0 || Lk <= 0 ||
      D <= 0 || D > 256 || Dv <= 0 || Dv > 256 || B * Hq > 65535 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && aligned)
    return dispatch<float, true>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, Dv, causal,
                                 window, softcap, q_offset, s);
  if (dtype == 0)
    return dispatch<float, false>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, Dv,
                                  causal, window, softcap, q_offset, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, false>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D,
                                          Dv, causal, window, softcap,
                                          q_offset, s);
  return (int)cudaErrorInvalidValue;
}
