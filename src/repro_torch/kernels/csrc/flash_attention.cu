// Flash attention (tiled online softmax) of the LM prefill, hand-written for
// Hopper (sm_90a), with both products on the tensor cores.
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _kernel) in
// src/repro/kernels/flash_attention/kernel.py.  For q (B, Hq, Lq, D) and
// k (B, Hkv, Lk, D), v (B, Hkv, Lk, Dv), contiguous, it writes
//   o = softmax(softcap(q k^T / sqrt(D))) v        over the unmasked keys
// where key kpos is masked for query qpos = i + q_offset when kpos >= Lk,
// when causal and qpos < kpos, or when window > 0 and qpos - kpos >= window.
// Masked logits are -1e30 and their probabilities are exactly 0; a row with
// no unmasked key gives 0, as the TPU kernel's _finalize does.  The math is
// float32 (inputs f32 or bf16, converted on load), softcap uses tanhf and
// the exponentials expf: no fast-math approximations.  The output has q's
// dtype.
//
// Bound on this card: operations.  At the gemma2-2b prefill (B = 4, Hq = 8,
// L = 8000, D = 256) a global layer does 4 D flops for each of its ~1.02e9
// live (q, k) pairs, 1.049 TFLOP (a local layer, window 4096: 0.799).  On
// the f32 CUDA cores (67 TFLOP/s) that is 15.65 ms (11.92 local).  Here each
// f32 product is three TF32 tensor-core products (below): 3 x 1.049 TFLOP
// at 495 TFLOP/s is 6.36 ms (4.84 local).  q, k, v and o are 786 MB, 0.23
// ms at 3.35 TB/s.  mma.sync reaches ~300 of the 495 TFLOP/s on an H100
// (scripts/flash_kernel_probe.py); the data-sheet rate needs wgmma.
//
// f32 accuracy on TF32 tensor cores (3xTF32).  Every operand x is split
// into big = rna(x) and small = rna(x - big), both TF32 rounded to nearest
// with ties away (cvt.rna.tf32.f32; x - big is exact in f32), and a . b is
// small_a big_b + big_a small_b + big_a big_b on mma.sync.aligned.m16n8k8
// with f32 accumulation.  The dropped small_a small_b and the rounding of
// the small parts are ~2^-22 of |a b|, against 2^-24 for one f32 FMA, so
// the result stays within a small factor of a plain f32 computation; one
// TF32 pass (10 mantissa bits) would not.  The MMA truncates its f32 sums,
// so no MMA chain runs long: Q.K^T keeps the two correction products apart
// from big . big, and P.V sums each key tile into a zeroed accumulator that
// one f32 FMA folds into the output.  bf16 inputs are exact in TF32 (their
// small part is 0): Q.K^T takes one product and P.V two (P is f32).
//
// Design:
// * One CTA of 8 warps per (b*Hq + h, 128-row q tile); each warp owns 16
//   query rows.  The q tiles of one head are neighbours in the grid (their
//   K/V stay in L2) and the most expensive causal tiles are scheduled
//   first.  The loop over 32-key tiles runs inside the CTA, in place of the
//   TPU's sequential key grid axis; the running max, the denominator and
//   the warp's 16 x Dv f32 accumulator (128 registers a thread at Dv = 256)
//   live in registers and the output is written once.
// * The TPU's per-tile early-out becomes loop bounds: the first key tile is
//   the one holding max(0, q_lo - window + 1), the last the one holding the
//   causal diagonal of the tile's last row, so a local layer does
//   O(L * window) work.  Inside them a warp whose 16 rows see no key of a
//   tile skips it, and a tile whose keys all rows see skips the masks.
// * GQA by index: the KV head is (bh % Hq) / (Hq / Hkv); K/V are never
//   repeated.
// * Any D, Dv <= 256 and any Lq, Lk: no padding in the caller.  Rows past
//   Lq/Lk are zero-filled in shared memory, columns past D up to the MMA's
//   k-step of 8 and past Dv up to the accumulator's width are zeroed, and
//   the scale is 1/sqrt(D) of the true D.
// * P stays in registers.  An m16n8k8 C fragment holds columns 2t, 2t+1 of
//   a row where the A fragment wants columns t, t+4; since P.V sums over
//   the keys, the k-step reads key 2t as its k = t and key 2t+1 as k = t+4,
//   and V's B fragment reads the same two keys.  Q.K^T permutes D the same
//   way, so each thread loads its two Q (or K) values with one 8-byte load.
//   Nothing passes through shared memory between the two products, and a
//   warp's softmax needs no barrier.
// * Shared memory: Q (128 x D), one K tile (32 x D) and one V tile (32 x
//   Dv rounded up to 64, 128 or 256), f32: 198 KB at D = 256, one CTA per
//   SM.  The Q/K row stride
//   is 8 mod 16 floats and V's 4 mod 8, so every fragment load is free of
//   bank conflicts.  f32 inputs whose rows are 16-byte aligned are copied
//   with cp.async: the V tile arrives while the logits are computed, the
//   next K tile while P.V is.  bf16 inputs (and f32 with D % 4 != 0) are
//   loaded and converted by the threads.
// * What limits it: the splits and fragment loads are ~5 instructions per
//   MMA, the softmax (tanhf, expf) leaves the tensor pipe idle, and the
//   accumulator's 128 registers and the f32 Q tile leave no room to keep
//   split operands or to overlap a tile's softmax with another's products.
//   Later steps: wgmma from shared-memory descriptors, TMA, a producer warp
//   and a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Phase clocks, off unless built with -DFLASH_PHASE_CLOCKS (as
// scripts/flash_kernel_probe.py builds it): each warp adds the SM cycles it
// spends in each of the six phases of the key-tile loop to
// flash_phase_cycles[0..5], and 1 to [6].
#ifdef FLASH_PHASE_CLOCKS
__device__ unsigned long long flash_phase_cycles[7];
#define PHASE_INIT()                  \
  unsigned long long ph_[6] = {};     \
  long long ph_t_ = clock64()
#define PHASE(i)                      \
  do {                                \
    const long long c_ = clock64();   \
    ph_[i] += c_ - ph_t_;             \
    ph_t_ = c_;                       \
  } while (0)
#define PHASE_FLUSH()                                            \
  do {                                                           \
    if ((threadIdx.x & 31) == 0) {                               \
      for (int i_ = 0; i_ < 6; ++i_)                             \
        atomicAdd(&flash_phase_cycles[i_], ph_[i_]);             \
      atomicAdd(&flash_phase_cycles[6], 1ull);                   \
    }                                                            \
  } while (0)
#else
#define PHASE_INIT()
#define PHASE(i)
#define PHASE_FLUSH()
#endif

namespace {

constexpr int kBQ = 128;       // query rows per CTA (16 per warp)
constexpr int kBK = 32;        // keys per tile
constexpr int NJ = kBK / 8;    // 8-key MMA tiles per key tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

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

// x = big + small to ~2^-22, both rounded to TF32 to nearest, ties away
// (cvt.rna.tf32.f32).  ptxas lowers that cvt to a finite check, an add, a
// select and a mask; for finite x the add of half a TF32 ulp and the mask
// alone give the same bits, and small needs no mask because the MMA reads
// only a TF32 operand's upper 19 bits.  kSmall false: x is exact in TF32
// (a bf16 input) and small is not formed.
template <bool kSmall>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  if constexpr (kSmall)
    small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// c += a b on one m16n8k8 TF32 tile, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + ROWS) of a (L, width) matrix into smem rows of
// `stride` floats; rows >= L are zeros.  kAsync: cp.async in 16-byte pieces
// (f32, width % 4 == 0), otherwise the threads load, convert and store, and
// the columns [width, padded) are zeroed too.
template <int ROWS, typename T, bool kAsync>
__device__ __forceinline__ void load_tile(float* smem, int stride,
                                          const T* g, int row0, int L,
                                          int width, int padded) {
  if constexpr (kAsync) {
    const int w4 = width / 4;
    for (int c = threadIdx.x; c < ROWS * w4; c += kThreads) {
      const int r = c / w4, d = (c - r * w4) * 4;
      const bool ok = row0 + r < L;
      const float* src = reinterpret_cast<const float*>(g) +
                         (ok ? (size_t)(row0 + r) * width + d : 0);
      cp_async16(smem + r * stride + d, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * padded; e += kThreads) {
      const int r = e / padded, d = e - r * padded;
      float x = 0.f;
      if (row0 + r < L && d < width)
        x = to_f32(g[(size_t)(row0 + r) * width + d]);
      smem[r * stride + d] = x;
    }
  }
}

// columns [width, padded) of ROWS rows: never written by cp.async
template <int ROWS>
__device__ __forceinline__ void zero_pad(float* smem, int stride, int width,
                                         int padded) {
  const int pad = padded - width;
  for (int e = threadIdx.x; e < ROWS * pad; e += kThreads)
    smem[(e / pad) * stride + width + e % pad] = 0.f;
}

// Q/K row stride: 8 mod 16 floats, so the 8-byte fragment loads of a
// half-warp (rows g = 0..3, columns 2t) hit 32 distinct banks
__host__ __device__ __forceinline__ int qk_stride(int D) {
  const int dq = (D + 7) & ~7;
  return dq % 16 ? dq : dq + 8;
}
// V row stride: 4 mod 8 floats, so the scalar loads of a warp (rows 2t,
// columns g) hit 32 distinct banks
template <int DMAX>
constexpr int kVS = DMAX + 4;

template <typename T, int DMAX, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Hq, int Hkv, int Lq, int Lk, int D, int Dv,
    int causal, int window, float softcap, float scale, int q_offset) {
  constexpr bool kWide = std::is_same<T, float>::value;  // small parts != 0
  constexpr int NT = DMAX / 8;           // 8-column output tiles per warp
  constexpr int VS = kVS<DMAX>;
  const int DQ = (D + 7) & ~7;
  const int QS = qk_stride(D);
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;     // the fragments' row, column
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

  // the keys this warp's rows can see
  const int wr = r0 + warp * 16;              // the warp's first q row
  const bool w_rows = wr < Lq;
  const int wq_lo = wr + q_offset;
  const int wq_hi = min(wr + 15, Lq - 1) + q_offset;
  const int wk_last = causal ? min(Lk - 1, wq_hi) : Lk - 1;
  const int wk_first = window > 0 ? max(0, wq_lo - window + 1) : 0;

  zero_pad<kBQ>(Qs, QS, D, DQ);
  zero_pad<kBK>(Ks, QS, D, DQ);
  zero_pad<kBK>(Vs, VS, Dv, DMAX);
  // Q tile (with the first K tile: one cp.async group), then the first V
  load_tile<kBQ, T, kAsync>(Qs, QS, qg, r0, Lq, D, DQ);
  if (kt0 <= kt1) load_tile<kBK, T, kAsync>(Ks, QS, kg, kt0 * kBK, Lk, D, DQ);
  cp_async_commit();
  if (kt0 <= kt1)
    load_tile<kBK, T, kAsync>(Vs, VS, vg, kt0 * kBK, Lk, Dv, DMAX);
  cp_async_commit();

  // C fragments: acc[n][0..1] row g, columns 8n + 2t (+1); [2..3] row g + 8
  float acc[NT][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's
#pragma unroll                                          // columns only
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const float* qa = Qs + (warp * 16 + g) * QS + 2 * t;
  const float* kb = Ks + g * QS + 2 * t;
  const float* vb = Vs + 2 * t * VS + g;
  // logit = softcap tanh(s / sqrt(D) / softcap): one multiply before tanhf
  const float pre = softcap != 0.f ? scale / softcap : scale;
  PHASE_INIT();

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k_lo = kt * kBK;
    const bool active = w_rows && k_lo <= wk_last && k_lo + kBK > wk_first;
    // an interior tile: every key live for every row of the warp
    const bool edge = k_lo + kBK > Lk ||
                      (causal && k_lo + kBK - 1 > wq_lo) ||
                      (window > 0 && wq_hi - k_lo >= window);
    cp_async_wait_all_but_one();             // Q and this K tile are in
    __syncthreads();
    PHASE(0);

    // s[j]: logits of rows g, g + 8 and keys k_lo + 8j + 2t (+1).  The
    // k-step reads columns d0 + 2t (+1) as its k = t (t + 4).  The two
    // correction products go to c, apart from big . big: the MMA truncates
    // its sums, and a short chain of small terms truncates less.
    float s[NJ][4];
    float alpha[2] = {1.f, 1.f};
    if (active) {
      float c[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = c[j][e] = 0.f;
#pragma unroll 2
      for (int d0 = 0; d0 < DQ; d0 += 8) {
        const float2 x0 = *reinterpret_cast<const float2*>(qa + d0);
        const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * QS + d0);
        uint32_t ab[4], as[4];
        split<kWide>(x0.x, ab[0], as[0]);
        split<kWide>(x1.x, ab[1], as[1]);
        split<kWide>(x0.y, ab[2], as[2]);
        split<kWide>(x1.y, ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 y =
              *reinterpret_cast<const float2*>(kb + 8 * j * QS + d0);
          uint32_t bb0, bs0, bb1, bs1;
          split<kWide>(y.x, bb0, bs0);
          split<kWide>(y.y, bb1, bs1);
          if constexpr (kWide) {
            mma(c[j], as, bb0, bb1);
            mma(c[j], ab, bs0, bs1);
          }
          mma(s[j], ab, bb0, bb1);
        }
      }
      PHASE(1);

      // mask, online softmax; a row's 32 keys sit on the 4 lanes of a
      // quad (t = 0..3), 8 each
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = wq_lo + g + 8 * i;
        bool live[2 * NJ];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bool ok = true;
            if (edge) {
              const int kpos = k_lo + 8 * j + 2 * t + e;
              ok = kpos < Lk;
              if (causal) ok = ok && qpos >= kpos;
              if (window > 0) ok = ok && qpos - kpos < window;
            }
            live[2 * j + e] = ok;
            float x = (s[j][2 * i + e] + c[j][2 * i + e]) * pre;
            if (softcap != 0.f) x = softcap * tanhf(x);
            s[j][2 * i + e] = ok ? x : kNegInf;
            mx = fmaxf(mx, s[j][2 * i + e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p =
                live[2 * j + e] ? expf(s[j][2 * i + e] - m_new) : 0.f;
            s[j][2 * i + e] = p;
            sum += p;
          }
        alpha[i] = expf(m[i] - m_new);
        l[i] = alpha[i] * l[i] + sum;
        m[i] = m_new;
      }
    }

    PHASE(2);
    cp_async_wait_all();                     // this V tile is in
    __syncthreads();                         // and the K tile consumed
    if (kt < kt1)
      load_tile<kBK, T, kAsync>(Ks, QS, kg, (kt + 1) * kBK, Lk, D, DQ);
    cp_async_commit();
    PHASE(3);

    if (active) {
      // acc = acc * alpha + P V.  k-step j reads P's keys 8j + 2t (+1), the
      // C fragment s[j] as it is, as its k = t (t + 4), and V's rows alike.
      uint32_t pb[NJ][4], ps[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        split<true>(s[j][0], pb[j][0], ps[j][0]);
        split<true>(s[j][2], pb[j][1], ps[j][1]);
        split<true>(s[j][1], pb[j][2], ps[j][2]);
        split<true>(s[j][3], pb[j][3], ps[j][3]);
      }
      // 64 columns at a time into a zeroed accumulator (eight independent
      // MMA chains of 12), then one f32 FMA into acc: the MMA's truncated
      // sums never run over the whole key loop
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += 8) {
        float pv[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float* vj = vb + 8 * j * VS + 8 * n0;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            uint32_t bb0, bs0, bb1, bs1;
            split<kWide>(vj[8 * n], bb0, bs0);
            split<kWide>(vj[VS + 8 * n], bb1, bs1);
            mma(pv[n], ps[j], bb0, bb1);
            if constexpr (kWide) mma(pv[n], pb[j], bs0, bs1);
            mma(pv[n], pb[j], bb0, bb1);
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n0 + n][e] = fmaf(acc[n0 + n][e], alpha[e / 2], pv[n][e]);
      }
    }
    PHASE(4);
    __syncthreads();                         // V tile consumed
    PHASE(5);

    if (kt < kt1)
      load_tile<kBK, T, kAsync>(Vs, VS, vg, (kt + 1) * kBK, Lk, Dv, DMAX);
    cp_async_commit();
  }
  cp_async_wait_all();                       // no copy outlives the CTA
  PHASE_FLUSH();

  // finalize: a row with no live key (l == 0) gives 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = wr + g + 8 * i;
    if (r >= Lq) continue;
    const float inv = li == 0.f ? 1.f : li;
    T* orow = o + ((size_t)bh * Lq + r) * Dv;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < Dv) store(orow + d, acc[n][2 * i + e] / inv);
      }
  }
}

template <int DMAX>
size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)(kBQ + kBK) * qk_stride(D) + (size_t)kBK * kVS<DMAX>);
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
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Lq, Lk, D, Dv,
      causal, window, softcap, 1.0f / sqrtf((float)D), q_offset);
  return (int)cudaGetLastError();
}

// DMAX bounds Dv (the accumulator's registers); D only sizes shared memory
template <typename T, bool kAsync>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Lq, int Lk, int D, int Dv, int causal,
             int window, float softcap, int q_offset, cudaStream_t stream) {
  if (Dv <= 64)
    return launch<T, 64, kAsync>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, Dv,
                                 causal, window, softcap, q_offset, stream);
  if (Dv <= 128)
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

#ifdef FLASH_PHASE_CLOCKS
// the phase clocks: zero them, or copy the seven sums to `host`
extern "C" int flash_phase_reset() {
  const unsigned long long zero[7] = {};
  return (int)cudaMemcpyToSymbol(flash_phase_cycles, zero, sizeof(zero));
}
extern "C" int flash_phase_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, flash_phase_cycles,
                                   7 * sizeof(unsigned long long));
}
#endif
