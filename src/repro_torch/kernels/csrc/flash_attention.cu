// Flash attention for Hopper (sm_90a).
//
// Replaces flash_attention (_flash_kernel) of
// src/repro/kernels/flash_attention.py: online-softmax attention with
// causal and sliding-window masks aligned at the ends of the query and key
// sequences (query i sits at key position i + Skv - Sq), GQA head grouping
// (query head h reads KV head h / (H / Hkv)), float32 softmax and
// accumulation, the output in q's dtype.
//
// Layout.  Both kernels read the model layout directly: q and out are
// (B, Sq, H, D), k and v (B, Skv, Hkv, D), each contiguous, all four of
// one dtype.  The TPU wrapper transposes to (B, H, S, D) and pads S to the
// block; here no copy is made: every row of a tile is D contiguous
// elements, and rows past Sq or Skv are masked in the kernel.  Keys at
// index >= Skv are masked explicitly, so causal=False on a ragged Skv is
// exact (the TPU wrapper's zero-padded keys enter its softmax there).  A
// query row that sees no key comes out 0.
//
// Bound on the card: at qwen3-1.7b's prefill (B = 4, S = 2048, H = 16,
// Hkv = 8, D = 128, causal) a call must move 0.10 GB in bf16 (0.030 ms at
// 3.35 TB/s) and do 4 D flops for each of the B H S (S + 1) / 2 visible
// (query, key) pairs, 0.069 TFLOP (0.070 ms at the bf16 tensor-core peak
// of 989 TFLOP/s): it is bound by operations, on the tensor cores.
//
// bfloat16: flash_mma_kernel, on the tensor cores (FlashAttention-2's
// shape).  One block of 4 warps takes one (q-tile of 64 rows, head,
// batch), 16 query rows a warp (64-row blocks measured 5 % faster than
// 128-row ones of 8 warps at qwen3's prefill); the q-tiles are launched
// heaviest first (reversed index, the q-tile the
// slowest grid coordinate), which balances the causal work.  Q is
// copied to shared memory once and, for D <= 128, its fragments held in
// registers for the whole loop.  K and V stream through shared memory in
// tiles of 64 keys with 16-byte cp.async, two stages each, K one tile
// ahead of V: one barrier a tile publishes K(kt + 1) and V(kt) and frees
// the stages that the copies of K(kt + 2) and V(kt + 1), in flight during
// the tile's products, refill.  Each warp is software-pipelined: it
// issues S(kt + 1) = Q K(kt + 1)^T before tile kt's softmax and P V(kt),
// in one branch-free run, so its exp2 and shuffles execute while its
// tensor-core products are in flight.  Rows are
// padded by 8 bf16 (16 bytes), so the 8 row addresses of an ldmatrix fall
// in 8 different bank groups.  S = Q K^T is mma.sync m16n8k16 (bf16 in,
// f32 accumulate) on ldmatrix fragments; the online softmax runs on the
// accumulator fragments in f32 (a row's max and sum over the 4 lanes of a
// quad, ex2.approx on scores scaled by scale * log2 e).  P is rounded to bf16
// in registers, where the S accumulator layout is already the A operand
// layout of O += P V; V's B fragments come from ldmatrix.trans, so P never
// goes to shared memory.  Rounding P to bf16 is a deviation from the
// Pallas kernel, which keeps P in f32; the error stays within the bf16
// tolerance (2e-2) of tests/test_kernels.py.  The causal, window and
// key >= Skv masks are applied only on a tile that needs them (the
// diagonal, the window's edge, the ragged last tile), judged per warp,
// and tiles wholly masked for the block are never loaded.  A masked
// score is -inf,
// and while a row has seen no key its max is -inf and exp2 is taken
// against 0, so p = 0 where masked and a row that sees no key is 0.  The
// tile width is the instantiation's DMAX (64, 128 or 256), a constant, so
// the products' loops unroll into one straight run that ptxas can
// schedule (ldmatrix ahead of the mma that waits on it); columns D..DMAX
// are zero-filled in shared memory, so any D <= 256 works (zamba2's 112
// pays one zero k-step of 16).  16-byte copies need every row and base
// 16-byte aligned (D a multiple of 8); otherwise the same kernel copies
// element by element, synchronously.  The output goes through the
// warp's own rows of the Q tile, so it is written in 16-byte stores.
//
// float32: flash_kernel, on the CUDA cores (the first port, kept for the
// f32 parity checks, within 2e-5 of the plain version).  One block of
// 256 threads owns one (q-tile of 64 rows, head, batch).  It keeps its Q
// tile, scaled, in shared memory and streams the K and V tiles (64 keys)
// through shared memory; the running max m, sum l and the 64 x D
// accumulator stay in registers, float32.  The threads are a 16 x 16
// grid: thread (ty, tx) owns query rows ty + 16 i (i < 4), key columns
// tx + 16 j (j < 4) of each score tile and head-dim columns tx + 16 jd of
// the accumulator, so a row's max and sum are reduced over the 16 lanes
// of one half-warp with shuffles, and the row rescale by
// alpha = exp(m_old - m_new) stays in the thread.  Probabilities of
// masked entries are set to 0 (a row whose first visible key tile comes
// late still has m = -1e30 there, where exp(s - m) = 1).  KV tiles wholly
// above the causal diagonal, or wholly before the window of every row of
// the q-tile, are skipped.  Products are float32 FMAs (float4 shared-
// memory reads along D).  Shared memory is (64 + 2 * 64) * (D4 + 4) +
// 64 * 68 floats, D4 = D rounded up to 4: 116 KB at D = 128, so it is
// dynamic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kR = kBQ / 16;   // query rows per thread
constexpr int kC = kBK / 16;   // key columns per thread
constexpr int kLdP = kBK + 4;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

__device__ __forceinline__ int padded_d(int D) { return (D + 3) & ~3; }

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int Hkv, int D, int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kJD = DMAX / 16;  // accumulator columns per thread
  const int DP = padded_d(D), ld = DP + 4;
  float* Qs = smem;              // kBQ x ld, scaled
  float* Ks = Qs + kBQ * ld;     // kBK x ld
  float* Vs = Ks + kBK * ld;     // kBK x ld
  float* Ps = Vs + kBK * ld;     // kBQ x kLdP

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int offset = Skv - Sq;   // aligned ends
  const size_t q_row = (size_t)H * D, kv_row = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * Skv * kv_row + (size_t)hk * D;
  T* ob = out + (size_t)b * Sq * q_row + (size_t)h * D;

  for (int e = tid; e < kBQ * DP; e += kThreads) {
    const int r = e / DP, d = e - r * DP;
    Qs[r * ld + d] = (q0 + r < Sq && d < D)
                         ? to_f32(qb[(size_t)(q0 + r) * q_row + d]) * scale
                         : 0.f;
  }

  // the key tiles any row of this q-tile can see
  const int qp_lo = q0 + offset;
  const int qp_hi = min(q0 + kBQ, Sq) - 1 + offset;
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, qp_hi < 0 ? 0 : qp_hi / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && qp_lo - window + 1 > 0)
    kt_begin = (qp_lo - window + 1) / kBK;

  float m[kR], l[kR], acc[kR][kJD];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < kJD; ++jd) acc[i][jd] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // Q is stored; the last tile's K, V, P are read
    for (int e = tid; e < kBK * DP; e += kThreads) {
      const int r = e / DP, d = e - r * DP;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Skv && d < D) {
        const size_t off = (size_t)(k0 + r) * kv_row + d;
        kv = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      Ks[r * ld + d] = kv;
      Vs[r * ld + d] = vv;
    }
    __syncthreads();

    // scores s = (scale q) k^T for this thread's 4 x 4 entries
    float s[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 qv[kR], kv[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * ld + d]);
#pragma unroll
      for (int j = 0; j < kC; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * ld + d]);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax, P to shared memory, rescale the accumulator
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qp = q0 + ty + 16 * i + offset;
      bool ok[kC];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < Skv && (!causal || kp <= qp) &&
                (window <= 0 || qp - kp < window);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        rowsum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, o);
      l[i] = l[i] * alpha + rowsum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < kJD; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();

    // acc += P V
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kLdP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * ld;
#pragma unroll
        for (int jd = 0; jd < kJD; ++jd) {
          const int d = tx + 16 * jd;
          if (d < D) {
            const float vval = vrow[d];
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              const float p = cc == 0 ? pv[i].x
                            : cc == 1 ? pv[i].y
                            : cc == 2 ? pv[i].z : pv[i].w;
              acc[i][jd] = fmaf(p, vval, acc[i][jd]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < kJD; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) ob[(size_t)r * q_row + d] = from_f32<T>(acc[i][jd] / denom);
    }
  }
}

size_t smem_bytes(int D) {
  const int ld = ((D + 3) & ~3) + 4;
  return ((size_t)(kBQ + 2 * kBK) * ld + (size_t)kBQ * kLdP) * sizeof(float);
}

template <typename T, int DMAX>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Skv, int H, int Hkv, int D, int causal,
                int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_kernel<T, DMAX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Hkv, D,
      causal, window, scale);
  return cudaGetLastError();
}


// ------------------------------------------------ bfloat16, tensor cores

namespace tc {

using namespace sm90;  // the PTX wrappers of mma_sm90.cuh
constexpr int kWarps = 4;            // 16 query rows a warp
constexpr int kBQ = 16 * kWarps;     // query rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;              // keys per tile
constexpr int kPad = 8;              // bf16 of padding a shared-memory row

// kRows x DMAX bf16 of a tile into shared memory (row stride DMAX +
// kPad), from rows of D elements src_stride apart; rows >= valid and
// columns >= D are 0.  With vec, 16-byte cp.async: each of the kThreads
// threads copies one fixed 16-byte column of every (kThreads / chunks)-th
// row, unrolled; otherwise element by element, synchronously.
template <int kRows, int DMAX>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t src_stride, int valid,
                                          int D, bool vec) {
  constexpr int ld = DMAX + kPad, cpr = DMAX / 8;  // 16-byte chunks a row
  static_assert(kThreads % cpr == 0 && kRows * cpr % kThreads == 0,
                "a thread's chunks are one column of evenly spaced rows");
  if (vec) {
    constexpr int kStep = kThreads / cpr;
    const int c = threadIdx.x % cpr, r0 = threadIdx.x / cpr;
    const bool col_ok = c < D / 8;
#pragma unroll
    for (int i = 0; i < kRows / kStep; ++i) {
      const int r = r0 + i * kStep;
      const bool ok = col_ok && r < valid;
      cp_async16(dst + r * ld + c * 8,
                 ok ? src + (size_t)r * src_stride + c * 8 : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * DMAX; e += kThreads) {
      const int r = e / DMAX, c = e % DMAX;
      dst[r * ld + c] = (r < valid && c < D)
                            ? src[(size_t)r * src_stride + c]
                            : __float2bfloat16(0.f);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                 int Skv, int H, int Hkv, int D, int causal, int window,
                 float scale_log2, int n_qtiles, int vec) {
  constexpr int kKS = DMAX / 16;          // k-steps of Q K^T over D
  constexpr bool kQRegs = DMAX <= 128;    // Q's fragments in registers
  constexpr int ld = DMAX + kPad;         // shared-memory row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // kBQ x ld
  bf16* Ks = Qs + kBQ * ld;                        // 2 x kBK x ld
  bf16* Vs = Ks + 2 * kBK * ld;                    // 2 x kBK x ld

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;   // quad row, lane in quad
  const int HB = gridDim.x / n_qtiles;
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / HB);
  const int hb = blockIdx.x - (n_qtiles - 1 - qt) * HB;
  const int h = hb % H, b = hb / H, hk = h / (H / Hkv);
  const int q0 = qt * kBQ, offset = Skv - Sq;  // aligned ends
  const size_t q_row = (size_t)H * D, kv_row = (size_t)Hkv * D;
  const bf16* qb = q + ((size_t)b * Sq + q0) * q_row + (size_t)h * D;
  const bf16* kb = k + (size_t)b * Skv * kv_row + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * Skv * kv_row + (size_t)hk * D;
  bf16* ob = out + ((size_t)b * Sq + q0) * q_row + (size_t)h * D;

  // the key tiles any row of this q-tile can see
  const int qp_lo = q0 + offset;
  const int qp_hi = min(q0 + kBQ, Sq) - 1 + offset;
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, qp_hi < 0 ? 0 : qp_hi / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && qp_lo - window + 1 > 0)
    kt_begin = (qp_lo - window + 1) / kBK;

  // K or V tile kt into its stage (kt & 1) of a two-tile ring
  const auto load_kv = [&](bf16* ring, const bf16* src, int kt) {
    const int k0 = kt * kBK;
    load_tile<kBK, DMAX>(ring + (kt & 1) * kBK * ld,
                                   src + (size_t)k0 * kv_row, kv_row,
                                   min(kBK, Skv - k0), D, vec);
  };
  // K runs one tile ahead of V: the copy groups are {Q}, {K(b)},
  // {K(b + 1), V(b)}, then one {K(kt + 2), V(kt + 1)} an iteration
  load_tile<kBQ, DMAX>(Qs, qb, q_row, min(kBQ, Sq - q0), D, vec);
  cp_async_commit();
  if (kt_begin < kt_end) load_kv(Ks, kb, kt_begin);
  cp_async_commit();
  if (kt_begin + 1 < kt_end) load_kv(Ks, kb, kt_begin + 1);
  if (kt_begin < kt_end) load_kv(Vs, vb, kt_begin);
  cp_async_commit();
  cp_async_wait<1>();  // Q and the first K tile have landed
  __syncthreads();

  const bf16* Qw = Qs + warp * 16 * ld;   // this warp's 16 rows
  uint32_t qf[kQRegs ? kKS : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
      ldmatrix_x4(qf[kk], Qw + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
  }
  // key positions of this warp's first and last rows, and of this
  // thread's two rows (quad row g and g + 8)
  const int qw_lo = q0 + warp * 16 + offset, qw_hi = qw_lo + 15;
  const int qp[2] = {qw_lo + g, qw_lo + g + 8};

  // s = Q K^T for key tile kt, scaled into log2 units: 8 n-tiles of 8
  // keys, 4 accumulators a thread each
  const auto scores = [&](float (&s)[8][4], int kt) {
    const bf16* Kt = Ks + (kt & 1) * kBK * ld;
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] = qf[kk][x];
      } else {
        ldmatrix_x4(a, Qw + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];  // keys 16 np.., d 16 kk..: two n-tiles
        ldmatrix_x4(bk, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld
                            + kk * 16 + ((lane >> 3) & 1) * 8);
        mma(s[2 * np], a, bk[0], bk[1]);
        mma(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] *= scale_log2;
  };
  // -inf where the causal, window or key >= Skv mask hides a key, on a
  // tile that needs it (the diagonal, the window's edge, the ragged end)
  const auto mask = [&](float (&s)[8][4], int kt) {
    const int k0 = kt * kBK;
    const bool need_mask = k0 + kBK > Skv ||
                           (causal && k0 + kBK - 1 > qw_lo) ||
                           (window > 0 && qw_hi - k0 >= window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kp = k0 + 8 * j + 2 * tig + (c & 1);
          const int qpos = qp[c >> 1];
          const bool ok = kp < Skv && (!causal || kp <= qpos) &&
                          (window <= 0 || qpos - kp < window);
          if (!ok) s[j][c] = -INFINITY;
        }
    }
  };

  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // the online softmax of s on the fragments (rows g: c = 0, 1; g + 8:
  // c = 2, 3), then O = alpha O + P V for V tile kt, P's A fragments
  // straight from the accumulators
  const auto softmax_pv = [&](float (&s)[8][4], int kt) {
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      alpha[rr] = fast_exp2(m[rr] - base);
      m[rr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * rr] = fast_exp2(s[j][2 * rr] - base);
        s[j][2 * rr + 1] = fast_exp2(s[j][2 * rr + 1] - base);
        sum += s[j][2 * rr] + s[j][2 * rr + 1];
      }
      l[rr] = l[rr] * alpha[rr] + sum;  // this lane's part of the sum
    }
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    const bf16* Vt = Vs + (kt & 1) * kBK * ld;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kKS; ++dp) {
        uint32_t bv[4];  // keys 16 ks.., d 16 dp..: two n-tiles
        ldmatrix_x4_trans(bv, Vt + (ks * 16 + (lane & 7) +
                                    (((lane >> 3) & 1) << 3)) * ld
                                  + dp * 16 + (lane >> 4) * 8);
        mma(o[2 * dp], pa, bv[0], bv[1]);
        mma(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  };

  // Each iteration: one barrier, which publishes K(kt + 1) and V(kt) and
  // frees the stages of K(kt) and V(kt - 1) for the next copies; then
  // S(kt + 1) = Q K(kt + 1)^T is issued before tile kt's softmax and
  // P V(kt), with no branch between them (S(kt + 1) is masked after), so
  // the warp's exp2 and shuffles run while its products are in flight.
  float s[8][4], s_next[8][4];
  if (kt_begin < kt_end) {
    scores(s, kt_begin);
    mask(s, kt_begin);
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    cp_async_wait<0>();  // this thread's copies of K(kt + 1), V(kt)
    __syncthreads();
    if (kt + 2 < kt_end) load_kv(Ks, kb, kt + 2);
    if (kt + 1 < kt_end) load_kv(Vs, vb, kt + 1);
    cp_async_commit();
    if (kt + 1 < kt_end) {
      scores(s_next, kt + 1);
      softmax_pv(s, kt);
      mask(s_next, kt + 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = s_next[j][c];
    } else {
      softmax_pv(s, kt);
    }
  }

  // normalise; through this warp's rows of the Q tile to 16-byte stores
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[rr] = sum > 0.f ? 1.f / sum : 0.f;
  }
  bf16* Ow = Qs + warp * 16 * ld;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    *reinterpret_cast<uint32_t*>(Ow + g * ld + col) =
        pack_bf16(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * ld + col) =
        pack_bf16(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  const int rows = min(16, Sq - q0 - warp * 16);
  bf16* og = ob + (size_t)warp * 16 * q_row;
  if (vec) {
    const int cpr = D / 8;
    for (int e = lane; e < rows * cpr; e += 32) {
      const int r = e / cpr, c = e - r * cpr;
      *reinterpret_cast<uint4*>(og + (size_t)r * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * ld + c * 8);
    }
  } else {
    for (int e = lane; e < rows * D; e += 32) {
      const int r = e / D, c = e - r * D;
      og[(size_t)r * q_row + c] = Ow[r * ld + c];
    }
  }
}

template <int DMAX>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Skv, int H, int Hkv, int D, int causal,
                int window, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(kBQ + 4 * kBK) * (DMAX + kPad) * sizeof(bf16);
  auto kernel = flash_mma_kernel<DMAX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = D % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                  aligned(out);
  const int n_qtiles = (Sq + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qtiles * H * B;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, H, Hkv,
      D, causal, window, scale * 1.4426950408889634f, n_qtiles, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Skv, int H, int Hkv,
                       int D, int causal, int window, float scale,
                       cudaStream_t s) {
  if (D <= 64)
    return run<64>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal,
                           window, scale, s);
  if (D <= 128)
    return run<128>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal,
                            window, scale, s);
  if (D <= 256)
    return run<256>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal,
                            window, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace tc

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Skv, int H, int Hkv,
                         int D, int causal, int window, float scale,
                         cudaStream_t s) {
  if (D <= 64)
    return run<float, 64>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal,
                          window, scale, s);
  if (D <= 128)
    return run<float, 128>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal,
                           window, scale, s);
  if (D <= 256)
    return run<float, 256>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal,
                           window, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, out: (B, Sq, H, D); k, v: (B, Skv, Hkv, D); contiguous, one dtype:
// 0 = float32 (flash_kernel), 1 = bfloat16 (the tensor-core
// flash_mma_kernel).  H a multiple of Hkv; D <= 256; window <= 0 means none.  Returns cudaGetLastError() after
// the launch (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Skv, int H, int Hkv,
                        int D, int causal, int window, float scale, int dtype,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal,
                             window, scale, s);
  if (dtype == 1)
    return (int)tc::dispatch_d(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal,
                               window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
