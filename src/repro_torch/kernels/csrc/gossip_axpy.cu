// Consensus mixing kernels for Hopper (sm_90a).
//
// 1. mix_rows replaces mix_rows (_mix_kernel) of
// src/repro/kernels/gossip_axpy.py:
// out[g, m] = sum_h W[g, h] * Z[h, m] over the node axis, with W the
// precomputed W^{T_con} (L x L, float32) and Z (L, M) in float32 or
// bfloat16.  Accumulation is f32; out is written in Z's dtype.  Every
// output is summed over h in ascending order, one fmaf a term, from 0.
//
// Bound on the card: at Experiment 1 (L = 20, M = d*r = 2400, f32) the
// kernel must move 0.39 MB (0.000115 ms at 3.35 TB/s), so a launch is
// bound by its latency: the launch itself and each dependent trip to
// memory.  The first port walked h in a loop of L dependent loads a
// thread, on 57 blocks, and took 0.0038 ms (chip_smoke.py, NVIDIA H100
// 80GB HBM3 at its 700 W limit).
//
// Design.  mix_tile_kernel makes one trip to memory: a CTA owns
// kTileCols columns and kTileRows output rows, and issues all of its
// loads -- its (L, kTileCols) tile of Z and its rows of W, with 16-byte
// cp.async where the rows are 16-byte aligned (4-byte or element by
// element otherwise) -- before it waits once.  Each thread then forms
// four neighbouring outputs of a row from shared memory.  At Experiment 1
// (L = 20) that is 150 CTAs, more than the 132 SMs, and each Z element is
// read once; at L = 100, four row blocks of 63 column tiles.  Where the
// tile and the rows of W do not fit kTileSmemMax (L past about 500),
// mix_rows_kernel keeps the first port's h-tiled loop (W staged in
// (kRows, kH) tiles, kRows outputs a thread), its loads unrolled kUnrollH
// at a time so that they are in flight together.  The C entry reports
// which of the two it launched.
//
// 2. gossip_combine replaces gossip_combine (_combine_kernel) of
// src/repro/kernels/gossip_axpy.py: one mesh gossip round's (K+1)-way
// combine out = w[0]*z + sum_k w[k+1]*nbr[k], elementwise over a flat z
// of n elements and K stacked neighbour rows (nbr is K x n), in float32
// or bfloat16, with float32 weights and accumulation and out in z's
// dtype.
//
// Bound on the card: the round must move (K+2)*n*itemsize bytes plus the
// weights; at the mesh shape (n = d*r = 2400, K = 19, f32) that is
// 0.20 MB, 0.00006 ms at 3.35 TB/s, so a launch is bound by its latency:
// the launch itself and each dependent trip to memory.  The first port
// (one element a thread, walking the K rows in a loop of run-time length,
// so each load waited for the one before: about K+1 memory latencies a
// thread, on 10 blocks of 256 threads at n = 2400) took 0.0035 ms there
// (chip_smoke.py, NVIDIA H100 80GB HBM3 at its 700 W limit).
//
// Design.  combine_tile_kernel makes one trip to memory, as
// mix_tile_kernel does: a CTA of kCombThreads threads owns kCombTile
// elements (38 CTAs at the mesh round's n = 2400) and issues every load
// of its (K+1) x kCombTile block -- z, the K neighbour rows, and the K+1
// weights -- into shared memory before it waits once, each thread two or
// fewer copies at K = 19: 16-byte cp.async where n * itemsize is a
// multiple of 16 and z and nbr are 16-byte aligned, 4-byte cp.async
// (f32) or element by element (bf16) otherwise, since a ragged n leaves
// rows k >= 1 misaligned.  Thread t < kCombTile then sums element t over
// the rows in ascending order with __fmul_rn / __fadd_rn (no FMA
// contraction), from -0.0f, so the first term is w0 * z exactly: the
// plain version's arithmetic, and the kernel equals ref_gossip_combine
// bit for bit.  Where the K+1 rows pass kStageRows (a complete graph at
// large L), they are staged kStageRows at a time, double-buffered: the
// next group's loads fly while the current group is summed, in the same
// order.  A ring (K = 2, the roll form's n = 48000 too) needs no shared
// memory: where K+1 <= kRegRows, combine_regs_kernel gives each thread
// one element, its K+1 values and weights loaded into registers together
// before the first is used, and sums them in the same order.  The
// weights come from a (K+1,) float32 device pointer, so a device's own
// row of a W table never has to come back to the host.  The C entry
// reports which form it launched.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;  // mix_rows_kernel: threads a block, a column each
constexpr int kRows = 8;    // output rows a block
constexpr int kH = 32;      // h-tile of W staged in shared memory
constexpr int kUnrollH = 8; // Z loads in flight a thread

constexpr int kTileCols = 16;     // mix_tile_kernel: columns a CTA
constexpr int kTileThreads = 128;
constexpr int kQuads = kTileCols / 4;             // four columns a thread
constexpr int kTileRows = kTileThreads / kQuads;  // output rows a CTA
constexpr size_t kTileSmemMax = 96 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}

// One element of the tile into shared memory without waiting on it where
// the type allows (4 bytes), else through a register.
__device__ __forceinline__ void stage(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src) {
  *dst = *src;
}

// four neighbouring values of a tile row as f32, and four outputs stored
__device__ __forceinline__ float4 quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 quad(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store_quad(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_quad(__nv_bfloat16* p,
                                           const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&lo);
  q.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

// W's row stride in shared memory: L rounded up to an odd number of
// quads, so the eight rows a warp reads at once fall in distinct banks
// and a row starts 16-byte aligned.
__host__ __device__ inline int tile_w_stride(int L) {
  return 4 * (((L + 3) / 4) | 1);
}
template <typename T>
__host__ __device__ size_t tile_zs_bytes(int L) {
  return ((size_t)L * kTileCols * sizeof(T) + 15) & ~(size_t)15;
}
template <typename T>
size_t tile_smem_bytes(int L) {
  const int rows = L < kTileRows ? L : kTileRows;
  return tile_zs_bytes<T>(L) + sizeof(float) * (size_t)rows * tile_w_stride(L);
}

// A CTA owns kTileCols columns of Z and kTileRows output rows: its tile of
// Z (L rows) and its rows of W in shared memory, one output quad a
// thread.  vec: Z's rows are 16-byte aligned (Z aligned, M * sizeof(T) a
// multiple of 16), so a CTA's columns are whole 16-byte pieces of each
// row and the outputs go out four at a time; wvec: W's rows likewise
// (L a multiple of 4).
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
mix_tile_kernel(const float* __restrict__ W, const T* __restrict__ Z,
                T* __restrict__ out, int L, int M, int vec, int wvec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);                 // L x kTileCols
  float* ws = reinterpret_cast<float*>(smem_raw + tile_zs_bytes<T>(L));
  const int m0 = blockIdx.x * kTileCols, g0 = blockIdx.y * kTileRows;
  const int mn = min(kTileCols, M - m0), gn = min(kTileRows, L - g0);
  const int Ls = tile_w_stride(L);
  const T* z = Z + m0;
  const float* w = W + (size_t)g0 * L;

  // every load issued, then one wait
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int cpr = mn / kPer;   // mn is a multiple of kPer
    for (int e = threadIdx.x; e < L * cpr; e += kTileThreads) {
      const int h = e / cpr, c = e - h * cpr;
      cp_async16(zs + h * kTileCols + c * kPer, z + (size_t)h * M + c * kPer);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < L * kTileCols; e += kTileThreads) {
      const int h = e / kTileCols, c = e - h * kTileCols;
      if (c < mn) stage(zs + e, z + (size_t)h * M + c);
    }
  }
  if (wvec) {
    const int qpr = L / 4;
    for (int e = threadIdx.x; e < gn * qpr; e += kTileThreads) {
      const int gg = e / qpr, qq = e - gg * qpr;
      cp_async16(ws + gg * Ls + 4 * qq, w + (size_t)gg * L + 4 * qq);
    }
  } else {
    for (int e = threadIdx.x; e < gn * L; e += kTileThreads) {
      const int gg = e / L, h = e - gg * L;
      cp_async4(ws + gg * Ls + h, w + e);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
  __syncthreads();

  const int q = threadIdx.x % kQuads, c0 = q * 4, gg = threadIdx.x / kQuads;
  if (c0 >= mn || gg >= gn) return;
  const float* wg = ws + gg * Ls;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec || c0 + 4 <= mn) {   // a whole quad of the tile
#pragma unroll 4
    for (int h = 0; h < L; ++h) {
      const float wv = wg[h];
      const float4 v = quad(zs + h * kTileCols + c0);
      acc[0] = fmaf(wv, v.x, acc[0]);
      acc[1] = fmaf(wv, v.y, acc[1]);
      acc[2] = fmaf(wv, v.z, acc[2]);
      acc[3] = fmaf(wv, v.w, acc[3]);
    }
  } else {
    for (int h = 0; h < L; ++h) {
      const float wv = wg[h];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + e < mn)
          acc[e] = fmaf(wv, to_f32(zs[h * kTileCols + c0 + e]), acc[e]);
    }
  }
  T* o = out + (size_t)(g0 + gg) * M + m0 + c0;
  if (vec) {
    store_quad(o, acc);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < mn) o[e] = from_f32<T>(acc[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kCols)
mix_rows_kernel(const float* __restrict__ W, const T* __restrict__ Z,
                T* __restrict__ out, int L, int M) {
  __shared__ float Ws[kRows][kH];
  const int m = blockIdx.x * kCols + threadIdx.x;
  const int g0 = blockIdx.y * kRows;
  float acc[kRows];
#pragma unroll
  for (int gg = 0; gg < kRows; ++gg) acc[gg] = 0.f;
  for (int h0 = 0; h0 < L; h0 += kH) {
    for (int e = threadIdx.x; e < kRows * kH; e += kCols) {
      const int gg = e / kH, hh = e % kH;
      const int g = g0 + gg, h = h0 + hh;
      Ws[gg][hh] = (g < L && h < L) ? W[(size_t)g * L + h] : 0.f;
    }
    __syncthreads();
    if (m < M) {
      const int hn = min(kH, L - h0);
      for (int hh = 0; hh < hn; hh += kUnrollH) {
        float z[kUnrollH];
#pragma unroll
        for (int u = 0; u < kUnrollH; ++u)
          z[u] = hh + u < hn ? to_f32(Z[(size_t)(h0 + hh + u) * M + m]) : 0.f;
#pragma unroll
        for (int u = 0; u < kUnrollH; ++u)
          if (hh + u < hn) {
#pragma unroll
            for (int gg = 0; gg < kRows; ++gg)
              acc[gg] = fmaf(Ws[gg][hh + u], z[u], acc[gg]);
          }
      }
    }
    __syncthreads();
  }
  if (m < M) {
#pragma unroll
    for (int gg = 0; gg < kRows; ++gg)
      if (g0 + gg < L) out[(size_t)(g0 + gg) * M + m] = from_f32<T>(acc[gg]);
  }
}

// The one-tile kernel where W and a tile fit kTileSmemMax, else the
// h-tiled one; launched[0] or launched[1] counts the one launched.
template <typename T>
cudaError_t run(const void* W, const void* Z, void* out, int L, int M,
                int* launched, cudaStream_t stream) {
  const float* w = static_cast<const float*>(W);
  const T* z = static_cast<const T*>(Z);
  T* o = static_cast<T*>(out);
  const size_t smem = tile_smem_bytes<T>(L);
  cudaError_t err;
  if (smem <= kTileSmemMax) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(mix_tile_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
    }
    const int vec = ((size_t)M * sizeof(T)) % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(Z) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    const int wvec = L % 4 == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
    const dim3 grid((M + kTileCols - 1) / kTileCols,
                    (L + kTileRows - 1) / kTileRows);
    mix_tile_kernel<T><<<grid, kTileThreads, smem, stream>>>(w, z, o, L, M,
                                                             vec, wvec);
  } else {
    const dim3 grid((M + kCols - 1) / kCols, (L + kRows - 1) / kRows);
    mix_rows_kernel<T><<<grid, kCols, 0, stream>>>(w, z, o, L, M);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[smem <= kTileSmemMax ? 0 : 1];
  return err;
}

constexpr int kCombThreads = 256;  // the combine kernels' threads a CTA
constexpr int kRegRows = 8;        // combine_regs_kernel: K+1 at most
constexpr int kCombTile = 64;      // combine_tile_kernel: elements a CTA
constexpr int kStageRows = 64;     // rows (z and the K neighbours) a stage

// Row j of the round's (K+1) x n block: z, then the K neighbour rows.
template <typename T>
__device__ __forceinline__ const T* combine_row(const T* z, const T* nbr,
                                                long long n, int j) {
  return j == 0 ? z : nbr + (size_t)(j - 1) * n;
}

// K+1 <= kRegRows: thread i loads its element of every row and every
// weight into registers (all the loads issued before the first is used),
// then sums them in ascending order.
template <typename T>
__global__ void __launch_bounds__(kCombThreads)
combine_regs_kernel(const T* __restrict__ z, const T* __restrict__ nbr,
                    const float* __restrict__ w, T* __restrict__ out,
                    long long n, int K) {
  const long long i = (long long)blockIdx.x * kCombThreads + threadIdx.x;
  if (i >= n) return;
  const int R = K + 1;
  float v[kRegRows], wv[kRegRows];
#pragma unroll
  for (int j = 0; j < kRegRows; ++j) {
    v[j] = j < R ? to_f32(__ldg(combine_row(z, nbr, n, j) + i)) : 0.f;
    wv[j] = j < R ? __ldg(w + j) : 0.f;
  }
  float acc = -0.0f;   // -0 + x is x for every x: the first term is w0*z
#pragma unroll
  for (int j = 0; j < kRegRows; ++j)
    if (j < R) acc = __fadd_rn(acc, __fmul_rn(wv[j], v[j]));
  out[i] = from_f32<T>(acc);
}

// Issue the loads of rows [j0, j0 + rows) of the tile at element i0 (mn
// elements) into buf (rows x kCombTile) and their weights into wbuf, as
// one cp.async group, without waiting for them.  The weights go first
// (the bf16 element-by-element copies pass through registers, so what
// follows them waits for them).  A thread owns one 16-byte piece (vec)
// or one element of a row, in every kCombThreads / (pieces a row)-th
// row, so its loads need no division and fly together.
template <typename T>
__device__ __forceinline__ void issue_rows(T* buf, float* wbuf, const T* z,
                                           const T* nbr, const float* w,
                                           long long n, long long i0, int mn,
                                           int j0, int rows, int vec) {
  for (int rr = threadIdx.x; rr < rows; rr += kCombThreads)
    cp_async4(wbuf + rr, w + j0 + rr);
  if (vec) {
    constexpr int kPer = 16 / sizeof(T), kPieces = kCombTile / kPer;
    constexpr int kRowStep = kCombThreads / kPieces;
    const int c = (threadIdx.x % kPieces) * kPer;   // mn: a multiple of kPer
    if (c < mn) {
#pragma unroll 4
      for (int rr = threadIdx.x / kPieces; rr < rows; rr += kRowStep)
        cp_async16(buf + rr * kCombTile + c,
                   combine_row(z, nbr, n, j0 + rr) + i0 + c);
    }
  } else {
    constexpr int kRowStep = kCombThreads / kCombTile;
    const int c = threadIdx.x % kCombTile;
    if (c < mn) {
#pragma unroll 4
      for (int rr = threadIdx.x / kCombTile; rr < rows; rr += kRowStep)
        stage(buf + rr * kCombTile + c,
              combine_row(z, nbr, n, j0 + rr) + i0 + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The shared memory of a launch: one stage of `stage` rows, or two.
template <typename T>
size_t combine_smem_bytes(int stage, int nbuf) {
  return (size_t)nbuf * stage * (kCombTile * sizeof(T) + sizeof(float));
}

// A CTA owns kCombTile elements: out = sum over rows j of w[j] * row_j,
// in ascending j, in groups of `stage` rows (kStaged), or all K+1 rows in
// one group (stage = K+1: the group loop folds away at compile time);
// thread t < kCombTile sums element t.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kCombThreads)
combine_tile_kernel(const T* __restrict__ z, const T* __restrict__ nbr,
                    const float* __restrict__ w, T* __restrict__ out,
                    long long n, int K, int stage, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = K + 1;
  const int groups = kStaged ? (R + stage - 1) / stage : 1;
  const int nbuf = kStaged ? 2 : 1;
  // buffer b (0 or 1): its rows at rows0 + b * row_step, their weights
  // at wsm + b * stage, after both (or the one) row buffers
  const size_t row_step = (size_t)stage * kCombTile;   // elements
  T* const rows0 = reinterpret_cast<T*>(smem_raw);
  float* const wsm = reinterpret_cast<float*>(rows0 + nbuf * row_step);
  const long long i0 = (long long)blockIdx.x * kCombTile;
  const int mn = (int)min((long long)kCombTile, n - i0);

  issue_rows(rows0, wsm, z, nbr, w, n, i0, mn, 0, min(stage, R), vec);
  float acc = -0.0f;   // -0 + x is x for every x: the first term is w0*z
  for (int g = 0; g < groups; ++g) {
    const int j0 = g * stage, rows = min(stage, R - j0);
    if (g + 1 < groups) {   // the next group's loads fly while this sums
      const int nb = (g + 1) & 1;
      issue_rows(rows0 + nb * row_step, wsm + nb * stage, z, nbr, w, n, i0,
                 mn, j0 + stage, min(stage, R - j0 - stage), vec);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < mn) {
      const T* b = rows0 + (g & 1) * row_step + threadIdx.x;
      const float* wb = wsm + (g & 1) * stage;
#pragma unroll 8
      for (int rr = 0; rr < rows; ++rr)
        acc = __fadd_rn(acc, __fmul_rn(wb[rr], to_f32(b[rr * kCombTile])));
    }
    if (g + 1 < groups) __syncthreads();   // buffer g & 1 takes group g + 2
  }
  if (threadIdx.x < mn) out[i0 + threadIdx.x] = from_f32<T>(acc);
}

// Registers where K+1 <= kRegRows; else the tile kernel, in one stage
// where the K+1 rows fit kStageRows, in stages of kStageRows
// double-buffered past that.  launched[0], [1] or [2] counts the form
// launched: the tile in one stage, in stages, or the registers.
template <typename T>
cudaError_t run_combine(const void* z, const void* nbr, const void* w,
                        void* out, long long n, int K, int* launched,
                        cudaStream_t stream) {
  const T* zt = static_cast<const T*>(z);
  const T* nt = static_cast<const T*>(nbr);
  const float* wt = static_cast<const float*>(w);
  T* ot = static_cast<T*>(out);
  const int R = K + 1;
  int form;
  if (R <= kRegRows) {
    form = 2;
    const long long blocks = (n + kCombThreads - 1) / kCombThreads;
    combine_regs_kernel<T><<<(unsigned)blocks, kCombThreads, 0, stream>>>(
        zt, nt, wt, ot, n, K);
  } else {
    const bool staged = R > kStageRows;
    form = staged ? 1 : 0;
    const int stage = staged ? kStageRows : R;
    const int vec = ((size_t)n * sizeof(T)) % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(z) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(nbr) & 15) == 0;
    const unsigned blocks = (unsigned)((n + kCombTile - 1) / kCombTile);
    const size_t smem = combine_smem_bytes<T>(stage, staged ? 2 : 1);
    if (staged)
      combine_tile_kernel<T, true><<<blocks, kCombThreads, smem, stream>>>(
          zt, nt, wt, ot, n, K, stage, vec);
    else
      combine_tile_kernel<T, false><<<blocks, kCombThreads, smem, stream>>>(
          zt, nt, wt, ot, n, K, stage, vec);
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[form];
  return err;
}

}  // namespace

extern "C" {

// dtype of Z and out: 0 = float32, 1 = bfloat16; W is float32.
// Returns cudaGetLastError() after the launch (0 = success), and adds 1
// to launched[0] where it launched mix_tile_kernel, to launched[1] where
// mix_rows_kernel (W and a tile past kTileSmemMax).
int gossip_mix_rows(const void* W, const void* Z, void* out, int L, int M,
                    int dtype, int device, void* stream, int* launched) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (launched == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(W, Z, out, L, M, launched, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(W, Z, out, L, M, launched, s);
  return (int)cudaErrorInvalidValue;
}

// z and out: n elements; nbr: K rows of n; w: K+1 float32 weights.
// dtype 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = success), and adds 1 to launched[0] where the K+1 rows ran
// in one shared-memory stage of combine_tile_kernel, to launched[1] where
// in stages of kStageRows, to launched[2] where in combine_regs_kernel's
// registers (K+1 <= kRegRows).
int gossip_combine(const void* z, const void* nbr, const void* w, void* out,
                   long long n, int K, int dtype, int device, void* stream,
                   int* launched) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (launched == nullptr || K < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_combine<float>(z, nbr, w, out, n, K, launched, s);
  if (dtype == 1)
    return (int)run_combine<__nv_bfloat16>(z, nbr, w, out, n, K, launched,
                                           s);
  return (int)cudaErrorInvalidValue;
}

const char* gossip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
