// AltGDmin least-squares kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/altgdmin_ls.py:
//   * altgdmin_node_fused_iter  <- node_fused_iter (_fused_iter_kernel,
//     _chol_solve_unrolled): per task (g, t) build A = X_t U_g (n x r),
//     form G = A^T A and c = A^T y_t, solve G b = c by Cholesky, keep the
//     residual A b - y_t, then emit the gradient tile X_t^T resid b^T.
//     Two kernels: fused_resident_kernel reads X_t once, into shared
//     memory, where n d fits the block's budget (Experiment 1: 72 KB);
//     fused_iter_kernel, the first port, streams X_t twice where it does
//     not (see "Design" for both).
//   * altgdmin_node_task_gram   <- node_task_gram (_gram_kernel_nb): the
//     first half only, emitting (G, c); the r x r solve runs outside.
//   * altgdmin_node_grad_tiles  <- node_task_grad_tiles (_grad_kernel_nb):
//     the second half for a GIVEN B (the sample-split path, where B comes
//     from another fold): A = X_t U_g is rebuilt, resid = A b_t - y_t, and
//     the tile X_t^T resid b_t^T is emitted.  It shares the A build
//     (load_task) and the tile pass (write_tiles) with the fused kernel.
//   * task_gram (_gram_kernel) and task_grad_tiles (_grad_kernel), ONE
//     basis U (d, r) shared by T tasks, are the last two entries launched
//     with L = 1, tpn = T: with one node every block's basis is U.  At the
//     serving batch (T = 32, n = 16, d = 600, r = 4, f32) they must move
//     1.24 / 1.55 MB (0.37 / 0.46 us at 3.35 TB/s); one block a task fills
//     only 32 of the 132 SMs there, a known weakness left for a later
//     change (a block per (task, d slice)).
//
// Layouts (row-major, contiguous): X (L, tpn, n, d), U (L, d, r),
// y (L, tpn, n) in float32 or bfloat16 (converted to f32 in the load);
// B (L, tpn, r) float32 as an input of the gradient kernel, as an output
// of the fused one; outputs tiles (L, tpn, d, r), G (L, tpn, r, r),
// c (L, tpn, r), all float32.
//
// Design.  The Pallas kernel carries A across sequential grid steps over
// d tiles in VMEM scratch; CUDA blocks run in no order, so here ONE block
// owns one task and loops over the whole of d itself (L*tpn = 600 blocks
// at the paper's Experiment 1 shape, enough to fill 132 SMs).  Each warp
// builds rows of A with its lanes strided along d, so a warp reads a row
// of X as one contiguous stream; the ragged end of d is masked by the loop
// bound, nothing is padded.  A, y, G, c, b and the residual stay in shared
// memory.  The Cholesky is done by one thread in f32 in exactly the order
// of _chol_solve_unrolled.  The gradient pass re-reads X with threads
// along d (coalesced).
//
// The resident fused kernel runs a task on a thread-block cluster of one
// or two CTAs (resident_ctas), each holding its share of X_t's columns
// (n x d/ctas, in X's dtype) in shared memory, copied once with 16-byte
// cp.async where every row is 16-byte aligned (element by element
// otherwise, as at d = 97), with U_g's rows for those columns beside
// them: at Experiment 1, 41 KB a CTA on two CTAs in f32, 42 KB on one in
// bf16, five CTAs an SM either way (U_g read from L1/L2 instead left each
// iteration of the A loop waiting on an L2 read queued behind the X
// traffic).  Each CTA forms its partial A over its columns, each warp
// four rows at once so that one read of a U row serves four X values,
// summed over the lanes with log2(RC) + 5 shuffles a row; the partials
// are summed in rank order through distributed shared memory, so every
// CTA holds the same A, and each forms G, c, the Cholesky (one thread,
// r <= 16, in registers, the only phase on one thread) and the residual.
// Each CTA then writes its columns' rows of the tile from its shared
// copy, once (16 bytes a row where r = 4).
//
// Bound on the card: bytes.  At Experiment 1 (L=20, tpn=30, n=30, d=600,
// r=4, f32) the fused kernel must move 49.2 MB (X once, the tiles once):
// 0.0147 ms at 3.35 TB/s, while its arithmetic would take a tenth of that
// at the f32 peak.  The two-pass kernel reads X twice, the second time
// largely from L2: measured by chip_smoke.py on an NVIDIA H100 80GB HBM3
// at its 700 W limit, 0.066 ms per fused launch, 0.041 ms per Gram
// launch (bound 0.0130 ms).  The gradient kernel at the sample-split fold
// of Experiment 1 (n = 15 per fold) must move 27.4 MB (X once, the tiles
// once; 0.0082 ms at 3.35 TB/s) and reads X twice, the second time from
// L2 (a fold's X, 21.6 MB, fits the 50 MB L2).
// r is bounded by a template capacity of 4, 8 or 16 (R_MAX = 16) so the
// per-lane accumulators of A stay in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "mma_sm90.cuh"  // cp_async16

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared-memory layout of one task, RC = capacity of r.
template <int RC>
struct TaskSmem {
  float* A;      // n * RC
  float* yv;     // n
  float* resid;  // n
  float* G;      // RC * RC
  float* c;      // RC
  float* b;      // RC
  __device__ TaskSmem(float* base, int n) {
    A = base;
    yv = A + n * RC;
    resid = yv + n;
    G = resid + n;
    c = G + RC * RC;
    b = c + RC;
  }
};

template <int RC>
size_t task_smem_bytes(int n) {
  return sizeof(float) * ((size_t)n * RC + 2 * (size_t)n + RC * RC + 2 * RC);
}

// y_t into shared memory and A = X_t U_g (rows of A spread over warps,
// lanes strided along d, a shuffle reduction per column).
template <typename T, int RC>
__device__ void load_task(const T* __restrict__ x, const T* __restrict__ u,
                          const T* __restrict__ y, TaskSmem<RC>& s, int n,
                          int d, int r) {
  for (int i = threadIdx.x; i < n; i += kThreads) s.yv[i] = to_f32(y[i]);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += kWarps) {
    float acc[RC];
#pragma unroll
    for (int k = 0; k < RC; ++k) acc[k] = 0.f;
    const T* xi = x + (size_t)i * d;
    for (int j = lane; j < d; j += 32) {
      const float xv = to_f32(xi[j]);
      const T* uj = u + (size_t)j * r;
#pragma unroll
      for (int k = 0; k < RC; ++k)
        if (k < r) acc[k] += xv * to_f32(uj[k]);
    }
#pragma unroll
    for (int k = 0; k < RC; ++k) {
      if (k < r) {  // r is uniform over the warp: every lane shuffles
        float v = acc[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) s.A[i * RC + k] = v;
      }
    }
  }
}

// G = A^T A (r x r, row stride r) and c = A^T y, one output per thread.
template <int RC>
__device__ void form_gram(TaskSmem<RC>& s, int n, int r) {
  for (int e = threadIdx.x; e < r * r + r; e += kThreads) {
    float acc = 0.f;
    if (e < r * r) {
      const int a = e / r, b = e % r;
      for (int i = 0; i < n; ++i) acc += s.A[i * RC + a] * s.A[i * RC + b];
      s.G[e] = acc;
    } else {
      const int k = e - r * r;
      for (int i = 0; i < n; ++i) acc += s.A[i * RC + k] * s.yv[i];
      s.c[k] = acc;
    }
  }
}

// Solve G b = c for SPD G by Cholesky and forward/back substitution, in
// the operation order of _chol_solve_unrolled (each partial sum starts at
// 0 and adds in increasing index order before it is subtracted).  The
// loops run to the capacity RC with r as a guard, so they unroll and L
// and z stay in registers (one thread runs it, while the block waits).
template <int RC>
__device__ void chol_solve(const float* G, const float* c, float* b, int r) {
  float Lc[RC][RC];
  float z[RC], bv[RC];
#pragma unroll
  for (int i = 0; i < RC; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      if (i < r) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < j; ++k) acc += Lc[i][k] * Lc[j][k];
        const float sv = G[i * r + j] - acc;
        Lc[i][j] = (i == j) ? sqrtf(sv) : sv / Lc[j][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    if (i < r) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < i; ++k) acc += Lc[i][k] * z[k];
      z[i] = (c[i] - acc) / Lc[i][i];
    }
  }
#pragma unroll
  for (int i = RC - 1; i >= 0; --i) {
    if (i < r) {
      float acc = 0.f;
#pragma unroll
      for (int k = i + 1; k < RC; ++k)
        if (k < r) acc += Lc[k][i] * bv[k];
      bv[i] = (z[i] - acc) / Lc[i][i];
      b[i] = bv[i];
    }
  }
}

// resid = A b - y (A, b, y in shared memory).
template <int RC>
__device__ void form_resid(TaskSmem<RC>& s, int n, int r) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < r; ++k) acc += s.A[i * RC + k] * s.b[k];
    s.resid[i] = acc - s.yv[i];
  }
}

// The gradient tile X_t^T resid b^T (d x r): threads along d, so a warp
// reads 32 neighbouring columns of a row of X_t (coalesced); the ragged
// end of d is masked by the loop bound.
template <typename T, int RC>
__device__ void write_tiles(const T* __restrict__ x, TaskSmem<RC>& s,
                            float* __restrict__ out, int n, int d, int r) {
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += to_f32(x[(size_t)i * d + j]) * s.resid[i];
    for (int k = 0; k < r; ++k) out[(size_t)j * r + k] = acc * s.b[k];
  }
}

template <typename T, int RC>
__global__ void __launch_bounds__(kThreads)
fused_iter_kernel(const T* __restrict__ X, const T* __restrict__ U,
                  const T* __restrict__ Y, float* __restrict__ B,
                  float* __restrict__ tiles, int tpn, int n, int d, int r) {
  extern __shared__ float smem[];
  TaskSmem<RC> s(smem, n);
  const size_t task = blockIdx.x;  // g * tpn + t
  const size_t g = task / tpn;
  const T* x = X + task * n * d;
  load_task<T, RC>(x, U + g * d * r, Y + task * n, s, n, d, r);
  __syncthreads();
  form_gram<RC>(s, n, r);
  __syncthreads();
  if (threadIdx.x == 0) chol_solve<RC>(s.G, s.c, s.b, r);
  __syncthreads();
  form_resid<RC>(s, n, r);
  if (threadIdx.x < r) B[task * r + threadIdx.x] = s.b[threadIdx.x];
  __syncthreads();
  write_tiles<T, RC>(x, s, tiles + task * d * r, n, d, r);
}

// fused_resident_kernel: a cluster of ctas CTAs a task (1 or 2), CTA k
// holding columns [k dh, (k + 1) dh) of X_t, dh = ceil(d / ctas) rounded
// up to 8 elements (16 bytes in either dtype).
constexpr int kMaxCtas = 2;
constexpr int kRowsA = 4;                    // rows of A a warp forms at once
constexpr size_t kResidentSmemMax = 232448;  // a block's dynamic maximum

__host__ __device__ inline int cluster_cols(int d, int ctas) {
  return ((d + ctas - 1) / ctas + 7) & ~7;
}

// Shared memory of one CTA: its n x dh columns of X_t and its dh x RC rows
// of U_g (in X's dtype, 16-byte multiples), its partial A (n x RC), then
// the TaskSmem block.
template <typename T, int RC>
size_t resident_smem_bytes(int n, int d, int ctas) {
  const size_t dh = cluster_cols(d, ctas);
  return (size_t)n * dh * sizeof(T) + ((dh * RC * sizeof(T) + 15) & ~15) +
         sizeof(float) * (size_t)n * RC + task_smem_bytes<RC>(n);
}

// CTAs a task: of 1 and 2, the fewest that keep the most tasks on an SM
// by shared memory (233472 bytes an SM, 1 KB more a CTA).  On the H100
// at Experiment 1 (chip_smoke.py, kernels phase) this picks two CTAs in
// f32 (2.5 tasks an SM, against 2 on one CTA) and one in bf16 (5 either
// way), the faster form at each dtype.
template <typename T, int RC>
int resident_ctas(int n, int d) {
  constexpr size_t kSmemPerSm = 233472, kCtaReserve = 1024;
  int best = 1;
  double best_tasks = -1.0;
  for (int c = 1; c <= kMaxCtas; ++c) {
    const size_t per_sm =
        kSmemPerSm / (resident_smem_bytes<T, RC>(n, d, c) + kCtaReserve);
    if ((double)per_sm / c > best_tasks) {
      best = c;
      best_tasks = (double)per_sm / c;
    }
  }
  return best;
}

// Row j of U (r elements in shared memory, row stride r) as f32, 0 past
// r: one vector read where r = RC (so a warp reads its 32 rows in as few
// shared-memory wavefronts as their bytes allow), else element by element.
template <int RC>
__device__ __forceinline__ void u_row(const float* us, int j, int r,
                                      float (&uv)[RC]) {
  if (r == RC) {
#pragma unroll
    for (int k = 0; k < RC; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(us + j * RC + k);
      uv[k] = q.x; uv[k + 1] = q.y; uv[k + 2] = q.z; uv[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < RC; ++k) uv[k] = k < r ? us[j * r + k] : 0.f;
  }
}
template <int RC>
__device__ __forceinline__ void u_row(const __nv_bfloat16* us, int j, int r,
                                      float (&uv)[RC]) {
  if (r == RC) {
#pragma unroll
    for (int k = 0; k < RC; k += 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(us + j * RC + k);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&q.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&q.y));
      uv[k] = lo.x; uv[k + 1] = lo.y; uv[k + 2] = hi.x; uv[k + 3] = hi.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < RC; ++k)
      uv[k] = k < r ? __bfloat162float(us[j * r + k]) : 0.f;
  }
}

// The sums over the warp's 32 lanes of RC values a lane, log2(RC) + 5
// shuffles in all (not 5 RC): at offsets 16, 8, .. each lane keeps half
// of its values and adds its partner's sums of that half, then plain
// butterflies finish.  Returns the total of value index
// row_sum_index<RC>(lane) (the same in every run).
template <int RC>
__device__ __forceinline__ float warp_row_sum(float (&a)[RC], int lane) {
#pragma unroll
  for (int half = RC / 2, o = 16; half >= 1; half >>= 1, o >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? a[i] : a[i + half];
      const float keep = upper ? a[i + half] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float v = a[0];
#pragma unroll
  for (int o = 16 / RC; o >= 1; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
template <int RC>
__device__ __forceinline__ int row_sum_index(int lane) {
  int v = 0;
#pragma unroll
  for (int half = RC / 2, o = 16; half >= 1; half >>= 1, o >>= 1)
    if (lane & o) v += half;
  return v;
}

// At r <= 4 the registers are capped for five CTAs an SM (Experiment 1's
// 41 KB a CTA fits five); the larger capacities keep their Cholesky in
// registers instead.
// Launched with a cluster dimension of ctas (launch_resident).
template <typename T, int RC>
__global__ void __launch_bounds__(kThreads, RC == 4 ? 5 : 1)
fused_resident_kernel(const T* __restrict__ X, const T* __restrict__ U,
                      const T* __restrict__ Y, float* __restrict__ B,
                      float* __restrict__ tiles, int tpn, int n, int d,
                      int r, int vec, int ctas) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int dh = cluster_cols(d, ctas);
  const int j0 = rank * dh, jn = max(0, min(d, j0 + dh) - j0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);   // n x dh: this CTA's columns
  T* us = xs + (size_t)n * dh;              // jn x r: U_g's rows for them
  float* a_part = reinterpret_cast<float*>(
      smem_raw + (size_t)n * dh * sizeof(T) +
      (((size_t)dh * RC * sizeof(T) + 15) & ~(size_t)15));  // n x RC
  TaskSmem<RC> s(a_part + n * RC, n);
  const size_t task = blockIdx.x / ctas;  // g * tpn + t
  const size_t g = task / tpn;
  const T* x = X + task * n * d + j0;
  const T* u = U + (g * d + j0) * r;

  // X_t's columns and U_g's rows for them, once from device memory, with
  // 16-byte copies where every row segment is aligned (d and j0 multiples
  // of 16 bytes, X and U aligned); y_t meanwhile
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int cpr = jn / kPer;   // jn, so jn r, is a multiple of kPer
    for (int e = threadIdx.x; e < n * cpr; e += kThreads) {
      const int i = e / cpr, c = e - i * cpr;
      sm90::cp_async16(xs + i * dh + c * kPer, x + (size_t)i * d + c * kPer,
                       16);
    }
    for (int e = threadIdx.x; e < cpr * r; e += kThreads)
      sm90::cp_async16(us + e * kPer, u + e * kPer, 16);
    sm90::cp_async_commit();
  } else {
    for (int e = threadIdx.x; e < n * jn; e += kThreads) {
      const int i = e / jn, j = e - i * jn;
      xs[i * dh + j] = x[(size_t)i * d + j];
    }
    for (int e = threadIdx.x; e < jn * r; e += kThreads) us[e] = u[e];
  }
  for (int i = threadIdx.x; i < n; i += kThreads) s.yv[i] = to_f32(Y[task * n + i]);
  sm90::cp_async_wait<0>();
  __syncthreads();

  // partial A over this CTA's columns: each warp kRowsA rows, lanes
  // strided along d
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i0 = warp * kRowsA; i0 < n; i0 += kWarps * kRowsA) {
    const int rows = min(kRowsA, n - i0);
    float acc[kRowsA][RC];
#pragma unroll
    for (int rr = 0; rr < kRowsA; ++rr)
#pragma unroll
      for (int k = 0; k < RC; ++k) acc[rr][k] = 0.f;
    for (int j = lane; j < jn; j += 32) {
      float uv[RC];
      u_row<RC>(us, j, r, uv);
#pragma unroll
      for (int rr = 0; rr < kRowsA; ++rr) {
        if (rr < rows) {
          const float xv = to_f32(xs[(i0 + rr) * dh + j]);
#pragma unroll
          for (int k = 0; k < RC; ++k) acc[rr][k] += xv * uv[k];
        }
      }
    }
    const int k = row_sum_index<RC>(lane);
    const bool writer = (lane & (32 / RC - 1)) == 0 && k < r;
#pragma unroll
    for (int rr = 0; rr < kRowsA; ++rr) {
      if (rr < rows) {  // uniform over the warp
        const float v = warp_row_sum<RC>(acc[rr], lane);
        if (writer) a_part[(i0 + rr) * RC + k] = v;
      }
    }
  }
  // A = the CTAs' partials summed in rank order, the same in every CTA
  // (distributed shared memory)
  cluster.sync();
  for (int e = threadIdx.x; e < n * r; e += kThreads) {
    const int i = e / r, k = e - i * r;
    float v = 0.f;
    for (int q = 0; q < ctas; ++q)
      v += cluster.map_shared_rank(a_part, q)[i * RC + k];
    s.A[i * RC + k] = v;
  }
  __syncthreads();
  form_gram<RC>(s, n, r);
  __syncthreads();
  if (threadIdx.x == 0) chol_solve<RC>(s.G, s.c, s.b, r);
  __syncthreads();
  form_resid<RC>(s, n, r);
  if (rank == 0 && threadIdx.x < r) B[task * r + threadIdx.x] = s.b[threadIdx.x];
  __syncthreads();

  // this CTA's rows of the tile X_t^T resid b^T, a row of r per column
  float* out = tiles + (task * d + j0) * r;
  for (int j = threadIdx.x; j < jn; j += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += to_f32(xs[i * dh + j]) * s.resid[i];
    if (RC == 4 && r == 4) {
      *reinterpret_cast<float4*>(out + (size_t)j * 4) =
          make_float4(acc * s.b[0], acc * s.b[1], acc * s.b[2], acc * s.b[3]);
    } else {
      for (int k = 0; k < r; ++k) out[(size_t)j * r + k] = acc * s.b[k];
    }
  }
  cluster.sync();  // no CTA leaves while a peer may read its partial A
}

template <typename T, int RC>
__global__ void __launch_bounds__(kThreads)
task_gram_kernel(const T* __restrict__ X, const T* __restrict__ U,
                 const T* __restrict__ Y, float* __restrict__ Gout,
                 float* __restrict__ Cout, int tpn, int n, int d, int r) {
  extern __shared__ float smem[];
  TaskSmem<RC> s(smem, n);
  const size_t task = blockIdx.x;
  const size_t g = task / tpn;
  load_task<T, RC>(X + task * n * d, U + g * d * r, Y + task * n, s, n, d, r);
  __syncthreads();
  form_gram<RC>(s, n, r);
  __syncthreads();
  for (int e = threadIdx.x; e < r * r; e += kThreads) Gout[task * r * r + e] = s.G[e];
  for (int k = threadIdx.x; k < r; k += kThreads) Cout[task * r + k] = s.c[k];
}

template <typename T, int RC>
__global__ void __launch_bounds__(kThreads)
grad_tiles_kernel(const T* __restrict__ X, const T* __restrict__ U,
                  const float* __restrict__ B, const T* __restrict__ Y,
                  float* __restrict__ tiles, int tpn, int n, int d, int r) {
  extern __shared__ float smem[];
  TaskSmem<RC> s(smem, n);
  const size_t task = blockIdx.x;
  const size_t g = task / tpn;
  const T* x = X + task * n * d;
  load_task<T, RC>(x, U + g * d * r, Y + task * n, s, n, d, r);
  if (threadIdx.x < r) s.b[threadIdx.x] = B[task * r + threadIdx.x];
  __syncthreads();
  form_resid<RC>(s, n, r);
  __syncthreads();
  write_tiles<T, RC>(x, s, tiles + task * d * r, n, d, r);
}

enum Kind { kFused, kGram, kGrad };

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int tasks, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<tasks, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// fused_resident_kernel on clusters of ctas CTAs, ctas a task.
template <typename T, int RC>
cudaError_t launch_resident(int tasks, int ctas, size_t smem,
                            cudaStream_t stream, const T* x, const T* u,
                            const T* y, float* B, float* tiles, int tpn,
                            int n, int d, int r, int vec) {
  const auto kernel = fused_resident_kernel<T, RC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tasks * ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, u, y, B, tiles, tpn,
                                       n, d, r, vec, ctas);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The fused kind counts the kernel it launched in launched[0] (resident)
// or launched[1] (two-pass): the choice is made here only.  ctas 0 picks
// the resident kernel's CTAs a task (resident_ctas); 1 or 2 forces it.
template <typename T, int RC>
cudaError_t run(Kind kind, const void* X, const void* U, const void* Bin,
                const void* Y, void* o1, void* o2, int tasks, int tpn, int n,
                int d, int r, int ctas, int* launched, cudaStream_t stream) {
  const size_t smem = task_smem_bytes<RC>(n);
  const T* x = static_cast<const T*>(X);
  const T* u = static_cast<const T*>(U);
  const T* y = static_cast<const T*>(Y);
  float* out1 = static_cast<float*>(o1);
  float* out2 = static_cast<float*>(o2);
  if (kind == kFused) {
    if (ctas == 0) ctas = resident_ctas<T, RC>(n, d);
    const size_t smem_res = resident_smem_bytes<T, RC>(n, d, ctas);
    const bool resident = smem_res <= kResidentSmemMax;
    cudaError_t err;
    if (resident) {
      const int vec = ((size_t)d * sizeof(T)) % 16 == 0 &&
                      (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(U) & 15) == 0;
      err = launch_resident<T, RC>(tasks, ctas, smem_res, stream, x, u, y,
                                   out1, out2, tpn, n, d, r, vec);
    } else {
      err = launch(fused_iter_kernel<T, RC>, tasks, smem, stream, x, u, y,
                   out1, out2, tpn, n, d, r);
    }
    if (err == cudaSuccess) ++launched[resident ? 0 : 1];
    return err;
  }
  if (kind == kGram)
    return launch(task_gram_kernel<T, RC>, tasks, smem, stream, x, u, y,
                  out1, out2, tpn, n, d, r);
  return launch(grad_tiles_kernel<T, RC>, tasks, smem, stream, x, u,
                static_cast<const float*>(Bin), y, out1, tpn, n, d, r);
}

template <typename T>
cudaError_t dispatch_r(Kind kind, const void* X, const void* U,
                       const void* Bin, const void* Y, void* o1, void* o2,
                       int tasks, int tpn, int n, int d, int r, int ctas,
                       int* launched, cudaStream_t stream) {
  if (r <= 4)
    return run<T, 4>(kind, X, U, Bin, Y, o1, o2, tasks, tpn, n, d, r, ctas,
                     launched, stream);
  if (r <= 8)
    return run<T, 8>(kind, X, U, Bin, Y, o1, o2, tasks, tpn, n, d, r, ctas,
                     launched, stream);
  if (r <= 16)
    return run<T, 16>(kind, X, U, Bin, Y, o1, o2, tasks, tpn, n, d, r, ctas,
                      launched, stream);
  return cudaErrorInvalidValue;
}

int entry(Kind kind, const void* X, const void* U, const void* Bin,
          const void* Y, void* o1, void* o2, int L, int tpn, int n, int d,
          int r, int dtype, int device, void* stream, int ctas = 0,
          int* launched = nullptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tasks = L * tpn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_r<float>(kind, X, U, Bin, Y, o1, o2, tasks, tpn, n,
                                  d, r, ctas, launched, s);
  if (dtype == 1)
    return (int)dispatch_r<__nv_bfloat16>(kind, X, U, Bin, Y, o1, o2, tasks,
                                          tpn, n, d, r, ctas, launched, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (X, U and y share it).
// Returns cudaGetLastError() after the launch (0 = success).
// The fused entry also takes ctas, the CTAs a task of the resident kernel
// (0 = resident_ctas' pick, or 1 or 2), and adds 1 to launched[0] where
// it launched the resident kernel, to launched[1] where the two-pass one
// (n d past the budget).
int altgdmin_node_fused_iter(const void* X, const void* U, const void* Y,
                             void* B, void* tiles, int L, int tpn, int n,
                             int d, int r, int dtype, int device,
                             void* stream, int ctas, int* launched) {
  if (ctas < 0 || ctas > kMaxCtas || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  return entry(kFused, X, U, nullptr, Y, B, tiles, L, tpn, n, d, r, dtype,
               device, stream, ctas, launched);
}

int altgdmin_node_task_gram(const void* X, const void* U, const void* Y,
                            void* G, void* c, int L, int tpn, int n, int d,
                            int r, int dtype, int device, void* stream) {
  return entry(kGram, X, U, nullptr, Y, G, c, L, tpn, n, d, r, dtype, device,
               stream);
}

// B is float32 whatever the dtype of X, U and y.
int altgdmin_node_grad_tiles(const void* X, const void* U, const void* B,
                             const void* Y, void* tiles, int L, int tpn,
                             int n, int d, int r, int dtype, int device,
                             void* stream) {
  return entry(kGrad, X, U, B, Y, tiles, nullptr, L, tpn, n, d, r, dtype,
               device, stream);
}

const char* altgdmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
