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
//     stream_gram_kernel streams X_t once and holds none of it (see
//     "Design").
//   * altgdmin_node_grad_tiles  <- node_task_grad_tiles (_grad_kernel_nb):
//     the second half for a GIVEN B (the sample-split path, where B comes
//     from another fold): A = X_t U_g is rebuilt, resid = A b_t - y_t, and
//     the tile X_t^T resid b_t^T is emitted.  Where n d fits the budget it
//     is the resident fused kernel's gradient form (kGradOnly), which
//     reads X_t once; past it the first port's grad_tiles_kernel, which
//     shares the A build (load_task) and the tile pass (write_tiles) with
//     fused_iter_kernel, streams X_t twice.
//   * task_gram (_gram_kernel) and task_grad_tiles (_grad_kernel), ONE
//     basis U (d, r) shared by T tasks, are the last two entries launched
//     with L = 1, tpn = T: with one node every block's basis is U.  At the
//     serving batch (T = 32, n = 16, d = 600, r = 4, f32) they must move
//     1.24 / 1.55 MB (0.37 / 0.46 us at 3.35 TB/s), so both are bound by
//     the launch and a few trips to memory there; each runs one CTA a
//     task (32 of the 132 SMs).
//
// Layouts (row-major, contiguous): X (L, tpn, n, d), U (L, d, r),
// y (L, tpn, n) in float32 or bfloat16 (converted to f32 in the load);
// B (L, tpn, r) float32 as an input of the gradient kernel, as an output
// of the fused one; outputs tiles (L, tpn, d, r), G (L, tpn, r, r),
// c (L, tpn, r), all float32.
//
// Design.  The Pallas kernel carries A across sequential grid steps over
// d tiles in VMEM scratch; CUDA blocks run in no order, so here ONE block
// (or one cluster) owns one task and loops over d itself (L*tpn = 600
// tasks at the paper's Experiment 1 shape, enough to fill 132 SMs).  In
// the first port's kernels (fused_iter_kernel, grad_tiles_kernel) each
// warp builds rows of A with its lanes strided along d, so a warp reads a
// row of X as one contiguous stream; the ragged end of d is masked by the
// loop bound, nothing is padded.  A, y, G, c, b and the residual stay in
// shared memory.  The Cholesky is done by one thread in f32 in exactly
// the order of _chol_solve_unrolled.  The gradient pass re-reads X with
// threads along d (coalesced).
//
// The Gram kernel (stream_gram_kernel) reads X once and needs only bytes
// in flight and reuse of U.  One CTA owns a task.  Each warp forms four
// rows of A at a time (one read of a U row serves four X values), a lane
// taking one 16-byte chunk of each row a step; the lane copies its
// chunks with cp.async into its own slots of a ring in shared memory,
// three steps ahead of the one it computes, so the bytes in flight take
// no registers and need no barrier.  U_g's rows are staged in shared
// memory once where they fit (else read through L1).  Each step's
// products are summed over the lanes by shuffles, the steps in column
// order; G and c are formed one output a thread over chunks of A's rows.
// Up to four warps a CTA where the grid has two CTAs an SM or more, up
// to eight where it has fewer (gram_warps).  A task is not split over
// CTAs: on the H100 a cluster split measured slower at the serving batch
// and at Experiment 1 (PERF.md).  No count of warps, and no zero row or
// task added, changes a bit of a task's G and c.
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
// The gradient form of that kernel skips the Gram, the Cholesky and the
// B store and reads b_t from B.  Its rows of X_t are copied in stages of
// whole row groups, each tracked by an mbarrier that every thread's
// copies arrive on, so each warp forms its rows of A as soon as their
// stage has landed, while later stages are in flight, with no barrier of
// the whole CTA.  X_t's columns are cut into two segments (one a CTA on
// two CTAs a task, both on one); a lane sums a segment's columns in
// order and the lanes' tree runs once a segment, and A is the segments'
// partials added in order: each entry of A, and of the tile, has one
// order of summation whatever the CTAs a task or the tasks of a launch.
// grad_layout picks the CTAs a task and whether U_g's rows are staged in
// shared memory or read through L1 by the waves of the launch: at path
// A's fold one CTA with U_g through L1 (36 KB of X_t, five CTAs an SM,
// the 600 tasks in one wave), at the serving batches two with U_g staged.
//
// Bound on the card: bytes.  At Experiment 1 (L=20, tpn=30, n=30, d=600,
// r=4, f32) the fused kernel must move 49.2 MB (X once, the tiles once):
// 0.0147 ms at 3.35 TB/s, while its arithmetic would take a tenth of that
// at the f32 peak; the Gram kernel 43.5 MB (0.0130 ms).  The two-pass
// kernel reads X twice, the second time largely from L2: measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at its 700 W limit, 0.066 ms
// per fused launch.  The gradient kernel at the sample-split fold of
// Experiment 1 (n = 15 per fold) must move 27.4 MB (X once, the tiles
// once; 0.0082 ms at 3.35 TB/s); its resident form reads X once.
// Times: PERF.md.
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

// The gradient form (kGradOnly) cuts X_t's columns into two segments,
// [0, grad_split(d)) and [grad_split(d), d); on two CTAs a task each CTA
// holds one segment, on one CTA both.  An entry of A is the two
// segments' partials added in order, each summed by a lane over its
// columns in increasing order and then over the lanes in one tree: one
// order of summation whatever the CTAs a task.  Its rows arrive in
// stages of whole row groups, at most kGradStages, each tracked by an
// mbarrier.
constexpr int kGradSegments = 2;
constexpr int kGradStages = 32;

// d / 2 rounded up to a multiple of 64 (so of 32 lanes and 16 bytes)
__host__ __device__ inline int grad_split(int d) {
  return ((d + 1) / 2 + 63) / 64 * 64;
}
// Columns of X_t a CTA holds (its shared-memory row stride)
template <bool kGradOnly>
__host__ __device__ inline int share_cols(int d, int ctas) {
  if (!kGradOnly) return cluster_cols(d, ctas);
  return ctas == 1 ? (d + 7) & ~7 : grad_split(d);
}

// Shared memory of one CTA: the gradient form's stage barriers, its n x
// dh columns of X_t and, where ushared, its dh x RC rows of U_g (in X's
// dtype, 16-byte multiples; the gradient form reads U_g through L1
// instead where staging it would cost a CTA an SM, as at path A's fold),
// its partial A (n x RC; one a segment in the gradient form), then the
// TaskSmem block.
__host__ __device__ inline size_t resident_us_bytes(int dh, int rc,
                                                    int tsize, int ushared) {
  return ushared ? ((size_t)dh * rc * tsize + 15) & ~(size_t)15 : 0;
}
// the gradient form's stage mbarriers, ahead of X_t's columns
template <bool kGradOnly>
__host__ __device__ constexpr size_t resident_bars_bytes() {
  return kGradOnly ? sizeof(unsigned long long) * kGradStages : 0;
}
template <typename T, int RC, bool kGradOnly>
size_t resident_smem_bytes(int n, int d, int ctas, int ushared = 1) {
  const size_t dh = share_cols<kGradOnly>(d, ctas);
  const size_t parts = kGradOnly ? kGradSegments : 1;
  return resident_bars_bytes<kGradOnly>() + (size_t)n * dh * sizeof(T) +
         resident_us_bytes(dh, RC, sizeof(T), ushared) +
         sizeof(float) * parts * n * RC + task_smem_bytes<RC>(n);
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
        kSmemPerSm /
        (resident_smem_bytes<T, RC, false>(n, d, c) + kCtaReserve);
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
// row_sum_index<RC>(lane) (the same in every run).  Template recursion
// keeps every index a constant, so a stays in registers (loops left a
// at RC = 16 in local memory).
template <int RC, int Half, int O>
__device__ __forceinline__ void row_sum_halves(float (&a)[RC], int lane) {
  if constexpr (Half >= 1) {
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < Half; ++i) {
      const float send = upper ? a[i] : a[i + Half];
      const float keep = upper ? a[i + Half] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    row_sum_halves<RC, Half / 2, O / 2>(a, lane);
  }
}
template <int RC>
__device__ __forceinline__ float warp_row_sum(float (&a)[RC], int lane) {
  row_sum_halves<RC, RC / 2, 16>(a, lane);
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

// Row j of U (row stride r) as f32, 0 past r, from shared or global
// memory alike (a generic pointer), with 16- (f32) or 8-byte (bf16) loads
// of four values where vec4 (r = RC and the rows 16-byte aligned).
template <int RC, typename T>
__device__ __forceinline__ void u_row_any(const T* u, int j, int r,
                                          bool vec4, float (&uv)[RC]) {
  if (!vec4) {
#pragma unroll
    for (int k = 0; k < RC; ++k) uv[k] = k < r ? to_f32(u[j * r + k]) : 0.f;
    return;
  }
#pragma unroll
  for (int k = 0; k < RC; k += 4) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(u + j * RC + k);
      uv[k] = q.x; uv[k + 1] = q.y; uv[k + 2] = q.z; uv[k + 3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(u + j * RC + k);
      uv[k] = __uint_as_float(q.x << 16);
      uv[k + 1] = __uint_as_float(q.x & 0xffff0000u);
      uv[k + 2] = __uint_as_float(q.y << 16);
      uv[k + 3] = __uint_as_float(q.y & 0xffff0000u);
    }
  }
}

// mbarriers in shared memory tracking bulk (TMA) copies: init (one
// thread, then a fence and a barrier of the CTA), the expected bytes of
// a phase with the one arrival it counts, a bulk copy of a contiguous
// range (16-byte aligned, a multiple of 16 bytes) that completes its
// bytes on the mbarrier, and a wait for the phase of parity.
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(
                   sm90::smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(
                   sm90::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(sm90::smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// At r <= 4 the registers are capped for five CTAs an SM (Experiment 1's
// 41 KB a CTA fits five); the larger capacities keep their Cholesky in
// registers instead.
// Launched with a cluster dimension of ctas (launch_resident).
//
// kGradOnly: the gradient form for a GIVEN B (node_task_grad_tiles), the
// same kernel without the Gram, the Cholesky and the B store, b_t read
// from B, U_g staged only where ushared.  Its rows of X_t come in stages
// (an mbarrier each), and each warp forms its rows of A as soon as their
// stage lands, while the later stages are still in flight; A is the
// segments' partials summed in order (through distributed shared
// memory), whatever the CTAs a task.
template <typename T, int RC, bool kGradOnly>
__global__ void __launch_bounds__(kThreads, RC == 4 ? 5 : 1)
fused_resident_kernel(const T* __restrict__ X, const T* __restrict__ U,
                      const T* __restrict__ Y, float* __restrict__ B,
                      float* __restrict__ tiles, int tpn, int n, int d,
                      int r, int vec, int ctas, int ushared) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int dh = share_cols<kGradOnly>(d, ctas);
  const int j0 = rank * dh, jn = max(0, min(d, j0 + dh) - j0);
  const int parts = kGradOnly ? kGradSegments : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the gradient form's stage barriers first
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned char* base = smem_raw + resident_bars_bytes<kGradOnly>();
  T* xs = reinterpret_cast<T*>(base);       // n x dh: this CTA's columns
  T* us = xs + (size_t)n * dh;              // jn x r: U_g's rows for them
  float* a_part = reinterpret_cast<float*>(
      base + (size_t)n * dh * sizeof(T) +
      resident_us_bytes(dh, RC, sizeof(T), ushared));  // parts x n x RC
  TaskSmem<RC> s(a_part + (size_t)parts * n * RC, n);
  const size_t task = blockIdx.x / ctas;  // g * tpn + t
  const size_t g = task / tpn;
  const T* x = X + task * n * d + j0;
  const T* u = U + (g * d + j0) * r;
  constexpr int kPer = 16 / sizeof(T);

  if constexpr (kGradOnly) {
    // X_t's columns in stages of whole row groups, a bulk copy a row
    // (where every row segment is 16-byte aligned) issued by the lanes of
    // warp 0, each stage's bytes completing on its mbarrier; U_g's rows,
    // where staged, with the first stage.  Element by element otherwise.
    // y_t and b_t meanwhile.
    const int groups = (n + kRowsA - 1) / kRowsA;
    const int gps = (groups + kGradStages - 1) / kGradStages;  // a stage
    const int stages = (groups + gps - 1) / gps;
    const unsigned row_bytes = jn * sizeof(T), u_bytes = jn * r * sizeof(T);
    if (vec) {
      if (threadIdx.x < 32) {
        if (threadIdx.x == 0) {
          for (int st = 0; st < stages; ++st) mbar_init(bars + st, 1);
          mbar_init_fence();
          for (int st = 0; st < stages; ++st) {
            const int rows = min(n, (st + 1) * gps * kRowsA) -
                             st * gps * kRowsA;
            mbar_expect_tx(bars + st, rows * row_bytes +
                                          (st == 0 && ushared ? u_bytes : 0));
          }
        }
        __syncwarp();
        if (jn > 0) {
          if (ushared && threadIdx.x == 0) bulk_copy(us, u, u_bytes, bars);
          for (int i = threadIdx.x; i < n; i += 32)
            bulk_copy(xs + i * dh, x + (size_t)i * d, row_bytes,
                      bars + i / (gps * kRowsA));
        }
      }
      __syncthreads();   // the barriers' init, before any warp waits
    } else {
      for (int e = threadIdx.x; e < n * jn; e += kThreads) {
        const int i = e / jn, j = e - i * jn;
        xs[i * dh + j] = x[(size_t)i * d + j];
      }
      if (ushared)
        for (int e = threadIdx.x; e < jn * r; e += kThreads) us[e] = u[e];
    }
    for (int i = threadIdx.x; i < n; i += kThreads)
      s.yv[i] = to_f32(Y[task * n + i]);
    if (threadIdx.x < r) s.b[threadIdx.x] = B[task * r + threadIdx.x];
    if (!vec) __syncthreads();

    // The partial A of each segment held: each warp kRowsA rows at a
    // time, once their stage has landed, a lane taking the segment's
    // columns lane, lane + 32, .. in order, then the sum over the lanes;
    // U_g's rows from shared memory, or through L1.
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int k = row_sum_index<RC>(lane);
    const bool writer = (lane & (32 / RC - 1)) == 0 && k < r;
    // U_g's rows: the staged copy, or device memory through L1
    const T* usrc = ushared ? us : u;
    const bool vec4 = r == RC && (ushared || vec);
    const int split = ctas == 1 ? grad_split(d) : jn;  // segment 0's end
    const int segs = ctas == 1 && d > split ? 2 : jn > 0 ? 1 : 0;
    for (int gi = warp; gi < groups; gi += kWarps) {
      const int i0 = gi * kRowsA, rows = min(kRowsA, n - i0);
      if (vec) {
        if (ushared) mbar_wait(bars, 0);   // U_g's rows came with stage 0
        mbar_wait(bars + gi / gps, 0);
      }
      for (int sg = 0; sg < segs; ++sg) {
        float acc[kRowsA][RC];
#pragma unroll
        for (int rr = 0; rr < kRowsA; ++rr)
#pragma unroll
          for (int kk = 0; kk < RC; ++kk) acc[rr][kk] = 0.f;
        const int js = sg == 0 ? 0 : split, je = sg == 0 ? min(split, jn) : jn;
        for (int j = js + lane; j < je; j += 32) {
          float uv[RC];
          u_row_any<RC>(usrc, j, r, vec4, uv);
#pragma unroll
          for (int rr = 0; rr < kRowsA; ++rr) {
            if (rr < rows) {
              const float xv = to_f32(xs[(i0 + rr) * dh + j]);
#pragma unroll
              for (int kk = 0; kk < RC; ++kk) acc[rr][kk] += xv * uv[kk];
            }
          }
        }
        float* part = a_part + (size_t)sg * n * RC;
#pragma unroll
        for (int rr = 0; rr < kRowsA; ++rr) {
          if (rr < rows) {  // uniform over the warp
            const float v = warp_row_sum<RC>(acc[rr], lane);
            if (writer) part[(i0 + rr) * RC + k] = v;
          }
        }
      }
    }
  } else {
    // X_t's columns and U_g's rows for them, once from device memory,
    // with 16-byte copies where every row segment is aligned (d and j0
    // multiples of 16 bytes, X and U aligned); y_t meanwhile
    if (vec) {
      const int cpr = jn / kPer;   // jn, so jn r, is a multiple of kPer
      for (int e = threadIdx.x; e < n * cpr; e += kThreads) {
        const int i = e / cpr, c = e - i * cpr;
        sm90::cp_async16(xs + i * dh + c * kPer,
                         x + (size_t)i * d + c * kPer, 16);
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
    for (int i = threadIdx.x; i < n; i += kThreads)
      s.yv[i] = to_f32(Y[task * n + i]);
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
  }

  // A = the partials summed in order (the CTAs' in rank order; the
  // gradient form's, the segments'), the same in every CTA (distributed
  // shared memory)
  cluster.sync();
  const int nparts = kGradOnly ? (d > grad_split(d) ? 2 : 1) : ctas;
  for (int e = threadIdx.x; e < n * r; e += kThreads) {
    const int i = e / r, k = e - i * r;
    float v = 0.f;
    for (int q = 0; q < nparts; ++q) {
      const int owner = kGradOnly && ctas == 1 ? 0 : q;
      const int local = kGradOnly && ctas == 1 ? q : 0;
      v += cluster.map_shared_rank(a_part, owner)[(local * n + i) * RC + k];
    }
    s.A[i * RC + k] = v;
  }
  __syncthreads();
  if constexpr (!kGradOnly) {
    form_gram<RC>(s, n, r);
    __syncthreads();
    if (threadIdx.x == 0) chol_solve<RC>(s.G, s.c, s.b, r);
    __syncthreads();
  }
  form_resid<RC>(s, n, r);
  if (!kGradOnly && rank == 0 && threadIdx.x < r)
    B[task * r + threadIdx.x] = s.b[threadIdx.x];
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

// stream_gram_kernel: the Gram pair of a task on one CTA of gram_warps
// warps.  Where U_g's rows fit in shared memory beside the rest of the
// kernel's (kUShared; d r up to about 40 K values in f32), they are staged
// there once; past that (d = 4096 at r = 16 in f32, say) each lane reads
// them through L1.  A is formed gram_chunk_rows rows at a time, so n is
// bounded by nothing but the grid.
constexpr int kGramStages = 4;      // 16-byte chunks in flight a row a lane
constexpr int kGramFillCtas = 132;  // the card's SMs
constexpr int kGramMaxWarps = 8;
constexpr int kGramChunkRows = 256;  // rows of A in shared memory at most

// Warps a CTA: one a group of kRowsA rows, at most four where the grid
// has two CTAs an SM or more (more CTAs an SM instead), else eight.
inline int gram_warps(int n, int tasks) {
  const int groups = (n + kRowsA - 1) / kRowsA;
  const int cap = tasks >= 2 * kGramFillCtas ? 4 : kGramMaxWarps;
  return groups < cap ? groups : cap;
}

// Rows of A a chunk: whole groups of kRowsA rows for every warp (so every
// chunk starts at a multiple of kRowsA), all of n where it fits.
inline int gram_chunk_rows(int n, int warps) {
  const int per = warps * kRowsA;
  const int most = (kGramChunkRows / per > 1 ? kGramChunkRows / per : 1) * per;
  const int all = (n + per - 1) / per * per;
  return most < all ? most : all;
}

// Shared memory of one CTA: U_g's rows (d x RC in X's dtype, a 16-byte
// multiple; kUShared only), each warp's ring of kGramStages x kRowsA
// chunks a lane, A's chunk (rows x RC), y_t's chunk, and the four partial
// sums of each output of G and c carried from chunk to chunk.
template <typename T, int RC>
__host__ __device__ size_t gram_us_bytes(int d) {
  return ((size_t)d * RC * sizeof(T) + 15) & ~(size_t)15;
}
template <int RC>
size_t gram_rest_bytes(int rows, int warps) {
  return sizeof(uint4) * warps * kGramStages * kRowsA * 32 +
         sizeof(float) * ((size_t)rows * (RC + 1) + 4 * (RC * RC + RC));
}

// Row j of U (row stride r) from global memory through L1, as f32, 0
// past r.
template <int RC, typename T>
__device__ __forceinline__ void u_row_ldg(const T* __restrict__ u, int j,
                                          int r, float (&uv)[RC]) {
#pragma unroll
  for (int k = 0; k < RC; ++k)
    uv[k] = k < r ? to_f32(__ldg(u + j * r + k)) : 0.f;
}

// 16 bytes of X (four f32 or eight bf16 values) as raw bits, element by
// element (rows not 16-byte aligned), 0 past the d columns.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row, int c,
                                            int d) {
  constexpr int kPer = 16 / sizeof(T);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int j = c * kPer + e;
    if (j < d) {
      if constexpr (sizeof(T) == 4)
        w[e] = reinterpret_cast<const unsigned*>(row)[j];
      else
        w[e / 2] |= (unsigned)reinterpret_cast<const unsigned short*>(row)[j]
                    << (16 * (e % 2));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// value e (a constant once unrolled) of a chunk's raw bits as f32
template <typename T>
__device__ __forceinline__ float chunk_value(uint4 q, int e) {
  constexpr int kPerWord = 4 / sizeof(T);   // values a 32-bit word
  const int wi = e / kPerWord;
  const unsigned w = wi == 0 ? q.x : wi == 1 ? q.y : wi == 2 ? q.z : q.w;
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(w);
  else
    return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
}

// cp.async as in mma_sm90.cuh, but each a compiler barrier too, so no
// shared-memory access of the thread moves across it: a lane reads a
// ring slot only after the wait for it, and refills it only after the
// read.
__device__ __forceinline__ void cp_async16_mem(void* dst, const void* src,
                                               int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit_mem() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_mem() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The sums over the warp's lanes of V values a lane (V = 16, 32 or 64),
// in about V shuffles: at offsets 16, 8, .. each lane keeps half of its
// values (the upper half where its lane bit is set) and adds its
// partner's sums of that half; at V = 16 a last butterfly at offset 1.
// Every value is summed over the lanes in the same tree, whichever lane
// ends up holding it.  Template recursion keeps every index a constant,
// so v stays in registers.  After it v[0] (and v[1] where V = 64) hold
// the totals of values sum_index<V>(lane) (+ 1); at V = 16 lanes 2k and
// 2k + 1 hold the same.
template <int V, int Half, int O>
__device__ __forceinline__ void warp_sum_values(float (&v)[V], int lane) {
  if constexpr (O >= 1) {
    if constexpr (Half >= 1) {
      const bool upper = lane & O;
#pragma unroll
      for (int i = 0; i < Half; ++i) {
        const float lo = v[i], hi = v[i + Half];
        const float got = __shfl_xor_sync(0xffffffffu, upper ? lo : hi, O);
        v[i] = (upper ? hi : lo) + got;
      }
      warp_sum_values<V, Half / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      warp_sum_values<V, 0, O / 2>(v, lane);
    }
  }
}
template <int V>
__device__ __forceinline__ int sum_index(int lane) {
  int idx = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s)
    if ((V >> (s + 1)) >= 1 && (lane & (16 >> s))) idx += V >> (s + 1);
  return idx;
}

// The Gram pair streams X once and holds none of it: each warp forms
// kRowsA rows of A at a time, a lane taking one 16-byte chunk of each row
// a step (a block of 32 chunks a warp), its lanes on neighbouring chunks.
// A lane copies its chunks into its own slots of the warp's ring with
// 16-byte cp.async, kGramStages - 1 steps ahead of the step it computes,
// so no register holds the bytes in flight and no barrier is needed
// (where the rows are not 16-byte aligned, as at d = 97, it loads them
// element by element into the same slots).  One read of a U row serves
// kRowsA X values.
//
// Every entry of A is summed in one order, whatever the warps, rows or
// tasks of the launch: a block's products over the lanes by
// warp_sum_values, then the blocks in column order from 0, in registers.
// The warps write a chunk of A's rows to shared memory; G and c are then
// formed one output a thread over the chunk's rows in order (four
// interleaved sums, carried from chunk to chunk; an output a warp, lanes
// over the rows, was slower at every shape timed: PERF.md).  Chunks
// start at multiples of four rows, so the chunking changes no bit
// either, and zero rows or tasks added around a task (the serving
// engine's padding) leave its G and c bit for bit as they are.
template <typename T, int RC, bool kUShared>
__global__ void __launch_bounds__(kGramMaxWarps * 32, RC == 16 ? 1 : 2)
stream_gram_kernel(const T* __restrict__ X, const T* __restrict__ U,
                   const T* __restrict__ Y, float* __restrict__ Gout,
                   float* __restrict__ Cout, int tpn, int n, int d, int r,
                   int vec, int chunk_rows) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kV = kRowsA * RC;
  constexpr int kT = kV >= 64 ? 2 : 1;       // totals a lane holds
  constexpr int S = kGramStages;
  const int nch = (d + kPer - 1) / kPer;     // 16-byte chunks of a row
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* us = reinterpret_cast<T*>(smem_raw);   // d x r: U_g's rows (kUShared)
  uint4* const ring0 = reinterpret_cast<uint4*>(
      smem_raw + (kUShared ? gram_us_bytes<T, RC>(d) : 0));
  // [S][kRowsA][32] slots of this warp, this lane's column
  uint4* ring = ring0 + (size_t)warp * S * kRowsA * 32 + lane;
  float* A =   // chunk_rows x RC
      reinterpret_cast<float*>(ring0 + (size_t)nwarps * S * kRowsA * 32);
  float* yv = A + (size_t)chunk_rows * RC;   // chunk_rows
  float* gs = yv + chunk_rows;               // [r r + r][4]
  const size_t task = blockIdx.x;            // g * tpn + t
  const size_t g = task / tpn;
  const T* x = X + task * n * d;
  const T* u = U + g * d * r;
  const T* yt = Y + task * n;

  // U_g's rows, once
  if constexpr (kUShared) {
    if (vec) {
      for (int e = threadIdx.x; e < d * r / kPer; e += blockDim.x)
        cp_async16_mem(us + e * kPer, u + e * kPer, 16);
    } else {
      for (int e = threadIdx.x; e < d * r; e += blockDim.x) us[e] = u[e];
    }
  }
  cp_async_commit_mem();

  // Each warp walks its row groups (warp, warp + nwarps, ..), a group in
  // steps of one block: step s has rows i0(s) .. + kRowsA and the lane's
  // chunk base(s) + lane.  (li0, lbase) is the next step to load.  A
  // chunk of rows holds gpc groups of each warp.
  const int groups = (n + kRowsA - 1) / kRowsA;
  const int per_group = (nch + 31) / 32;
  const int my_groups =
      warp < groups ? (groups - warp + nwarps - 1) / nwarps : 0;
  const int steps = my_groups * per_group;
  const int gpc = chunk_rows / (nwarps * kRowsA);
  int li0 = warp * kRowsA, lbase = 0;
  const auto load = [&](int slot) {
    const int c = lbase + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsA; ++rr) {
      uint4* dst = ring + (slot * kRowsA + rr) * 32;
      const bool in = c < nch && li0 + rr < n;
      const T* src = x + (size_t)(in ? li0 + rr : 0) * d;
      if (vec)
        cp_async16_mem(dst, src + (in ? c * kPer : 0), in ? 16 : 0);
      else
        *dst = in ? load_chunk<T>(src, c, d) : make_uint4(0u, 0u, 0u, 0u);
    }
    lbase += 32;
    if (lbase >= nch) lbase = 0, li0 += nwarps * kRowsA;
  };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit_mem();
  }
  cp_async_wait_mem<S - 1>();   // U_g's rows are in
  __syncthreads();

  const int idx = sum_index<kV>(lane);
  const bool writer = kV > 16 || (lane & 1) == 0;
  float tot[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) tot[t] = 0.f;
  int i0 = warp * kRowsA, base = 0, s = 0;
  for (int row0 = 0, ch = 0; row0 < n; row0 += chunk_rows, ++ch) {
    const int rows = min(chunk_rows, n - row0);
    // y_t's entry of this thread, waited on only where c is formed
    const T yraw = (int)threadIdx.x < rows ? yt[row0 + threadIdx.x] : T(0.f);
    const int s_end = min((ch + 1) * gpc, my_groups) * per_group;
    for (; s < s_end; ++s) {
      if (s + S - 1 < steps) load((s + S - 1) % S);
      cp_async_commit_mem();
      cp_async_wait_mem<S - 1>();   // step s's chunks are in this lane's slots
      float acc[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[v] = 0.f;
      const int c = base + lane;
      if (c < nch) {
        uint4 q[kRowsA];
#pragma unroll
        for (int rr = 0; rr < kRowsA; ++rr)
          q[rr] = ring[((s % S) * kRowsA + rr) * 32];
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int j = c * kPer + e;
          if (vec || j < d) {
            float uv[RC];
            if constexpr (kUShared)
              u_row<RC>(us, j, r, uv);
            else
              u_row_ldg<RC>(u, j, r, uv);
#pragma unroll
            for (int rr = 0; rr < kRowsA; ++rr) {
              const float xv = chunk_value<T>(q[rr], e);
#pragma unroll
              for (int k = 0; k < RC; ++k)
                acc[rr * RC + k] = fmaf(xv, uv[k], acc[rr * RC + k]);
            }
          }
        }
      }
      // the block's sums over the lanes, then into the rows' running sums
      warp_sum_values<kV, kV / 2, 16>(acc, lane);
#pragma unroll
      for (int t = 0; t < kT; ++t) tot[t] += acc[t];
      base += 32;
      if (base >= nch) {   // the group's rows are complete
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const int rr = (idx + t) / RC, k = (idx + t) % RC;
          if (writer && k < r && i0 + rr < n)
            A[(i0 + rr - row0) * RC + k] = tot[t];
          tot[t] = 0.f;
        }
        base = 0;
        i0 += nwarps * kRowsA;
      }
    }
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      yv[i] = to_f32(i == (int)threadIdx.x ? yraw : yt[row0 + i]);
    __syncthreads();
    // G = A^T A and c = A^T y over the chunk's rows: one output a thread
    // over the rows in order, four interleaved sums
    const bool last = row0 + rows >= n;
    for (int e = threadIdx.x; e < r * r + r; e += blockDim.x) {
      const int a = e < r * r ? e / r : e - r * r;
      const float* bv = e < r * r ? A + e % r : yv;
      const int bs = e < r * r ? RC : 1;
      float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
      if (row0 > 0) {
        v0 = gs[4 * e];
        v1 = gs[4 * e + 1];
        v2 = gs[4 * e + 2];
        v3 = gs[4 * e + 3];
      }
      int i = 0;
      for (; i + 3 < rows; i += 4) {
        v0 = fmaf(A[i * RC + a], bv[i * bs], v0);
        v1 = fmaf(A[(i + 1) * RC + a], bv[(i + 1) * bs], v1);
        v2 = fmaf(A[(i + 2) * RC + a], bv[(i + 2) * bs], v2);
        v3 = fmaf(A[(i + 3) * RC + a], bv[(i + 3) * bs], v3);
      }
      if (i < rows) v0 = fmaf(A[i * RC + a], bv[i * bs], v0);
      if (i + 1 < rows) v1 = fmaf(A[(i + 1) * RC + a], bv[(i + 1) * bs], v1);
      if (i + 2 < rows) v2 = fmaf(A[(i + 2) * RC + a], bv[(i + 2) * bs], v2);
      if (!last) {
        gs[4 * e] = v0;
        gs[4 * e + 1] = v1;
        gs[4 * e + 2] = v2;
        gs[4 * e + 3] = v3;
      } else {
        const float v = (v0 + v1) + (v2 + v3);
        if (e < r * r)
          Gout[task * r * r + e] = v;
        else
          Cout[task * r + a] = v;
      }
    }
    if (!last) __syncthreads();   // A's next chunk overwrites this one
  }
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
cudaError_t launch(Kernel kernel, int blocks, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// fused_resident_kernel on clusters of ctas CTAs, ctas a task.
template <typename T, int RC, bool kGradOnly>
cudaError_t launch_resident(int tasks, int ctas, size_t smem,
                            cudaStream_t stream, const T* x, const T* u,
                            const T* y, float* B, float* tiles, int tpn,
                            int n, int d, int r, int vec, int ushared) {
  const auto kernel = fused_resident_kernel<T, RC, kGradOnly>;
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
                                       n, d, r, vec, ctas, ushared);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The gradient form's layout: its CTAs a task (1 or 2; forced > 0) and
// whether U_g's rows are staged in shared memory.  Of the layouts that
// fit, the one whose launch takes the fewest waves of the card's SMs (as
// many CTAs an SM as the occupancy calculator fits, by registers and
// shared memory) for the least work a CTA, waves / ctas; on a tie one CTA
// before two, U_g staged before read through L1.  At path A's fold (600
// tasks) that is one CTA with U_g through L1 (five CTAs an SM: one wave),
// at a serving batch two CTAs with U_g staged.  The order of summation
// does not depend on the layout.  Returns ushared; ctas is set.
template <typename T, int RC>
int grad_layout(int n, int d, int tasks, int& ctas) {
  const auto kernel = fused_resident_kernel<T, RC, true>;
  int device = 0, sms = 0;
  const int forced = ctas;
  ctas = forced > 0 ? forced : 1;
  if ((forced == 0 && d <= grad_split(d)) ||
      cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kResidentSmemMax) != cudaSuccess)
    return 1;
  int ushared = 1;
  double best = 0.0;
  for (int c = 1; c <= kMaxCtas; ++c) {
    if (forced > 0 && c != forced) continue;
    for (int ush = 1; ush >= 0; --ush) {
      const size_t smem = resident_smem_bytes<T, RC, true>(n, d, c, ush);
      int per_sm = 0;
      if (smem > kResidentSmemMax ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, kernel, kThreads, smem) != cudaSuccess ||
          per_sm == 0)
        continue;
      const long long slots = (long long)per_sm * sms;
      const double cost =
          (double)(((long long)tasks * c + slots - 1) / slots) / c;
      if (best == 0.0 || cost < best) {
        best = cost;
        ctas = c;
        ushared = ush;
      }
    }
  }
  return ushared;
}

// The fused and the gradient kinds count the kernel they launched in
// launched[0] (resident) or launched[1] (two-pass): the choice is made
// here only.  ctas 0 picks the resident kernel's CTAs a task
// (resident_ctas, grad_layout); 1 or 2 forces it.  The Gram kind counts
// its launch in launched[0] where U_g's rows are staged in shared
// memory, launched[1] where they are read through L1.
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
  const int vec = ((size_t)d * sizeof(T)) % 16 == 0 &&
                  (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(U) & 15) == 0;
  if (kind == kFused) {
    if (ctas == 0) ctas = resident_ctas<T, RC>(n, d);
    const size_t smem_res = resident_smem_bytes<T, RC, false>(n, d, ctas);
    const bool resident = smem_res <= kResidentSmemMax;
    const cudaError_t err =
        resident ? launch_resident<T, RC, false>(tasks, ctas, smem_res,
                                                 stream, x, u, y, out1, out2,
                                                 tpn, n, d, r, vec, 1)
                 : launch(fused_iter_kernel<T, RC>, tasks, kThreads, smem,
                          stream, x, u, y, out1, out2, tpn, n, d, r);
    if (err == cudaSuccess) ++launched[resident ? 0 : 1];
    return err;
  }
  if (kind == kGrad) {
    const int ushared = grad_layout<T, RC>(n, d, tasks, ctas);
    const size_t smem_res =
        resident_smem_bytes<T, RC, true>(n, d, ctas, ushared);
    const bool resident = smem_res <= kResidentSmemMax;
    // B is only read by the gradient form
    float* b = const_cast<float*>(static_cast<const float*>(Bin));
    const cudaError_t err =
        resident ? launch_resident<T, RC, true>(tasks, ctas, smem_res, stream,
                                                x, u, y, b, out1, tpn, n, d,
                                                r, vec, ushared)
                 : launch(grad_tiles_kernel<T, RC>, tasks, kThreads, smem,
                          stream, x, u, static_cast<const float*>(Bin), y,
                          out1, tpn, n, d, r);
    if (err == cudaSuccess) ++launched[resident ? 0 : 1];
    return err;
  }
  // the Gram kind
  const int warps = gram_warps(n, tasks);
  const int rows = gram_chunk_rows(n, warps);
  const size_t rest = gram_rest_bytes<RC>(rows, warps);
  const size_t with_u = gram_us_bytes<T, RC>(d) + rest;
  const bool ushared = with_u <= kResidentSmemMax;
  const cudaError_t err =
      ushared ? launch(stream_gram_kernel<T, RC, true>, tasks, 32 * warps,
                       with_u, stream, x, u, y, out1, out2, tpn, n, d, r,
                       vec, rows)
              : launch(stream_gram_kernel<T, RC, false>, tasks, 32 * warps,
                       rest, stream, x, u, y, out1, out2, tpn, n, d, r, vec,
                       rows);
  if (err == cudaSuccess) ++launched[ushared ? 0 : 1];
  return err;
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

// The Gram entry adds 1 to launched[0] where stream_gram_kernel staged
// U_g's rows in shared memory, to launched[1] where it read them through
// L1 (d r past the budget).
int altgdmin_node_task_gram(const void* X, const void* U, const void* Y,
                            void* G, void* c, int L, int tpn, int n, int d,
                            int r, int dtype, int device, void* stream,
                            int* launched) {
  if (launched == nullptr) return (int)cudaErrorInvalidValue;
  return entry(kGram, X, U, nullptr, Y, G, c, L, tpn, n, d, r, dtype, device,
               stream, 0, launched);
}

// B is float32 whatever the dtype of X, U and y.  ctas and launched as
// for the fused entry: ctas 0 is grad_layout's pick; launched[0] counts
// the resident gradient form, launched[1] the two-pass grad_tiles_kernel
// (n d past the budget).
int altgdmin_node_grad_tiles(const void* X, const void* U, const void* B,
                             const void* Y, void* tiles, int L, int tpn,
                             int n, int d, int r, int dtype, int device,
                             void* stream, int ctas, int* launched) {
  if (ctas < 0 || ctas > kMaxCtas || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  return entry(kGrad, X, U, B, Y, tiles, nullptr, L, tpn, n, d, r, dtype,
               device, stream, ctas, launched);
}

const char* altgdmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
