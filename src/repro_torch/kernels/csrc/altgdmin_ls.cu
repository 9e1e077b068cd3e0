// AltGDmin least-squares kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/altgdmin_ls.py:
//   * altgdmin_node_fused_iter  <- node_fused_iter (_fused_iter_kernel,
//     _chol_solve_unrolled): per task (g, t) build A = X_t U_g (n x r),
//     form G = A^T A and c = A^T y_t, solve G b = c by Cholesky, keep the
//     residual A b - y_t, then emit the gradient tile X_t^T resid b^T.
//   * altgdmin_node_task_gram   <- node_task_gram (_gram_kernel_nb): the
//     first half only, emitting (G, c); the r x r solve runs outside.
//
// Layouts (row-major, contiguous): X (L, tpn, n, d), U (L, d, r),
// y (L, tpn, n) in float32 or bfloat16 (converted to f32 in the load);
// outputs B (L, tpn, r), tiles (L, tpn, d, r), G (L, tpn, r, r),
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
// Bound on the card: bytes.  At Experiment 1 (L=20, tpn=30, n=30, d=600,
// r=4, f32) the fused kernel must move 49.2 MB (X once, the tiles once):
// 0.0147 ms at 3.35 TB/s, while its arithmetic would take a tenth of that
// at the f32 peak.  It reads X twice, the second time largely from L2.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at its 700 W
// limit: 0.066 ms per fused launch, 0.041 ms per Gram launch (bound
// 0.0130 ms).
// r is bounded by a template capacity of 4, 8 or 16 (R_MAX = 16) so the
// per-lane accumulators of A stay in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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
// 0 and adds in increasing index order before it is subtracted).
template <int RC>
__device__ void chol_solve(const float* G, const float* c, float* b, int r) {
  float Lc[RC][RC];
  float z[RC];
  for (int i = 0; i < r; ++i) {
    for (int j = 0; j <= i; ++j) {
      float acc = 0.f;
      for (int k = 0; k < j; ++k) acc += Lc[i][k] * Lc[j][k];
      const float sv = G[i * r + j] - acc;
      Lc[i][j] = (i == j) ? sqrtf(sv) : sv / Lc[j][j];
    }
  }
  for (int i = 0; i < r; ++i) {
    float acc = 0.f;
    for (int k = 0; k < i; ++k) acc += Lc[i][k] * z[k];
    z[i] = (c[i] - acc) / Lc[i][i];
  }
  for (int i = r - 1; i >= 0; --i) {
    float acc = 0.f;
    for (int k = i + 1; k < r; ++k) acc += Lc[k][i] * b[k];
    b[i] = (z[i] - acc) / Lc[i][i];
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
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < r; ++k) acc += s.A[i * RC + k] * s.b[k];
    s.resid[i] = acc - s.yv[i];
  }
  if (threadIdx.x < r) B[task * r + threadIdx.x] = s.b[threadIdx.x];
  __syncthreads();
  float* out = tiles + task * d * r;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += to_f32(x[(size_t)i * d + j]) * s.resid[i];
    for (int k = 0; k < r; ++k) out[(size_t)j * r + k] = acc * s.b[k];
  }
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
cudaError_t run(bool fused, const void* X, const void* U, const void* Y,
                void* o1, void* o2, int tasks, int tpn, int n, int d, int r,
                cudaStream_t stream) {
  const size_t smem = task_smem_bytes<RC>(n);
  if (fused) {
    auto kernel = fused_iter_kernel<T, RC>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<tasks, kThreads, smem, stream>>>(
        static_cast<const T*>(X), static_cast<const T*>(U),
        static_cast<const T*>(Y), static_cast<float*>(o1),
        static_cast<float*>(o2), tpn, n, d, r);
  } else {
    auto kernel = task_gram_kernel<T, RC>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<tasks, kThreads, smem, stream>>>(
        static_cast<const T*>(X), static_cast<const T*>(U),
        static_cast<const T*>(Y), static_cast<float*>(o1),
        static_cast<float*>(o2), tpn, n, d, r);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_r(bool fused, const void* X, const void* U, const void* Y,
                       void* o1, void* o2, int tasks, int tpn, int n, int d,
                       int r, cudaStream_t stream) {
  if (r <= 4) return run<T, 4>(fused, X, U, Y, o1, o2, tasks, tpn, n, d, r, stream);
  if (r <= 8) return run<T, 8>(fused, X, U, Y, o1, o2, tasks, tpn, n, d, r, stream);
  if (r <= 16) return run<T, 16>(fused, X, U, Y, o1, o2, tasks, tpn, n, d, r, stream);
  return cudaErrorInvalidValue;
}

int entry(bool fused, const void* X, const void* U, const void* Y, void* o1,
          void* o2, int L, int tpn, int n, int d, int r, int dtype, int device,
          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tasks = L * tpn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_r<float>(fused, X, U, Y, o1, o2, tasks, tpn, n, d, r, s);
  if (dtype == 1)
    return (int)dispatch_r<__nv_bfloat16>(fused, X, U, Y, o1, o2, tasks, tpn, n, d, r, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (X, U and y share it).
// Returns cudaGetLastError() after the launch (0 = success).
int altgdmin_node_fused_iter(const void* X, const void* U, const void* Y,
                             void* B, void* tiles, int L, int tpn, int n,
                             int d, int r, int dtype, int device,
                             void* stream) {
  return entry(true, X, U, Y, B, tiles, L, tpn, n, d, r, dtype, device, stream);
}

int altgdmin_node_task_gram(const void* X, const void* U, const void* Y,
                            void* G, void* c, int L, int tpn, int n, int d,
                            int r, int dtype, int device, void* stream) {
  return entry(false, X, U, Y, G, c, L, tpn, n, d, r, dtype, device, stream);
}

const char* altgdmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
