// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces ssd_scan (_ssd_kernel) of src/repro/kernels/ssd_scan.py: the
// state-space-duality form of the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t
// for every (batch, head), chunk by chunk.  Inside a chunk of Q tokens,
// with cum the running sum of dt A over the chunk and seg its last value,
//   y = (C B^T o L o dt) x + exp(cum) (C h^T) + D x,  L_ij = exp(cum_i - cum_j)
//   for i >= j, else 0;
//   h <- exp(seg) h + sum_q exp(seg - cum_q) dt_q x_q B_q^T,
// all in float32; y is written in x's dtype and the final state as float32.
//
// Layout.  The kernel reads the model layout directly: x and y are
// (B, S, H, P), dt (B, S, H) float32, A and D (H,) float32, Bm and Cm
// (B, S, N) -- one group shared by every head -- and writes h_final
// (B, H, P, N).  x, Bm, Cm and y are float32 or bfloat16 (one dtype).
// Tokens past S in the last chunk are read as zeros, dt included: dt = 0
// means no decay and no input, so h_final is exact without a padded copy.
//
// Design.  One block of 512 threads owns one (head, batch) and walks the
// chunks in order, with the (P, N) state in shared memory.  A chunk's B
// and C (Q x N), x (Q x P), dt and cum are staged in shared memory as
// float32; the masked (Q x Q) product M = C B^T o L o dt is formed 16
// rows at a time into a 16 x Q buffer and multiplied into x at once, so
// the whole chunk never needs a Q x Q buffer: at mamba2-130m's Q = 128,
// N = 128, P = 64 the block holds 203 KB (dynamic shared memory; rows of
// B, C and h are padded to N + 1 floats against bank conflicts).
// exp(cum_i - cum_j) is computed only for i >= j: above the diagonal it
// overflows (cum falls along the chunk), and inf * 0 would be NaN.  The
// running sum over the chunk is one thread's loop, in token order.
// Products are float32 FMAs on the CUDA cores.  One block per (b, h) is
// B H = 96 blocks on 132 SMs at mamba2's prefill batch of 4: a redesign
// would split the heads' shared C B^T work or the chunks across blocks.
//
// Bound on the card: at mamba2-130m's prefill (B = 4, S = 2048, H = 24,
// P = 64, N = 128, bf16) the kernel must move 58 MB (0.017 ms at
// 3.35 TB/s); the recurrence needs 5 P N flops per token and head (3
// for the state update, 2 for the readout), 8.1 GFLOP (0.0081 ms at the
// bf16 tensor-core peak): it is bound by bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowTile = 16;   // rows of M formed at once

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

size_t smem_floats(int P, int N, int Q) {
  const size_t ldn = (size_t)N + 1;
  return (size_t)P * ldn + 2 * (size_t)Q * ldn + (size_t)Q * P +
         (size_t)kRowTile * Q + 3 * (size_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dv,
           T* __restrict__ y, float* __restrict__ h_out, int S, int H, int P,
           int N, int Q) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* hs = smem;               // P x ldn: the carried state
  float* Bs = hs + P * ldn;       // Q x ldn
  float* Cs = Bs + Q * ldn;       // Q x ldn
  float* xs = Cs + Q * ldn;       // Q x P
  float* Ms = xs + Q * P;         // kRowTile x Q
  float* cum = Ms + kRowTile * Q; // Q
  float* dts = cum + Q;           // Q
  float* wts = dts + Q;           // Q: exp(seg - cum_q) dt_q

  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const float a = A[h], dskip = Dv[h];
  for (int e = tid; e < P * N; e += kThreads) hs[(e / N) * ldn + e % N] = 0.f;

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();  // the last chunk is done with every buffer
    for (int e = tid; e < Q; e += kThreads) {
      const int s = s0 + e;
      dts[e] = s < S ? dt[((size_t)b * S + s) * H + h] : 0.f;
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int qq = e / P, p = e - qq * P, s = s0 + qq;
      xs[e] = s < S ? to_f32(x[(((size_t)b * S + s) * H + h) * P + p]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int qq = e / N, n = e - qq * N, s = s0 + qq;
      const size_t off = ((size_t)b * S + s) * N + n;
      Bs[qq * ldn + n] = s < S ? to_f32(Bm[off]) : 0.f;
      Cs[qq * ldn + n] = s < S ? to_f32(Cm[off]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int qq = 0; qq < Q; ++qq) {
        run += dts[qq] * a;
        cum[qq] = run;
      }
    }
    __syncthreads();
    const float seg = cum[Q - 1];
    for (int e = tid; e < Q; e += kThreads)
      wts[e] = expf(seg - cum[e]) * dts[e];

    // y, kRowTile rows at a time
    for (int i0 = 0; i0 < Q; i0 += kRowTile) {
      for (int e = tid; e < kRowTile * Q; e += kThreads) {
        const int ii = e / Q, j = e - ii * Q, i = i0 + ii;
        float mval = 0.f;
        if (i < Q && j <= i) {
          float sc = 0.f;
          for (int n = 0; n < N; ++n)
            sc = fmaf(Cs[i * ldn + n], Bs[j * ldn + n], sc);
          mval = sc * expf(cum[i] - cum[j]) * dts[j];
        }
        Ms[e] = mval;
      }
      __syncthreads();
      for (int e = tid; e < kRowTile * P; e += kThreads) {
        const int ii = e / P, p = e - ii * P, i = i0 + ii, s = s0 + i;
        if (i >= Q) continue;
        float acc = 0.f;
        for (int j = 0; j <= i; ++j)
          acc = fmaf(Ms[ii * Q + j], xs[j * P + p], acc);
        float inter = 0.f;
        for (int n = 0; n < N; ++n)
          inter = fmaf(Cs[i * ldn + n], hs[p * ldn + n], inter);
        acc += expf(cum[i]) * inter + dskip * xs[i * P + p];
        if (s < S) y[(((size_t)b * S + s) * H + h) * P + p] = from_f32<T>(acc);
      }
      __syncthreads();  // Ms is rewritten by the next row tile
    }

    // h <- exp(seg) h + sum_q wts_q x_q B_q^T
    const float eseg = expf(seg);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      float acc = 0.f;
      for (int qq = 0; qq < Q; ++qq)
        acc = fmaf(wts[qq] * xs[qq * P + p], Bs[qq * ldn + n], acc);
      hs[p * ldn + n] = eseg * hs[p * ldn + n] + acc;
    }
  }
  __syncthreads();
  float* hb = h_out + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) hb[e] = hs[(e / N) * ldn + e % N];
}

template <typename T>
cudaError_t run(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* Dv, void* y, void* h_out, int B,
                int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(P, N, Q) * sizeof(float);
  auto kernel = ssd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dv),
      static_cast<T*>(y), static_cast<float*>(h_out), S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (B, S, H, P); dt: (B, S, H) float32; A, D: (H,) float32; Bm, Cm:
// (B, S, N); h_out: (B, H, P, N) float32; all contiguous.  dtype of x,
// Bm, Cm and y: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch (0 = success).
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* Dv, void* y, void* h_out, int B,
                 int S, int H, int P, int N, int Q, int dtype, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(x, dt, A, Bm, Cm, Dv, y, h_out, B, S, H, P, N, Q,
                           s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, y, h_out, B, S, H, P,
                                   N, Q, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block takes (bytes).
long long ssd_scan_smem_bytes(int P, int N, int Q) {
  return (long long)(smem_floats(P, N, Q) * sizeof(float));
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
