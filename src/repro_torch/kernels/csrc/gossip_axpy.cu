// Consensus mixing kernel for Hopper (sm_90a).
//
// Replaces mix_rows (_mix_kernel) of src/repro/kernels/gossip_axpy.py:
// out[g, m] = sum_h W[g, h] * Z[h, m] over the node axis, with W the
// precomputed W^{T_con} (L x L, float32) and Z (L, M) in float32 or
// bfloat16.  Accumulation is f32; out is written in Z's dtype.
//
// Design.  The Pallas kernel keeps the whole (L, L) W resident in VMEM and
// streams Z in column tiles.  Here a block owns kCols columns of Z and
// kRows output rows; W is staged through shared memory in (kRows, kH)
// tiles, so any L works without a whole-W buffer, and each thread keeps
// kRows f32 sums for its column.  Z is read by neighbouring threads at
// neighbouring columns (coalesced); with L = 20 each Z element is read by
// ceil(L / kRows) = 3 blocks, the repeats from L2.
//
// Bound on the card: at Experiment 1 (L = 20, M = d*r = 2400, f32) the
// kernel must move 0.39 MB (0.000115 ms at 3.35 TB/s), so one launch is
// bound by launch latency: chip_smoke.py measured 0.0038-0.0040 ms per
// launch on an NVIDIA H100 80GB HBM3 at its 700 W limit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kCols = 128;  // threads per block, one column each
constexpr int kRows = 8;    // output rows per block
constexpr int kH = 32;      // h-tile of W staged in shared memory

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
      for (int hh = 0; hh < hn; ++hh) {
        const float z = to_f32(Z[(size_t)(h0 + hh) * M + m]);
#pragma unroll
        for (int gg = 0; gg < kRows; ++gg) acc[gg] += Ws[gg][hh] * z;
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

template <typename T>
cudaError_t run(const void* W, const void* Z, void* out, int L, int M,
                cudaStream_t stream) {
  const dim3 grid((M + kCols - 1) / kCols, (L + kRows - 1) / kRows);
  mix_rows_kernel<T><<<grid, kCols, 0, stream>>>(
      static_cast<const float*>(W), static_cast<const T*>(Z),
      static_cast<T*>(out), L, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of Z and out: 0 = float32, 1 = bfloat16; W is float32.
// Returns cudaGetLastError() after the launch (0 = success).
int gossip_mix_rows(const void* W, const void* Z, void* out, int L, int M,
                    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(W, Z, out, L, M, s);
  if (dtype == 1) return (int)run<__nv_bfloat16>(W, Z, out, L, M, s);
  return (int)cudaErrorInvalidValue;
}

const char* gossip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
