// Wire-compression kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/compress.py:
//   * compress_topk <- compress_topk (_topk_kernel): per node block
//     M_g (d x r), the k rows of largest squared row norm, in descending
//     order of norm, ties to the lowest row index; emits the rows (in M's
//     dtype, copied bit for bit) and their int32 indices.
//   * dequant       <- dequant (_dequant_kernel): the int8 wire payload
//     decoded as float(q) * float(scale_g), one scale per node block,
//     written in the scale's dtype.
//
// Layouts (row-major, contiguous): M (N, d, r) float32 or bfloat16 ->
// vals (N, k, r) in M's dtype, idx (N, k) int32; q (N, d, r) int8 and
// scale (N) float32 or bfloat16 -> out (N, d, r) in the scale's dtype.
//
// compress_topk design.  One block per node.  The block computes the d
// row norms in f32 into shared memory, each summed over r in column
// order with explicit round-to-nearest multiplies and adds (__fmul_rn /
// __fadd_rn, so the compiler cannot contract them into FMAs): the same
// operations, in the same order, as the plain version in ref.py, so the
// selection agrees with it bit for bit.  Then k rounds of a block-wide
// argmax over (norm, index) pairs (a shuffle butterfly in each warp, then
// across the warps), a tie going to the lower index; the chosen norm is
// set to -inf and its index written.  This is the TPU kernel's iterative
// masked argmax made explicit.  The k rows are gathered after the last
// round: a round that copied its row would wait on a load from device
// memory.  d is bounded by the norms' shared memory (D_MAX).
//
// Bound on the card.  At the dif_topk path's shape (N = 20, d = 600,
// r = 4, k = 150, f32) compress_topk must move 0.25 MB (M once, vals and
// idx once): under 0.1 us at 3.35 TB/s, so a launch is bound by launch
// latency and by its k serial rounds, not by bytes.  dequant at
// (20, 600, 4) moves 0.24 MB; launch latency bounds it too.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// f32 norms in shared memory: 48,000 bytes, which with the block's few
// static bytes stays under the 48 KB a launch gets without an opt-in.
// Mirrored as D_MAX in compress.py.
constexpr int kDMax = 12000;

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
  return __float2bfloat16_rn(v);  // round to nearest even
}

// The warp's best (norm, row) pair in every lane: a larger norm wins,
// an equal one at a lower row.
__device__ __forceinline__ void warp_argmax(float& best, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > best || (ov == best && oi < bi)) {
      best = ov;
      bi = oi;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const T* __restrict__ M, T* __restrict__ vals,
            int* __restrict__ idx, int d, int r, int k) {
  extern __shared__ float norms[];  // d
  __shared__ float warp_best[kWarps];
  __shared__ int warp_idx[kWarps];
  const size_t node = blockIdx.x;
  const T* m = M + node * d * r;
  T* v_out = vals + node * k * r;
  int* i_out = idx + node * k;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < d; i += kThreads) {
    const T* row = m + (size_t)i * r;
    float x = to_f32(row[0]);
    float acc = __fmul_rn(x, x);
    for (int c = 1; c < r; ++c) {
      x = to_f32(row[c]);
      acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
    norms[i] = acc;
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    // each thread scans its rows in increasing order: a strict > keeps
    // the lowest index among its ties
    float best = -INFINITY;
    int bi = d;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = norms[i];
      if (v > best) {
        best = v;
        bi = i;
      }
    }
    warp_argmax(best, bi);
    if (lane == 0) {
      warp_best[warp] = best;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < kWarps ? warp_best[lane] : -INFINITY;
      bi = lane < kWarps ? warp_idx[lane] : d;
      warp_argmax(best, bi);
      if (lane == 0) {
        i_out[j] = bi;
        norms[bi] = -INFINITY;
      }
    }
    __syncthreads();
  }
  // the rows are gathered after the selection, so no round waits on a
  // load from device memory (the barrier made i_out visible)
  for (int e = threadIdx.x; e < k * r; e += kThreads)
    v_out[e] = m[(size_t)i_out[e / r] * r + e % r];
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const O* __restrict__ scale,
               O* __restrict__ out, long long per_node, long long total) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const float s = to_f32(scale[e / per_node]);
  out[e] = from_f32<O>(__fmul_rn((float)q[e], s));
}

template <typename T>
cudaError_t run_topk(const void* M, void* vals, void* idx, int N, int d,
                     int r, int k, cudaStream_t stream) {
  topk_kernel<T><<<N, kThreads, (size_t)d * sizeof(float), stream>>>(
      static_cast<const T*>(M), static_cast<T*>(vals),
      static_cast<int*>(idx), d, r, k);
  return cudaGetLastError();
}

template <typename O>
cudaError_t run_dequant(const void* q, const void* scale, void* out,
                        long long per_node, long long total,
                        cudaStream_t stream) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  dequant_kernel<O><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const O*>(scale),
      static_cast<O*>(out), per_node, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of M and vals: 0 = float32, 1 = bfloat16.  Needs 1 <= k <= d <=
// kDMax (the wrapper checks).  Returns cudaGetLastError()
// after the launch (0 = success).
int compress_topk(const void* M, void* vals, void* idx, int N, int d, int r,
                  int k, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > d || d > kDMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_topk<float>(M, vals, idx, N, d, r, k, s);
  if (dtype == 1)
    return (int)run_topk<__nv_bfloat16>(M, vals, idx, N, d, r, k, s);
  return (int)cudaErrorInvalidValue;
}

// dtype of scale and out: 0 = float32, 1 = bfloat16; q is int8 with
// per_node = d * r entries per node block.
int compress_dequant(const void* q, const void* scale, void* out,
                     long long per_node, long long total, int dtype,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_dequant<float>(q, scale, out, per_node, total, s);
  if (dtype == 1)
    return (int)run_dequant<__nv_bfloat16>(q, scale, out, per_node, total, s);
  return (int)cudaErrorInvalidValue;
}

const char* compress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
