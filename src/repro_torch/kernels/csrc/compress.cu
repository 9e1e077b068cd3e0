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
// compress_topk design: a one-pass rank select.  The grid is N x
// ceil(d / 32) blocks of 8 warps; each block computes all d row norms of
// its node into shared memory, each summed over r in column order with
// explicit round-to-nearest multiplies and adds (__fmul_rn / __fadd_rn,
// so the compiler cannot contract them into FMAs): the same operations,
// in the same order, as the plain version in ref.py.  A norm becomes a
// 32-bit key whose unsigned order is the plain version's sort order:
// descending by value, NaN above every number (+inf included), -0 equal
// to +0.  After one barrier the block ranks its 32 rows, one a lane: the
// rank of row i is the count of rows j whose key is larger, or equal
// with j < i, a strict total order, so the ranks of a node are a
// permutation of 0..d-1.  Each of the 8 warps counts over an eighth of
// the keys, and a second barrier sums the eight parts.  A row whose rank
// is below k writes its index and copies its r values (bit for bit) to
// that slot; a row is only ever indexed below d.  The selection is a
// pure function of the f32 norms, so it equals the plain version bit for
// bit for every input, NaN and inf rows included.  d is bounded by the
// keys' shared memory (D_MAX).
//
// Bound on the card.  At the dif_topk path's shape (N = 20, d = 600,
// r = 4, k = 150, f32) compress_topk must move 0.25 MB (M once, vals and
// idx once): under 0.1 us at 3.35 TB/s, so a launch is bound by launch
// latency, not by bytes; the d^2 key comparisons of a node (0.36 M at
// d = 600) are spread over its ceil(d / 32) blocks.  dequant at
// (20, 600, 4) moves 0.24 MB; launch latency bounds it too.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kParts = kThreads / 32;  // compress_topk: warps, one per part
// 32-bit keys in shared memory: 48,000 bytes, which with the block's 1 KB
// of partial ranks stays under the 48 KB a launch gets without an opt-in.
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

// The norm as a key whose unsigned order is the plain version's sort
// order: NaN (any payload) above +inf, -0 equal to +0, negative numbers
// below the positive ones.
__device__ __forceinline__ unsigned order_key(float x) {
  if (isnan(x)) return 0xffffffffu;
  if (x == 0.f) x = 0.f;
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Keys in [a, b) above `key`: >= if kGE (rows before the ranked one),
// > otherwise.  a is a multiple of 4 (16-byte shared-memory loads).
template <bool kGE>
__device__ __forceinline__ int count_above(const unsigned* keys, int a, int b,
                                           unsigned key) {
  int n = 0, j = a;
  for (; j + 4 <= b; j += 4) {
    const uint4 kj = *reinterpret_cast<const uint4*>(&keys[j]);
    n += kGE ? (kj.x >= key) + (kj.y >= key) + (kj.z >= key) + (kj.w >= key)
             : (kj.x > key) + (kj.y > key) + (kj.z > key) + (kj.w > key);
  }
  for (; j < b; ++j) n += kGE ? keys[j] >= key : keys[j] > key;
  return n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const T* __restrict__ M, T* __restrict__ vals,
            int* __restrict__ idx, int d, int r, int k) {
  extern __shared__ __align__(16) unsigned keys[];  // d
  __shared__ int part[kParts][32];
  const size_t node = blockIdx.x;
  const T* m = M + node * d * r;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < d; i += kThreads) {
    const T* row = m + (size_t)i * r;
    float x = to_f32(row[0]);
    float acc = __fmul_rn(x, x);
    for (int c = 1; c < r; ++c) {
      x = to_f32(row[c]);
      acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
    keys[i] = order_key(acc);
  }
  __syncthreads();

  // lane: row i of the block's 32; warp: its part of the keys, [j0, j1).
  // Rows before the block's first rank above on ties, rows past its last
  // below; the block's own 32 compare indices (bounds warp-uniform).
  const int w0 = blockIdx.y * 32, w1 = min(w0 + 32, d), i = w0 + lane;
  const unsigned key = i < d ? keys[i] : 0u;
  const int chunk = (d + 4 * kParts - 1) / (4 * kParts) * 4;
  const int j0 = min(warp * chunk, d), j1 = min(j0 + chunk, d);
  int rank = count_above<true>(keys, j0, min(j1, w0), key);
  for (int j = max(j0, w0); j < min(j1, w1); ++j)
    rank += keys[j] > key || (keys[j] == key && j < i);
  rank += count_above<false>(keys, max(j0, w1), j1, key);
  part[warp][lane] = rank;
  __syncthreads();
  if (warp != 0 || i >= d) return;
  rank = 0;
#pragma unroll
  for (int p = 0; p < kParts; ++p) rank += part[p][lane];
  if (rank >= k) return;
  idx[node * k + rank] = i;
  const T* src = m + (size_t)i * r;
  T* dst = vals + (node * k + rank) * r;
  for (int c = 0; c < r; ++c) dst[c] = src[c];
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
  const dim3 grid(N, (d + 31) / 32);
  topk_kernel<T><<<grid, kThreads, (size_t)d * sizeof(unsigned), stream>>>(
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
