// Wire-compression kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/compress.py:
//   * compress_topk <- compress_topk (_topk_kernel): per node block
//     M_g (d x r), the k rows of largest squared row norm, in descending
//     order of norm, ties to the lowest row index; emits the rows (in M's
//     dtype, copied bit for bit) and their int32 indices.
//   * dequant       <- dequant (_dequant_kernel): the int8 wire payload
//     decoded as float(q) * float(scale_g), one scale per node block,
//     written in the scale's dtype.  Two kernels carry it:
//     int8_round_kernel, the whole round of the int8 wires (encode,
//     decode and the accumulate onto the public copy) in one launch,
//     which the simulator's rounds run; and dequant_kernel, the decode
//     alone, as a receiver applies a payload it was sent.
//
// Layouts (row-major, contiguous): M (N, d, r) float32 or bfloat16 ->
// vals (N, k, r) in M's dtype, idx (N, k) int32; q (N, d, r) int8 and
// scale (N) float32 or bfloat16 -> out (N, d, r) in the scale's dtype;
// Z, xhat and the dither u (N, d, r) in one dtype, float32 or bfloat16
// -> q (N, d, r) int8, scale (N) and xhat' (N, d, r) in that dtype.
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
// int8_round design.  The plain round (ref_int8_round in ref.py) is a
// chain of about ten elementwise and reduction launches, each a trip
// through device memory, for work whose bytes take a fraction of a
// microsecond; here a node block is owned by one CTA, or by a cluster of
// up to 8 where d r is past what one CTA holds (4096 values: 16 a
// thread).  Each thread reads its Z and xhat values once, 16 bytes at a
// time where the block is aligned (element by element otherwise), and
// keeps delta = Z - xhat (and xhat, and the dither) in registers.  The
// max |delta| is reduced as the unsigned max of the bit patterns of
// |delta|, which orders every number and puts NaN above +inf, so a NaN
// (or an inf) in the block reaches the scale as torch.amax carries it
// (fmaxf would drop a NaN); warps by __reduce_max_sync, the CTA through
// shared memory, a cluster through distributed shared memory.  Every CTA
// then forms the scale and writes its q and xhat' in one pass; a CTA
// whose share is past its registers reads its Z, xhat and dither a
// second time, from L2.  The arithmetic is the plain version's,
// operation for operation, so the outputs are equal bit for bit: IEEE
// division (no reciprocal, no fast math), rintf (half to even) or floorf
// of delta / scale (+ u), a NaN quotient stored as 0 (as the card's
// float-to-int8 conversion does), and xhat + q s as a round-to-nearest
// multiply, then add (__fmul_rn / __fadd_rn, never an FMA); in bfloat16
// every intermediate torch rounds (delta, the scale, delta / scale,
// delta / scale + u, q s, the sum) is rounded to bfloat16 here too.
//
// dequant_kernel: a grid over (node, chunk of 1024 values); a block
// reads its node's scale once, a thread four int8 values in one 4-byte
// load where the block is aligned.
//
// Bound on the card.  At the dif_topk path's shape (N = 20, d = 600,
// r = 4, k = 150, f32) compress_topk must move 0.25 MB (M once, vals and
// idx once): under 0.1 us at 3.35 TB/s, so a launch is bound by launch
// latency, not by bytes; the d^2 key comparisons of a node (0.36 M at
// d = 600) are spread over its ceil(d / 32) blocks.  The int8 round at
// (20, 600, 4) moves 0.62 MB (Z and xhat read, q and xhat' written),
// 0.19 us; dequant 0.24 MB.  Launch latency bounds both.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

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

// float(q) * float(scale) of four int8 values a thread, a block of
// kThreads threads on 4 * kThreads values of one node (blockIdx.x), the
// node's scale read once a block; kVec: one 4-byte load of q and one
// 16- (f32) or 8-byte (bf16) store a thread (per_node a multiple of 4).
constexpr int kDequantPer = 4 * kThreads;  // values a block

template <typename O, bool kVec>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const O* __restrict__ scale,
               O* __restrict__ out, int per_node) {
  __shared__ float s_node;
  const size_t node = blockIdx.x;
  const int e0 = blockIdx.y * kDequantPer + 4 * threadIdx.x;
  const int8_t* qn = q + node * per_node;
  O* on = out + node * per_node;
  // the thread's q values, in flight while thread 0 reads the scale
  int v[4] = {0, 0, 0, 0};
  if (kVec) {
    if (e0 < per_node) {
      const char4 c = *reinterpret_cast<const char4*>(qn + e0);
      v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e0 + i < per_node) v[i] = qn[e0 + i];
  }
  if (threadIdx.x == 0) s_node = to_f32(scale[node]);
  __syncthreads();
  const float s = s_node;
  float o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __fmul_rn((float)v[i], s);
  if (kVec) {
    if (e0 >= per_node) return;
    if constexpr (sizeof(O) == 4) {
      *reinterpret_cast<float4*>(on + e0) =
          make_float4(o[0], o[1], o[2], o[3]);
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
      uint2 w;
      w.x = *reinterpret_cast<unsigned*>(&lo);
      w.y = *reinterpret_cast<unsigned*>(&hi);
      *reinterpret_cast<uint2*>(on + e0) = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e0 + i < per_node) on[e0 + i] = from_f32<O>(o[i]);
  }
}

// ---------------------------------------------------------------- int8

constexpr int kRoundHold = 16;       // values a thread keeps in registers
constexpr int kRoundMaxCtas = 8;     // a portable cluster

// x rounded to T's precision, as a float
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// V values of T from p (16 bytes where V > 1, element by element at
// V = 1) as floats
template <typename T, int V>
__device__ __forceinline__ void load_vals(const T* __restrict__ p,
                                          float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(ws[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(ws[i] << 16);
        v[2 * i + 1] = __uint_as_float(ws[i] & 0xffff0000u);
      }
    }
  }
}

// V floats (each already a value of T) stored to p as T, and V int8
template <typename T, int V>
__device__ __forceinline__ void store_vals(T* __restrict__ p,
                                           const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    unsigned ws[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      ws[i] = *reinterpret_cast<unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(ws[0], ws[1], ws[2], ws[3]);
  }
}
template <int V>
__device__ __forceinline__ void store_q(int8_t* __restrict__ p,
                                        const int (&q)[V]) {
  if constexpr (V == 1) {
    p[0] = (int8_t)q[0];
  } else {
    unsigned w[V / 4];
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      w[i] = (q[4 * i] & 0xff) | (q[4 * i + 1] & 0xff) << 8 |
             (q[4 * i + 2] & 0xff) << 16 | (unsigned)(q[4 * i + 3] & 0xff)
                                                << 24;
    if constexpr (V == 4)
      *reinterpret_cast<unsigned*>(p) = w[0];
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// One value of the round: q of delta / scale (+ u), and xhat + q s
template <typename T, bool kStoch>
__device__ __forceinline__ void round_value(float delta, float xh, float u,
                                            float s, int& q, float& xn) {
  float t = rnd<T>(__fdiv_rn(delta, s));
  t = kStoch ? floorf(rnd<T>(__fadd_rn(t, u))) : rintf(t);
  q = isnan(t) ? 0 : (int)fminf(fmaxf(t, -127.f), 127.f);
  xn = rnd<T>(__fadd_rn(xh, rnd<T>(__fmul_rn((float)q, s))));
}

// A cluster of ctas CTAs a node (blockIdx.x / ctas); CTA k owns vectors
// [k span, (k + 1) span) of the node's per_node / V vectors of V values.
// Thread t holds vectors t, t + kThreads, .. up to kRoundHold / V of
// them; past that (a share past what the CTA holds) it reads them again
// after the scale is known.
template <typename T, int V, bool kStoch>
__global__ void __launch_bounds__(kThreads)
int8_round_kernel(const T* __restrict__ Z, const T* __restrict__ X,
                  const T* __restrict__ U, int8_t* __restrict__ Q,
                  T* __restrict__ S, T* __restrict__ XN, int per_node,
                  int span, int ctas) {
  namespace cg = cooperative_groups;
  constexpr int H = kRoundHold / V;   // vectors held a thread
  __shared__ unsigned warp_max[kThreads / 32];
  __shared__ unsigned cta_max;
  const size_t node = blockIdx.x / ctas;
  const int rank = blockIdx.x % ctas;
  const int nvec = per_node / V;
  const int v0 = rank * span, v1 = min(nvec, v0 + span);
  const size_t base = node * (size_t)per_node;
  const T* z = Z + base;
  const T* x = X + base;
  const T* u = kStoch ? U + base : nullptr;

  // delta = Z - xhat, rounded to T; the max of |delta|'s bits
  float dl[H][V], xh[H][V], uv[H][V];
  unsigned m = 0u;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int vi = v0 + h * kThreads + threadIdx.x;
    if (vi < v1) {
      float zv[V];
      load_vals<T, V>(z + (size_t)vi * V, zv);
      load_vals<T, V>(x + (size_t)vi * V, xh[h]);
      if constexpr (kStoch) load_vals<T, V>(u + (size_t)vi * V, uv[h]);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        dl[h][i] = rnd<T>(__fsub_rn(zv[i], xh[h][i]));
        m = max(m, __float_as_uint(fabsf(dl[h][i])));
      }
    }
  }
  for (int vi = v0 + H * kThreads + threadIdx.x; vi < v1; vi += kThreads) {
    float zv[V], xv[V];
    load_vals<T, V>(z + (size_t)vi * V, zv);
    load_vals<T, V>(x + (size_t)vi * V, xv);
#pragma unroll
    for (int i = 0; i < V; ++i)
      m = max(m, __float_as_uint(fabsf(rnd<T>(__fsub_rn(zv[i], xv[i])))));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned c = 0u;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) c = max(c, warp_max[w]);
    cta_max = c;
  }
  if (ctas > 1) {
    const cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                 // every CTA's max is in
    if (threadIdx.x == 0) {
      unsigned c = 0u;
      for (int k = 0; k < ctas; ++k)
        c = max(c, *cluster.map_shared_rank(&cta_max, k));
      warp_max[0] = c;
    }
  } else if (threadIdx.x == 0) {
    warp_max[0] = cta_max;
  }
  __syncthreads();

  // scale = max(amax / 127, tiny), NaN carried through
  float s = rnd<T>(__fdiv_rn(__uint_as_float(warp_max[0]), 127.f));
  if (!isnan(s)) s = fmaxf(s, 1.17549435e-38f);   // FLT_MIN, bf16's tiny too
  if (rank == 0 && threadIdx.x == 0) S[node] = from_f32<T>(s);

#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int vi = v0 + h * kThreads + threadIdx.x;
    if (vi < v1) {
      int q[V];
      float xn[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        round_value<T, kStoch>(dl[h][i], xh[h][i], kStoch ? uv[h][i] : 0.f,
                               s, q[i], xn[i]);
      store_q<V>(Q + base + (size_t)vi * V, q);
      store_vals<T, V>(XN + base + (size_t)vi * V, xn);
    }
  }
  for (int vi = v0 + H * kThreads + threadIdx.x; vi < v1; vi += kThreads) {
    float zv[V], xv[V], w[V];
    load_vals<T, V>(z + (size_t)vi * V, zv);
    load_vals<T, V>(x + (size_t)vi * V, xv);
    if constexpr (kStoch) load_vals<T, V>(u + (size_t)vi * V, w);
    int q[V];
    float xn[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      round_value<T, kStoch>(rnd<T>(__fsub_rn(zv[i], xv[i])), xv[i],
                             kStoch ? w[i] : 0.f, s, q[i], xn[i]);
    store_q<V>(Q + base + (size_t)vi * V, q);
    store_vals<T, V>(XN + base + (size_t)vi * V, xn);
  }
  // no CTA leaves while a peer may read its max
  if (ctas > 1) cg::this_cluster().sync();
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
cudaError_t run_dequant(const void* q, const void* scale, void* out, int N,
                        int per_node, cudaStream_t stream) {
  const dim3 grid(N, (per_node + kDequantPer - 1) / kDequantPer);
  const bool vec = per_node % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (vec)
    dequant_kernel<O, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const O*>(scale),
        static_cast<O*>(out), per_node);
  else
    dequant_kernel<O, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const O*>(scale),
        static_cast<O*>(out), per_node);
  return cudaGetLastError();
}

// CTAs a node of int8_round_kernel: one, or as many (up to a portable
// cluster of kRoundMaxCtas) as hold the node's values in registers
inline int round_ctas(int per_node) {
  const int hold = kRoundHold * kThreads;
  const int c = (per_node + hold - 1) / hold;
  return c < 1 ? 1 : c > kRoundMaxCtas ? kRoundMaxCtas : c;
}

template <typename T, int V, bool kStoch>
cudaError_t launch_round(const void* Z, const void* X, const void* U,
                         void* Q, void* S, void* XN, int N, int per_node,
                         cudaStream_t stream) {
  const int ctas = round_ctas(per_node);
  const int nvec = per_node / V;
  const int span = (nvec + ctas - 1) / ctas;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, int8_round_kernel<T, V, kStoch>, static_cast<const T*>(Z),
      static_cast<const T*>(X), static_cast<const T*>(U),
      static_cast<int8_t*>(Q), static_cast<T*>(S), static_cast<T*>(XN),
      per_node, span, ctas);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// 16-byte vectors where every node block and every pointer allows them
template <typename T>
cudaError_t run_round(const void* Z, const void* X, const void* U, void* Q,
                      void* S, void* XN, int N, int per_node,
                      cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const auto a16 = [](const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec = per_node % V == 0 && a16(Z) && a16(X) && a16(U) &&
                   a16(XN) && (reinterpret_cast<uintptr_t>(Q) & 7) == 0;
  if (U != nullptr)
    return vec ? launch_round<T, V, true>(Z, X, U, Q, S, XN, N, per_node,
                                          stream)
               : launch_round<T, 1, true>(Z, X, U, Q, S, XN, N, per_node,
                                          stream);
  return vec ? launch_round<T, V, false>(Z, X, U, Q, S, XN, N, per_node,
                                         stream)
             : launch_round<T, 1, false>(Z, X, U, Q, S, XN, N, per_node,
                                         stream);
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
// per_node = d * r entries per node block (the wrapper checks that N
// and per_node fit the grid).
int compress_dequant(const void* q, const void* scale, void* out, int N,
                     int per_node, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_dequant<float>(q, scale, out, N, per_node, s);
  if (dtype == 1)
    return (int)run_dequant<__nv_bfloat16>(q, scale, out, N, per_node, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 wire's round: Z, xhat (and u, the stochastic wire's dither,
// or null for round half to even) in dtype 0 = float32 or 1 = bfloat16
// -> q int8, scale (N) and xhat_new in that dtype; per_node = d * r.
int compress_int8_round(const void* Z, const void* xhat, const void* u,
                        void* q, void* scale, void* xhat_new, int N,
                        int per_node, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_round<float>(Z, xhat, u, q, scale, xhat_new, N,
                                 per_node, s);
  if (dtype == 1)
    return (int)run_round<__nv_bfloat16>(Z, xhat, u, q, scale, xhat_new, N,
                                         per_node, s);
  return (int)cudaErrorInvalidValue;
}

const char* compress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
